"""Synthetic hard-negative corpus generator for scale evaluation.

Round-1 verdict: "recall@10 = 1.0 on a 16-chunk corpus is a near-vacuous
gate". This module makes the recall gate mean something by surrounding the 16
real ICICI FY2024 chunks with up to millions of distractors that share the
financial vocabulary — same chunk templates (the four analysis formats of
``chunking_storing (1).py:91-330``), same metric names, same ₹-crore number
shapes, same ``Q#_FY####`` period tokens — but for other banks (the
reference's own PDF-extractor bank set, ``multi_bank_extractor.py``) and
other fiscal years, including ICICI itself in non-FY2024 years (the hardest
negatives: every token but the year matches).

Generation is fully deterministic (seeded) so eval numbers are reproducible.
"""

from __future__ import annotations

import numpy as np

from ..data.models import IndexedChunk

# Reference bank universe (FinRag_Parameter_Extractor/multi_bank_extractor.py
# handles Axis/Kotak/DBS/HDFC/SBI filings) + ICICI itself for same-company
# other-year hard negatives.
BANKS = [
    "HDFC Bank",
    "State Bank of India",
    "Axis Bank",
    "Kotak Mahindra Bank",
    "DBS Bank India",
    "IndusInd Bank",
    "Yes Bank",
    "ICICI Bank",  # other fiscal years only — see generate()
]

_SEGMENTS = ["RETAIL BANKING", "TREASURY", "WHOLESALE BANKING", "LIFE INSURANCE", "OTHERS"]


def _profitability(bank, period, r) -> str:
    np_ = r.uniform(800, 30000)
    op = np_ * r.uniform(1.2, 1.8)
    inc = np_ * r.uniform(3.5, 6.5)
    ii = inc * r.uniform(0.6, 0.8)
    exp = inc - op
    return (
        f"{bank} Limited {period} NET PROFIT PROFITABILITY ANALYSIS:\n\n"
        f"NET PROFIT: ₹{np_:,.0f} crore ({r.uniform(-20, 50):+.1f}% YoY growth)\n"
        f"Operating Profit: ₹{op:,.0f} crore\n"
        f"Net Margin: {np_ / inc * 100:.1f}% | Operating Margin: {op / inc * 100:.1f}%\n\n"
        f"INCOME: Total ₹{inc:,.0f} crore ({r.uniform(-10, 40):+.1f}% YoY)\n"
        f"Interest Income: ₹{ii:,.0f} crore ({ii / inc * 100:.1f}%)\n"
        f"Other Income: ₹{inc - ii:,.0f} crore ({(inc - ii) / inc * 100:.1f}%)\n\n"
        f"EXPENSES: Total ₹{exp:,.0f} crore\n"
        f"Interest: ₹{exp * 0.45:,.0f} crore | Operating: ₹{exp * 0.55:,.0f} crore\n"
        f"Provisions: ₹{r.uniform(200, 4000):,.0f} crore | Cost Ratio: {exp / inc * 100:.1f}%"
    )


def _balance_sheet(bank, period, r) -> str:
    total = r.uniform(200_000, 3_000_000)
    adv = total * r.uniform(0.45, 0.62)
    inv = total * r.uniform(0.25, 0.38)
    dep = total * r.uniform(0.55, 0.72)
    eq = total * r.uniform(0.08, 0.14)
    return (
        f"{bank} Limited {period} Balance Sheet Analysis:\n\n"
        f"ASSET COMPOSITION (Total: ₹{total:,.0f} crore):\n"
        f"• Advances: ₹{adv:,.0f} crore ({adv / total * 100:.1f}% of total assets)\n"
        f"• Investments: ₹{inv:,.0f} crore ({inv / total * 100:.1f}% of total assets)\n"
        f"• Cash & RBI Balances: ₹{total * 0.03:,.0f} crore\n\n"
        f"FUNDING STRUCTURE:\n"
        f"• Customer Deposits: ₹{dep:,.0f} crore\n"
        f"• Borrowings: ₹{total * 0.09:,.0f} crore\n"
        f"• Deposit-to-Funding Ratio: {r.uniform(80, 92):.1f}%\n\n"
        f"CAPITAL POSITION:\n"
        f"• Share Capital: ₹{r.uniform(500, 2500):,.0f} crore\n"
        f"• Reserves & Surplus: ₹{eq * 0.98:,.0f} crore\n"
        f"• Total Equity: ₹{eq:,.0f} crore"
    )


def _ratios(bank, period, r) -> str:
    eps = r.uniform(4, 60)
    return (
        f"{bank} Limited {period} Key Financial Ratios & Metrics:\n\n"
        f"EARNINGS METRICS:\n"
        f"• Basic EPS: ₹{eps:.2f} per share ({r.uniform(-15, 45):+.1f}% YoY)\n"
        f"• Diluted EPS: ₹{eps * 0.98:.2f} per share\n\n"
    )


def _segments(bank, period, r) -> str:
    revs = r.uniform(2000, 40000, len(_SEGMENTS))
    total = revs.sum()
    blocks = []
    for name, rev in zip(_SEGMENTS, revs):
        res = rev * r.uniform(0.02, 0.45)
        blocks.append(
            f"{name} SEGMENT:\n"
            f"• Revenue: ₹{rev:,.0f} crore ({rev / total * 100:.1f}%)\n"
            f"• Segment Result: ₹{res:,.0f} crore\n"
            f"• Margin: {res / rev * 100:.1f}%"
        )
    return (
        f"{bank} Limited {period} Retail Banking & Business Segment Performance:\n\n"
        + "\n\n".join(blocks)
        + f"\n\nTOTAL SEGMENT REVENUE: ₹{total:,.0f} crore"
    )


_TEMPLATES = [
    ("profitability_analysis", _profitability, "consolidated"),
    ("balance_sheet_analysis", _balance_sheet, "consolidated"),
    ("financial_ratios", _ratios, "consolidated"),
    ("segment_analysis", _segments, "consolidated"),
]


def generate_distractors(n: int, seed: int = 0, exclude_period_year: int = 2024) -> list[IndexedChunk]:
    """``n`` deterministic hard-negative chunks.

    ICICI distractors never use ``exclude_period_year`` (those would be real
    answers); other banks may use any year including it — a same-period
    other-bank chunk is a classic confusable.
    """
    r = np.random.default_rng(seed)
    out: list[IndexedChunk] = []
    for i in range(n):
        bank = BANKS[int(r.integers(0, len(BANKS)))]
        q = int(r.integers(1, 5))
        year = int(r.integers(2018, 2032))
        if bank == "ICICI Bank" and year >= exclude_period_year:
            # Same-company hard negatives use PAST years only: future-year
            # chunks would legitimately change the answer to "latest FY"
            # questions, making the FY2024 ground-truth labels wrong rather
            # than the retrieval.
            year = 2018 + (year - 2018) % (exclude_period_year - 2018)
        period = f"Q{q}_FY{year}"
        ctype, fn, stype = _TEMPLATES[int(r.integers(0, len(_TEMPLATES)))]
        text = fn(bank, period, r)
        out.append(
            IndexedChunk(
                id=f"distractor_{i:07d}_{bank.split()[0].lower()}_{period.lower()}_{ctype}",
                text=text,
                period=period,
                chunk_type=ctype,
                statement_type=stype,
                primary_value=float(r.uniform(100, 50000)),
                company=bank,
            )
        )
    return out
