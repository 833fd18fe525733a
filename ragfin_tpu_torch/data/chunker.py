"""Quarterly-report → analysis-chunk generator.

Behavioral parity with the reference chunker ``chunking_storing (1).py:31-332``
(``create_complete_context_chunks``): per quarter it derives exactly four
analysis chunks — profitability, balance sheet, key ratios, segment
performance — with identical ids and byte-identical text (golden oracle:
``FinRag_knowledge_graph/chunks.json``), computing YoY growth, margins, cost
ratio, and segment shares from the raw statement JSON.

Pure host-side code (no JAX): text generation is not device work. The period
key mapping is generalized from the reference's hardcoded FY2023/FY2024 table
to any fiscal year.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping, Optional

from .models import IndexedChunk

Json = Mapping[str, Any]

# Quarter → month of the period-end key in the statement JSON. Indian fiscal
# year: Q1=June..Q3=December fall in calendar year FY-1, Q4=March falls in FY.
_QUARTER_MONTH = {"Q1": "june", "Q2": "september", "Q3": "december", "Q4": "march"}

# Display names for the business segments, in the reference's canonical order
# (chunking_storing (1).py:280-286).
_SEGMENTS = {
    "retailBanking": "Retail Banking",
    "wholesaleBanking": "Wholesale Banking",
    "treasury": "Treasury",
    "lifeInsurance": "Life Insurance",
    "others": "Others",
}


def period_keys(period: str) -> tuple[Optional[str], Optional[str]]:
    """Map a period like ``Q1_FY2024`` to (current, previous-year) JSON keys.

    Generalizes the reference's lookup table (chunking_storing (1).py:77-89):
    e.g. Q1_FY2024 → ("june2023", "june2022"); Q4_FY2024 → ("march2024",
    "march2023").
    """
    quarter = period[:2]
    month = _QUARTER_MONTH.get(quarter)
    fy = _fiscal_year(period)
    if month is None or fy is None:
        return None, None
    cal_year = fy if quarter == "Q4" else fy - 1
    return f"{month}{cal_year}", f"{month}{cal_year - 1}"


def _fiscal_year(period: str) -> Optional[int]:
    marker = period.rfind("FY")
    if marker == -1:
        return None
    digits = period[marker + 2 : marker + 6]
    return int(digits) if digits.isdigit() else None


def classify_quarterly_files(quarterly_data: Iterable[Json]) -> dict[str, Optional[Json]]:
    """Sort a quarter's raw JSON files into statement roles.

    Mirrors the detection cascade at chunking_storing (1).py:51-64 but keys on
    content deterministically (the reference depends on glob order for the
    ``segmentalResults`` fallback; content-keying gives the same result on the
    reference corpus and is order-independent).
    """
    roles: dict[str, Optional[Json]] = {"fin": None, "segmental": None, "balance": None}
    fallback_segmental = None
    for data in quarterly_data:
        report_type = data.get("reportType")
        if report_type == "CONSOLIDATED FINANCIAL RESULTS":
            roles["fin"] = data
        elif report_type == "CONSOLIDATED SEGMENTAL RESULTS" or "consolidatedSegmentalResults" in data:
            roles["segmental"] = data
        elif "consolidatedBalanceSheet" in data:
            roles["balance"] = data
        elif "segmentalResults" in data:
            fallback_segmental = data
    if roles["segmental"] is None:
        roles["segmental"] = fallback_segmental
    return roles


def _get(series: Optional[Json], key: Optional[str], default: float = 0) -> float:
    if not series or not key:
        return default
    v = series.get(key, default)
    # An explicit JSON null must behave like a missing key — returning None
    # would crash every numeric format downstream.
    return default if v is None else v


def _pct(part: float, whole: float) -> float:
    return part / whole * 100 if whole else 0


def _growth(now: float, then: float) -> float:
    return (now - then) / then * 100 if then else 0


def profitability_chunk(fin: Json, period: str, company: str) -> Optional[IndexedChunk]:
    """Income-statement analysis chunk (reference :91-152)."""
    results = fin.get("consolidatedResults")
    if not results:
        return None
    cur, prev = period_keys(period)
    if not (cur and "income" in results and "expenses" in results and "profitAndLoss" in results):
        return None
    income, expenses, pnl = results["income"], results["expenses"], results["profitAndLoss"]

    total_income = _get(income.get("totalIncome"), cur)
    interest_income = _get(income.get("interestEarned"), cur)
    other_income = _get(income.get("otherIncome"), cur)
    total_expenses = _get(expenses.get("totalExpenditure"), cur)
    interest_expenses = _get(expenses.get("interestExpended"), cur)
    operating_expenses = _get(expenses.get("operatingExpenses"), cur)
    operating_profit = _get(pnl.get("operatingProfit"), cur)
    net_profit = _get(pnl.get("netProfitForThePeriod"), cur)
    provisions = _get(pnl.get("provisions"), cur)
    prev_total_income = _get(income.get("totalIncome"), prev)
    prev_net_profit = _get(pnl.get("netProfitForThePeriod"), prev)

    lines = [f"{company} {period} NET PROFIT PROFITABILITY ANALYSIS:\n"]
    profit_line = f"NET PROFIT: ₹{net_profit:,.0f} crore"
    if prev_net_profit:
        profit_line += f" ({_growth(net_profit, prev_net_profit):+.1f}% YoY growth)"
    lines.append(profit_line)
    lines.append(f"Operating Profit: ₹{operating_profit:,.0f} crore")
    lines.append(
        f"Net Margin: {_pct(net_profit, total_income):.1f}% | "
        f"Operating Margin: {_pct(operating_profit, total_income):.1f}%\n"
    )
    income_line = f"INCOME: Total ₹{total_income:,.0f} crore"
    if prev_total_income:
        income_line += f" ({_growth(total_income, prev_total_income):+.1f}% YoY)"
    lines.append(income_line)
    lines.append(f"Interest Income: ₹{interest_income:,.0f} crore ({_pct(interest_income, total_income):.1f}%)")
    lines.append(f"Other Income: ₹{other_income:,.0f} crore ({_pct(other_income, total_income):.1f}%)\n")
    lines.append(f"EXPENSES: Total ₹{total_expenses:,.0f} crore")
    lines.append(f"Interest: ₹{interest_expenses:,.0f} crore | Operating: ₹{operating_expenses:,.0f} crore")
    lines.append(f"Provisions: ₹{provisions:,.0f} crore | Cost Ratio: {_pct(total_expenses, total_income):.1f}%")

    return IndexedChunk(
        id=f"icici_{period.lower()}_profitability_analysis",
        text="\n".join(lines),
        period=period,
        chunk_type="profitability_analysis",
        primary_value=net_profit,
    )


def balance_sheet_chunk(balance: Json, period: str, company: str) -> Optional[IndexedChunk]:
    """Balance-sheet analysis chunk (reference :154-202)."""
    bs = balance.get("consolidatedBalanceSheet")
    if not bs or "assets" not in bs or "capitalAndLiabilities" not in bs:
        return None
    cur, _ = period_keys(period)
    assets, liabilities = bs["assets"], bs["capitalAndLiabilities"]

    total_assets = _get(assets.get("totalAssets"), cur)
    advances = _get(assets.get("advances"), cur)
    investments = _get(assets.get("investments"), cur)
    cash_rbi = _get(assets.get("cashAndBalancesWithRBI"), cur)
    deposits = _get(liabilities.get("deposits"), cur)
    borrowings = _get(liabilities.get("borrowings"), cur)
    capital = _get(liabilities.get("capital"), cur)
    reserves = _get(liabilities.get("reservesAndSurplus"), cur)

    deposit_funding = _pct(deposits, deposits + borrowings)

    text = (
        f"{company} {period} Balance Sheet Analysis:\n\n"
        f"ASSET COMPOSITION (Total: ₹{total_assets:,.0f} crore):\n"
        f"• Advances: ₹{advances:,.0f} crore ({_pct(advances, total_assets):.1f}% of total assets)\n"
        f"• Investments: ₹{investments:,.0f} crore ({_pct(investments, total_assets):.1f}% of total assets)\n"
        f"• Cash & RBI Balances: ₹{cash_rbi:,.0f} crore\n\n"
        f"FUNDING STRUCTURE:\n"
        f"• Customer Deposits: ₹{deposits:,.0f} crore\n"
        f"• Borrowings: ₹{borrowings:,.0f} crore\n"
        f"• Deposit-to-Funding Ratio: {deposit_funding:.1f}%\n\n"
        f"CAPITAL POSITION:\n"
        f"• Share Capital: ₹{capital:,.0f} crore\n"
        f"• Reserves & Surplus: ₹{reserves:,.0f} crore\n"
        f"• Total Equity: ₹{capital + reserves:,.0f} crore"
    )
    return IndexedChunk(
        id=f"icici_{period.lower()}_balance_sheet_health",
        text=text,
        period=period,
        chunk_type="balance_sheet_analysis",
        primary_value=total_assets,
    )


def ratios_chunk(fin: Json, period: str, company: str) -> Optional[IndexedChunk]:
    """Key-ratios chunk (reference :204-239).

    The reference only emits EPS lines (the only ratio block implemented) and
    gates on the text being non-trivial; we keep both behaviors.
    """
    results = fin.get("consolidatedResults")
    if not results or "ratios" not in results:
        return None
    cur, prev = period_keys(period)
    ratios = results["ratios"]

    text = f"{company} {period} Key Financial Ratios & Metrics:\n\n"
    basic_eps = 0.0
    if "earningsPerShare" in ratios:
        eps = ratios["earningsPerShare"]
        basic_eps = _get(eps.get("basic"), cur)
        diluted_eps = _get(eps.get("diluted"), cur)
        prev_basic_eps = _get(eps.get("basic"), prev)
        text += "EARNINGS METRICS:\n"
        text += f"• Basic EPS: ₹{basic_eps:.2f} per share"
        if prev_basic_eps:
            text += f" ({_growth(basic_eps, prev_basic_eps):+.1f}% YoY)"
        text += f"\n• Diluted EPS: ₹{diluted_eps:.2f} per share\n\n"

    if len(text) <= 100:
        return None
    return IndexedChunk(
        id=f"icici_{period.lower()}_key_ratios",
        text=text,
        period=period,
        chunk_type="financial_ratios",
        primary_value=basic_eps,
    )


def segment_chunk(segmental: Json, period: str, company: str) -> Optional[IndexedChunk]:
    """Business-segment performance chunk (reference :241-327)."""
    seg_results = segmental.get("consolidatedSegmentalResults") or segmental.get("segmentalResults")
    if not seg_results:
        return None
    revenue_data = seg_results.get("segmentRevenue")
    profit_data = seg_results.get("segmentResults") or seg_results.get("segmentalResults")
    if not revenue_data or not profit_data:
        return None
    cur, _ = period_keys(period)

    details = []
    total_revenue = 0.0
    for seg_key, seg_name in _SEGMENTS.items():
        series = revenue_data.get(seg_key)
        if not series or cur not in series:
            continue
        # _get, not series[cur]: an explicit JSON null must behave like a
        # missing key (see _get's docstring) — raw access crashed the whole
        # corpus build on one null segment revenue.
        revenue = _get(series, cur)
        if revenue is None:
            continue
        profit = _get(profit_data.get(seg_key), cur)
        total_revenue += revenue
        details.append((seg_name, revenue, profit, _pct(profit, revenue)))
    details.sort(key=lambda d: d[1], reverse=True)

    text = f"{company} {period} Retail Banking & Business Segment Performance:\n\n"
    for name, revenue, profit, margin in details:
        text += (
            f"{name.upper()} SEGMENT:\n"
            f"• Revenue: ₹{revenue:,.0f} crore ({_pct(revenue, total_revenue):.1f}%)\n"
            f"• Segment Result: ₹{profit:,.0f} crore\n"
            f"• Margin: {margin:.1f}%\n\n"
        )
    text += f"TOTAL SEGMENT REVENUE: ₹{total_revenue:,.0f} crore"

    return IndexedChunk(
        id=f"icici_{period.lower()}_segment_performance",
        text=text,
        period=period,
        chunk_type="segment_analysis",
        primary_value=total_revenue,
    )


def create_complete_context_chunks(
    quarterly_data: list[Json], period: str, id_prefix: str = "icici"
) -> list[IndexedChunk]:
    """Build the four analysis chunks for one quarter.

    Same public contract as the reference entry point
    (``chunking_storing (1).py:31``): list of raw statement JSONs + period
    string → list of chunk records, in the order profitability, balance sheet,
    ratios, segments.
    """
    roles = classify_quarterly_files(quarterly_data)
    fin = roles["fin"]
    if fin is None:
        return []
    company = fin.get("company", "ICICI Bank Limited")

    chunks = []
    for builder, source in (
        (profitability_chunk, fin),
        (balance_sheet_chunk, roles["balance"]),
        (ratios_chunk, fin),
        (segment_chunk, roles["segmental"]),
    ):
        if source is None:
            continue
        chunk = builder(source, period, company)
        if chunk is not None:
            if id_prefix != "icici":
                chunk.id = id_prefix + chunk.id[len("icici"):]
            chunks.append(chunk)
    return chunks
