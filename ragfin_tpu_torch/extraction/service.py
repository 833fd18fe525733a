"""Entity extraction: chunk text → ExtractedEntities (C7/C8).

Three extraction paths, all producing the same
:class:`~ragfin_tpu_torch.data.models.ExtractedEntities` contract:

1. :class:`EntityExtractor` — LLM extraction with the strict-JSON schema
   prompt, response-cleaning pipeline (fence stripping, brace slicing,
   float-precision repair, required-field filtering) and model swapping —
   behavior parity with ``graph_rag_mcp/services/extraction_service.py:16-161``.
2. :func:`rule_based_extract` — deterministic regex extraction over the
   framework's own chunk text formats (no LLM, exact). No reference
   counterpart; it is the offline/production path and the test oracle for
   the LLM path.
3. :func:`convert_structured_to_entities` — the no-LLM structured-JSON
   ingestion path (reference ``extraction_service.py:162-276``).
"""

from __future__ import annotations

import json
import re
from typing import Optional

from ..data.models import (
    BalanceSheetItem,
    BusinessSegment,
    ExtractedEntities,
    FinancialChunk,
    FinancialMetric,
    FinancialRatio,
)
from ..llm.providers import LLMProvider, ModelFactory

_SCHEMA_EXAMPLE = {
    "quarter": "Q1_FY2024",
    "financial_metrics": [
        {"name": "NET PROFIT", "value": 10636.0, "growth_yoy": 44.0, "unit": "crore"},
        {"name": "Total Income", "value": 52084.0, "growth_yoy": 32.8, "unit": "crore"},
    ],
    "business_segments": [
        {"name": "RETAIL BANKING SEGMENT", "revenue": 31057.0, "margin": 13.5, "percentage_of_total": 35.5},
    ],
    "financial_ratios": [
        {"name": "Basic EPS", "value": 15.22, "growth_yoy": 43.3, "unit": "per share"},
        {"name": "Net Margin", "value": 20.4, "unit": "percentage"},
    ],
    "balance_sheet_items": [
        {"name": "Advances", "value": 1124875.0, "percentage_of_total": 55.1, "unit": "crore"},
    ],
}


def build_extraction_prompt(text: str) -> str:
    """Strict-JSON extraction prompt (schema parity with the reference's
    entity contract; reference extraction_service.py:91-161)."""
    return (
        "Extract every financial figure from this bank quarterly-report excerpt.\n\n"
        f"TEXT:\n{text}\n\n"
        "Respond with ONLY a JSON object in exactly this shape (no prose, no "
        "markdown fences):\n"
        f"{json.dumps(_SCHEMA_EXAMPLE, indent=2)}\n\n"
        "Rules:\n"
        "- Strip currency/commas: ₹52,084 crore -> 52084.0; percentages: 20.4% -> 20.4;\n"
        "  YoY growth markers: (+44.0% YoY) -> growth_yoy 44.0.\n"
        "- quarter must be formatted Q#_FY#### (underscore, e.g. Q1_FY2024).\n"
        "- Cover all income/expense/profit items, every ratio and margin, every\n"
        "  business segment (revenue, margin, share of total), and every balance\n"
        "  sheet item present in the text.\n"
        "- Use null for values the text does not state; never invent numbers.\n"
    )


def clean_llm_json(response: str) -> Optional[dict]:
    """Response-cleaning pipeline: strip code fences, slice outermost braces,
    repair float-precision blowups, parse (reference :34-68)."""
    if not response or not response.strip():
        return None
    text = re.sub(r"```(?:json)?\n?|```\n?", "", response.strip())
    start, end = text.find("{"), text.rfind("}")
    if start == -1 or end <= start:
        return None
    text = text[start : end + 1]
    text = re.sub(r"(\d+)\.0{20,}", r"\1.0", text)
    text = re.sub(r"(\d+\.\d{1,2})\d{20,}", r"\1", text)
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return None


def filter_required(data: dict) -> dict:
    """Drop items missing their required numeric field (reference :70-83)."""

    def keep(items, field):
        return [i for i in (items or []) if isinstance(i, dict) and i.get(field) is not None]

    return {
        "quarter": data.get("quarter"),
        "financial_metrics": keep(data.get("financial_metrics"), "value"),
        "business_segments": keep(data.get("business_segments"), "revenue"),
        "financial_ratios": keep(data.get("financial_ratios"), "value"),
        "balance_sheet_items": keep(data.get("balance_sheet_items"), "value"),
    }


class EntityExtractor:
    """LLM-backed extractor with swappable provider (reference :16-89)."""

    def __init__(self, model_name: str = "fake", api_key: Optional[str] = None, provider: Optional[LLMProvider] = None, **kwargs):
        self.current_model = model_name
        self.api_key = api_key
        self.client = provider or ModelFactory.create_provider(model_name, api_key, **kwargs)

    def switch_model(self, model_name: str, api_key: Optional[str] = None, **kwargs) -> None:
        self.current_model = model_name
        self.api_key = api_key or self.api_key
        self.client = ModelFactory.create_provider(model_name, self.api_key, **kwargs)

    async def extract(self, chunk: FinancialChunk) -> ExtractedEntities:
        try:
            response = await self.client.generate_content(build_extraction_prompt(chunk.text))
            parsed = clean_llm_json(response)
            if parsed is None:
                return ExtractedEntities()
            return ExtractedEntities(**filter_required(parsed))
        except Exception:
            return ExtractedEntities()


# ---------------------------------------------------------------------------
# Deterministic rule-based extraction over our chunk formats
# ---------------------------------------------------------------------------

_NUM = r"([\d,]+(?:\.\d+)?)"
_GROWTH = r"(?:\s*\(([+-][\d.]+)% YoY(?: growth)?\))?"


def _f(s: Optional[str]) -> Optional[float]:
    return float(s.replace(",", "")) if s else None


def _quarter_of(text: str) -> Optional[str]:
    m = re.search(r"Q[1-4]_FY\d{4}", text)
    return m.group(0) if m else None


def rule_based_extract(text: str) -> ExtractedEntities:
    """Exact extraction from the chunker's own text formats (chunker.py).

    Deterministic inverse of the chunk templates: every number the chunker
    printed is recovered with its canonical entity name. Unknown text yields
    an empty ExtractedEntities (same failure contract as the LLM path).
    """
    quarter = _quarter_of(text)
    metrics: list[FinancialMetric] = []
    ratios: list[FinancialRatio] = []
    segments: list[BusinessSegment] = []
    balance: list[BalanceSheetItem] = []

    def metric(name, pattern, unit="crore"):
        m = re.search(pattern, text)
        if m:
            growth = _f(m.group(2)) if m.lastindex and m.lastindex >= 2 else None
            metrics.append(FinancialMetric(name=name, value=_f(m.group(1)), growth_yoy=growth, unit=unit))

    def ratio(name, pattern, unit="percentage"):
        m = re.search(pattern, text)
        if m:
            growth = _f(m.group(2)) if m.lastindex and m.lastindex >= 2 else None
            ratios.append(FinancialRatio(name=name, value=_f(m.group(1)), growth_yoy=growth, unit=unit))

    # Profitability chunk (chunker.profitability_chunk format).
    metric("NET PROFIT", rf"NET PROFIT: ₹{_NUM} crore{_GROWTH}")
    metric("Operating Profit", rf"Operating Profit: ₹{_NUM} crore")
    metric("Total Income", rf"INCOME: Total ₹{_NUM} crore{_GROWTH}")
    metric("Interest Income", rf"Interest Income: ₹{_NUM} crore")
    metric("Other Income", rf"Other Income: ₹{_NUM} crore")
    metric("Total Expenses", rf"EXPENSES: Total ₹{_NUM} crore")
    m = re.search(rf"Interest: ₹{_NUM} crore \| Operating: ₹{_NUM} crore", text)
    if m:
        metrics.append(FinancialMetric(name="Interest Expenses", value=_f(m.group(1))))
        metrics.append(FinancialMetric(name="Operating Expenses", value=_f(m.group(2))))
    metric("Provisions", rf"Provisions: ₹{_NUM} crore")
    m = re.search(rf"Net Margin: {_NUM}% \| Operating Margin: {_NUM}%", text)
    if m:
        ratios.append(FinancialRatio(name="Net Margin", value=_f(m.group(1)), unit="percentage"))
        ratios.append(FinancialRatio(name="Operating Margin", value=_f(m.group(2)), unit="percentage"))
    ratio("Cost Ratio", rf"Cost Ratio: {_NUM}%")

    # Ratios chunk.
    ratio("Basic EPS", rf"Basic EPS: ₹{_NUM} per share{_GROWTH}", unit="per share")
    ratio("Diluted EPS", rf"Diluted EPS: ₹{_NUM} per share", unit="per share")

    # Balance sheet chunk.
    def bs(name, pattern):
        m = re.search(pattern, text)
        if m:
            pct = _f(m.group(2)) if m.lastindex and m.lastindex >= 2 else None
            balance.append(BalanceSheetItem(name=name, value=_f(m.group(1)), percentage_of_total=pct))

    bs("Total Assets", rf"ASSET COMPOSITION \(Total: ₹{_NUM} crore\)")
    bs("Advances", rf"Advances: ₹{_NUM} crore \({_NUM}% of total assets\)")
    bs("Investments", rf"Investments: ₹{_NUM} crore \({_NUM}% of total assets\)")
    bs("Cash & RBI Balances", rf"Cash & RBI Balances: ₹{_NUM} crore")
    bs("Customer Deposits", rf"Customer Deposits: ₹{_NUM} crore")
    bs("Borrowings", rf"Borrowings: ₹{_NUM} crore")
    bs("Share Capital", rf"Share Capital: ₹{_NUM} crore")
    bs("Reserves & Surplus", rf"Reserves & Surplus: ₹{_NUM} crore")
    bs("Total Equity", rf"Total Equity: ₹{_NUM} crore")
    m = re.search(rf"Deposit-to-Funding Ratio: {_NUM}%", text)
    if m:
        ratios.append(FinancialRatio(name="Deposit-to-Funding Ratio", value=_f(m.group(1)), unit="percentage"))

    # Segment chunk: repeated blocks "<NAME> SEGMENT: ... Revenue ... Result ... Margin".
    for m in re.finditer(
        rf"([A-Z &]+) SEGMENT:\n• Revenue: ₹{_NUM} crore \({_NUM}%\)\n"
        rf"• Segment Result: ₹{_NUM} crore\n• Margin: {_NUM}%",
        text,
    ):
        segments.append(
            BusinessSegment(
                name=f"{m.group(1).strip()} SEGMENT",
                revenue=_f(m.group(2)),
                margin=_f(m.group(5)),
                percentage_of_total=_f(m.group(3)),
            )
        )

    return ExtractedEntities(
        quarter=quarter,
        financial_metrics=metrics,
        business_segments=segments,
        financial_ratios=ratios,
        balance_sheet_items=balance,
    )


class RuleBasedExtractor:
    """EntityExtractor-compatible wrapper around rule_based_extract."""

    current_model = "rule-based"

    async def extract(self, chunk: FinancialChunk) -> ExtractedEntities:
        return rule_based_extract(chunk.text)

    def switch_model(self, *a, **k) -> None:  # pragma: no cover - API parity
        pass


# ---------------------------------------------------------------------------
# Structured-format converter (C8; reference extraction_service.py:162-276)
# ---------------------------------------------------------------------------

_METRIC_NAME_MAP = {
    "interestEarned": "Interest Income",
    "otherIncome": "Other Income",
    "totalIncome": "Total Income",
    "interestExpended": "Interest Expenses",
    "operatingExpenses": "Operating Expenses",
    "totalExpenditure": "Total Expenses",
    "netProfitForThePeriod": "NET PROFIT",
    "operatingProfit": "Operating Profit",
    "provisions": "Provisions",
}


def normalize_metric_name(raw: str) -> str:
    return _METRIC_NAME_MAP.get(raw, raw.replace("_", " ").title())


def normalize_company_name(raw: str) -> str:
    lowered = (raw or "").lower()
    for key, name in (("axis", "Axis Bank"), ("icici", "ICICI Bank"), ("hdfc", "HDFC Bank"),
                      ("kotak", "Kotak Bank"), ("sbi", "SBI"), ("dbs", "DBS Bank")):
        if key in lowered:
            return name
    cleaned = (raw or "").replace(".pdf", "").replace("_", " ").strip()
    return cleaned or "Unknown Bank"


def infer_period_from_structured(data: dict) -> Optional[str]:
    """Infer Q#_FY#### from period keys like ``march2024`` (reference :241-263)."""
    month_to_quarter = {"june": "Q1", "september": "Q2", "december": "Q3", "march": "Q4"}

    def scan(obj):
        if isinstance(obj, dict):
            for key, val in obj.items():
                m = re.match(r"(june|september|december|march)(\d{4})", str(key).lower())
                if m:
                    month, year = m.group(1), int(m.group(2))
                    fy = year if month == "march" else year + 1
                    return f"{month_to_quarter[month]}_FY{fy}"
                found = scan(val)
                if found:
                    return found
        return None

    # No fallback pseudo-quarter: "FY2024" would pass GraphBuilder's
    # `if not entities.quarter` check and create facts no Q#_FY#### query
    # can ever reach — returning None lets GraphBuilder count the chunk as
    # failed (the failure-accounting contract).
    return scan(data.get("periods", {})) or scan(data.get("financialResults", {}))


def convert_structured_to_entities(structured: dict) -> tuple[ExtractedEntities, str]:
    """Structured statement JSON → entities + company name (no LLM)."""
    company = normalize_company_name(structured.get("company", ""))
    period = infer_period_from_structured(structured)

    metrics: list[FinancialMetric] = []
    ratios: list[FinancialRatio] = []
    results = structured.get("financialResults", {})
    for section in ("income", "expenses", "profitAndLoss"):
        for key, series in (results.get(section) or {}).items():
            if not isinstance(series, dict):
                continue
            for value in series.values():
                try:
                    metrics.append(FinancialMetric(name=normalize_metric_name(key), value=float(value)))
                except (TypeError, ValueError):
                    continue
    for name, series in (results.get("ratios") or {}).items():
        if isinstance(series, dict):
            for value in series.values():
                try:
                    ratios.append(
                        FinancialRatio(
                            name=name,
                            value=float(value),
                            unit="percentage" if "%" in name else "ratio",
                        )
                    )
                except (TypeError, ValueError):
                    continue

    return (
        ExtractedEntities(quarter=period, financial_metrics=metrics, financial_ratios=ratios),
        company,
    )
