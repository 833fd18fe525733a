"""Deterministic analytical answerer for the offline extractive mode.

The reference answers every question by prompting Gemini with the top-k chunk
texts (``retrieve.py:52-72``) — including trend/comparison questions whose
answers require arithmetic across quarters (``qa_subset.json`` categories
Numerical Extraction / Trend Analysis / Comparative Questions). Offline, a
verbatim chunk quote cannot answer those. This module closes the gap
deterministically: chunk texts are generated from fixed templates
(:mod:`ragfin_tpu.data.chunker`), so field values can be parsed back exactly,
and the change/trend/extremum/ranking arithmetic the LLM would do is computed
on host from the parsed figures.

Question understanding is table-driven keyword matching over the dataset's
fixed financial vocabulary (the same vocabulary the reference embeds in its
entity-extraction prompt, ``graph_cons.py:483-739``) — no LLM call, fully
reproducible.
"""

from __future__ import annotations

import re
import statistics
from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..data.models import IndexedChunk

_NUM = r"([\d,]+(?:\.\d+)?)"
_SIGNED = r"([+-]?[\d.]+)"


def _f(tok: str) -> float:
    return float(tok.replace(",", ""))


# --- chunk-template parsers -------------------------------------------------

_PROFIT_PATTERNS = {
    "net_profit": rf"NET PROFIT: ₹{_NUM} crore",
    "net_profit_growth": rf"NET PROFIT: ₹[\d,.]+ crore \({_SIGNED}% YoY growth\)",
    "operating_profit": rf"Operating Profit: ₹{_NUM} crore",
    "net_margin": rf"Net Margin: {_NUM}%",
    "operating_margin": rf"Operating Margin: {_NUM}%",
    "total_income": rf"INCOME: Total ₹{_NUM} crore",
    "total_income_growth": rf"INCOME: Total ₹[\d,.]+ crore \({_SIGNED}% YoY\)",
    "interest_income": rf"Interest Income: ₹{_NUM} crore",
    "other_income": rf"Other Income: ₹{_NUM} crore",
    "total_expenses": rf"EXPENSES: Total ₹{_NUM} crore",
    "interest_expense": rf"Interest: ₹{_NUM} crore \| Operating",
    "operating_expense": rf"Operating: ₹{_NUM} crore",
    "provisions": rf"Provisions: ₹{_NUM} crore",
    "cost_ratio": rf"Cost Ratio: {_NUM}%",
}

_BALANCE_PATTERNS = {
    "total_assets": rf"ASSET COMPOSITION \(Total: ₹{_NUM} crore\)",
    "advances": rf"Advances: ₹{_NUM} crore",
    "investments": rf"Investments: ₹{_NUM} crore",
    "cash_rbi": rf"Cash & RBI Balances: ₹{_NUM} crore",
    "customer_deposits": rf"Customer Deposits: ₹{_NUM} crore",
    "borrowings": rf"Borrowings: ₹{_NUM} crore",
    "deposit_funding_ratio": rf"Deposit-to-Funding Ratio: {_NUM}%",
    "share_capital": rf"Share Capital: ₹{_NUM} crore",
    "reserves": rf"Reserves & Surplus: ₹{_NUM} crore",
    "total_equity": rf"Total Equity: ₹{_NUM} crore",
}

_RATIO_PATTERNS = {
    "basic_eps": rf"Basic EPS: ₹{_NUM} per share",
    "basic_eps_growth": rf"Basic EPS: ₹[\d,.]+ per share \({_SIGNED}% YoY\)",
    "diluted_eps": rf"Diluted EPS: ₹{_NUM} per share",
}

_SEGMENT_HEADER = re.compile(r"([A-Z][A-Z &]+?) SEGMENT:")
_SEGMENT_FIELDS = {
    "revenue": rf"Revenue: ₹{_NUM} crore",
    "share": rf"Revenue: ₹[\d,.]+ crore \({_NUM}%\)",
    "result": rf"Segment Result: ₹{_NUM} crore",
    "margin": rf"Margin: {_SIGNED}%",
}


@dataclass
class QuarterData:
    """Parsed figures for one quarter, keyed by canonical field name."""

    period: str
    fields: dict = field(default_factory=dict)
    segments: dict = field(default_factory=dict)  # name -> {revenue, share, result, margin}
    source_ids: list = field(default_factory=list)


def _apply(patterns: dict, text: str, out: dict) -> None:
    for name, pat in patterns.items():
        m = re.search(pat, text)
        if m:
            out[name] = _f(m.group(1))


def parse_chunk(record: IndexedChunk, data: QuarterData) -> None:
    """Parse one chunk's template text into the quarter's field table."""
    text = record.text
    ct = record.chunk_type
    if ct == "profitability_analysis":
        _apply(_PROFIT_PATTERNS, text, data.fields)
    elif ct == "balance_sheet_analysis":
        _apply(_BALANCE_PATTERNS, text, data.fields)
    elif ct == "financial_ratios":
        _apply(_RATIO_PATTERNS, text, data.fields)
    elif ct == "segment_analysis":
        parts = _SEGMENT_HEADER.split(text)
        # parts = [preamble, NAME1, body1, NAME2, body2, ...]
        for i in range(1, len(parts) - 1, 2):
            name = parts[i].strip().lower()
            seg: dict = {}
            _apply(_SEGMENT_FIELDS, parts[i + 1], seg)
            if seg:
                data.segments[name] = seg
    data.source_ids.append(record.id)


# --- question vocabulary ----------------------------------------------------

# Longest-phrase-first metric table: phrase -> (field, kind, label, chunk_type)
# kind: "cur" (₹ crore), "pct" (percent), "eps" (₹ per share).
_METRIC_TABLE: list[tuple[str, str, str, str, str]] = [
    ("net profit margin", "net_margin", "pct", "net profit margin", "profitability_analysis"),
    ("net margin", "net_margin", "pct", "net margin", "profitability_analysis"),
    ("growth in net profit", "net_profit_growth", "pct", "net profit YoY growth", "profitability_analysis"),
    ("net profit growth", "net_profit_growth", "pct", "net profit YoY growth", "profitability_analysis"),
    ("operating margin", "operating_margin", "pct", "operating margin", "profitability_analysis"),
    ("operating profit", "operating_profit", "cur", "operating profit", "profitability_analysis"),
    ("net profit", "net_profit", "cur", "net profit", "profitability_analysis"),
    ("profitability", "net_margin", "pct", "net profit margin", "profitability_analysis"),
    ("total income growth", "total_income_growth", "pct", "total income YoY growth", "profitability_analysis"),
    ("income growth rate", "total_income_growth", "pct", "total income YoY growth", "profitability_analysis"),
    ("total income", "total_income", "cur", "total income", "profitability_analysis"),
    ("interest income", "interest_income", "cur", "interest income", "profitability_analysis"),
    ("other income", "other_income", "cur", "other income", "profitability_analysis"),
    ("total expenses", "total_expenses", "cur", "total expenses", "profitability_analysis"),
    ("operating expense", "operating_expense", "cur", "operating expenses", "profitability_analysis"),
    ("provisions", "provisions", "cur", "provisions", "profitability_analysis"),
    ("cost ratio", "cost_ratio", "pct", "cost ratio", "profitability_analysis"),
    ("cost-to-income", "cost_ratio", "pct", "cost ratio", "profitability_analysis"),
    ("customer deposits", "customer_deposits", "cur", "customer deposits", "balance_sheet_analysis"),
    ("deposits", "customer_deposits", "cur", "customer deposits", "balance_sheet_analysis"),
    ("total equity", "total_equity", "cur", "total equity", "balance_sheet_analysis"),
    ("equity", "total_equity", "cur", "total equity", "balance_sheet_analysis"),
    ("total assets", "total_assets", "cur", "total assets", "balance_sheet_analysis"),
    ("advances", "advances", "cur", "advances", "balance_sheet_analysis"),
    ("investments", "investments", "cur", "investments", "balance_sheet_analysis"),
    ("borrowings", "borrowings", "cur", "borrowings", "balance_sheet_analysis"),
    ("reserves", "reserves", "cur", "reserves & surplus", "balance_sheet_analysis"),
    ("share capital", "share_capital", "cur", "share capital", "balance_sheet_analysis"),
    ("diluted eps", "diluted_eps", "eps", "diluted EPS", "financial_ratios"),
    ("basic eps", "basic_eps", "eps", "basic EPS", "financial_ratios"),
    ("earnings per share", "basic_eps", "eps", "basic EPS", "financial_ratios"),
    ("eps", "basic_eps", "eps", "basic EPS", "financial_ratios"),
]

_SEGMENT_NAMES = [
    "retail banking",
    "wholesale banking",
    "life insurance",
    "treasury",
    "others",
]

class _UncoveredPeriod(Exception):
    def __init__(self, period: str, available: list):
        super().__init__(period)
        self.period = period
        self.available = available


_ALL_QUARTER_WORDS = (
    "all quarters", "all four", "across", "throughout", "each quarter",
    "trend", "evolve", "quarterly", "over fy", "during fy", "volatile",
)
_MIN_WORDS = ("lowest", "smallest", "least", "worst", "minimum", "weakest")
# An explicitly named quarter pins the question to that quarter even when
# expansion words ("across", "quarterly") also appear.
_EXPLICIT_QUARTER = re.compile(
    r"\bq[1-4]\b|\b(?:first|second|third|fourth|1st|2nd|3rd|4th|last|final)\s+quarter\b"
)
_EXTREMUM_WORDS = (
    "which quarter", "highest", "peak", "best", "lowest", "smallest",
    "least", "worst", "maximum", "minimum", "strongest", "weakest",
) + _MIN_WORDS


def _fmt_cur(v: float) -> str:
    return f"₹{v:,.0f} crore"


def _fmt_eps(v: float) -> str:
    return f"₹{v:,.2f} per share"


def _fmt(v: float, kind: str) -> str:
    if kind == "cur":
        return _fmt_cur(v)
    if kind == "eps":
        return _fmt_eps(v)
    return f"{v:.1f}%"


def _pretty_period(period: str) -> str:
    # Q1_FY2024 -> "Q1 FY2024"
    return period.replace("_", " ")


def _pct_change(a: float, b: float) -> float:
    return (b - a) / abs(a) * 100 if a else 0.0


class AnalyticalAnswerer:
    """Question-aware deterministic answers over a chunk corpus.

    Parses every chunk's template once (lazy, cached) into per-quarter field
    tables, then answers direct-fact / change / trend / extremum / compare /
    ranking / volatility questions with exact figures plus the derived
    arithmetic the reference would have asked Gemini to do.
    """

    def __init__(self, records: Sequence[IndexedChunk], company: Optional[str] = "ICICI Bank"):
        self.records = list(records)
        self.company = company
        # Companies present in the corpus OTHER than the scoped one: a
        # question naming any of them must NOT be answered from this
        # company's figures (answer() bails to the company-scoped
        # retrieval path instead).
        self._other_companies = sorted(
            {
                getattr(r, "company", company) or ""
                for r in self.records
            }
            - {company, "", None}
        )
        self._data: Optional[dict[str, QuarterData]] = None

    def _names_other_company(self, ql: str) -> bool:
        if not self.company or not self._other_companies:
            return False
        from .queryfilter import _GENERIC_NAME_TOKENS as generic

        qtokens = set(re.findall(r"[a-z0-9&]+", ql))
        for c in self._other_companies:
            toks = set(c.lower().split()) - generic
            if toks and toks & qtokens:
                return True
        return False

    # --- corpus parsing ----------------------------------------------------
    @property
    def data(self) -> dict[str, QuarterData]:
        if self._data is None:
            out: dict[str, QuarterData] = {}
            for r in self.records:
                # Single-tenant parsing: in a multi-company corpus another
                # company's chunk for the same quarter would overwrite the
                # scoped company's figures — confidently wrong answers.
                if self.company and getattr(r, "company", self.company) != self.company:
                    continue
                qd = out.setdefault(r.period, QuarterData(r.period))
                parse_chunk(r, qd)
            self._data = out
        return self._data

    def _chronological(self, periods) -> list[str]:
        def key(p):
            m = re.match(r"Q([1-4])_FY(\d{4})", p)
            return (int(m.group(2)), int(m.group(1))) if m else (9999, 9)

        return sorted(periods, key=key)

    # --- question parsing ----------------------------------------------------
    def _quarters_in_question(self, q: str) -> list[str]:
        """Resolve the question's quarters against the corpus.

        Period grammar is shared with the retrieval filters
        (:func:`ragfin_tpu.retrieval.queryfilter.extract_filters`), so
        multi-year comparisons keep each quarter paired with ITS year."""
        from .queryfilter import extract_filters

        ql = q.lower()
        years = {p.split("_FY")[1] for p in self.data if "_FY" in p}
        for y in re.findall(r"fy\s?(\d{4})", ql):
            if y not in years:
                # The question names a fiscal year the corpus doesn't cover;
                # answering from another year's data would be silently wrong.
                raise _UncoveredPeriod(f"FY{y}", sorted(years))
        periods = [
            p for p in extract_filters(q, list(self.data)).periods if p in self.data
        ]
        if not periods:
            # Bare quarters (or none) with no year named: the scoped
            # company's latest year on record, matching FilteredSearch's
            # implicit temporal scope.
            year = sorted(years)[-1] if years else "2024"
            for n in re.findall(r"\bq([1-4])\b", ql):
                p = f"Q{n}_FY{year}"
                if p in self.data and p not in periods:
                    periods.append(p)
            if not periods or any(w in ql for w in _ALL_QUARTER_WORDS):
                if len(periods) < 2:
                    periods = [p for p in self.data if p.endswith(f"FY{year}")]
        elif (
            any(w in ql for w in _ALL_QUARTER_WORDS)
            and len(periods) < 2
            and not _EXPLICIT_QUARTER.search(ql)
        ):
            # Expansion words ("across", "quarterly") widen an implicit
            # scope, but an EXPLICITLY named quarter ("Q3 FY2024 across all
            # businesses") must stay a single-quarter question.
            yearset = {p.split("_FY")[1] for p in periods if "_FY" in p}
            periods = [
                p for p in self.data if "_FY" in p and p.split("_FY")[1] in yearset
            ]
        return self._chronological(dict.fromkeys(periods))

    def _metric_in_question(self, q: str):
        ql = q.lower()
        for phrase, fieldname, kind, label, ct in _METRIC_TABLE:
            # Word-bounded: a bare substring test let "eps" hijack "steps"
            # with a confident (wrong-topic) EPS answer.
            if re.search(rf"\b{re.escape(phrase)}\b", ql):
                return fieldname, kind, label, ct
        return None

    def _segments_in_question(self, q: str) -> list[str]:
        ql = q.lower()
        found = [s for s in _SEGMENT_NAMES if s in ql or s.rstrip("s") + " segment" in ql]
        # bare "others" only counts with an explicit segment suffix
        if "others" in found and "others segment" not in ql and "'others'" not in ql:
            found.remove("others")
        # "all segments" / ranking questions address every segment
        return found

    def _segment_field(self, q: str) -> tuple[str, str, str]:
        ql = q.lower()
        if "margin" in ql:
            return "margin", "pct", "margin"
        if "result" in ql:
            return "result", "cur", "segment result"
        return "revenue", "cur", "revenue"

    # --- answer builders -----------------------------------------------------
    def _get(self, period: str, fieldname: str, segment: Optional[str] = None):
        qd = self.data.get(period)
        if qd is None:
            return None
        if segment is not None:
            return qd.segments.get(segment, {}).get(fieldname)
        return qd.fields.get(fieldname)

    def _series(self, periods, fieldname, segment=None):
        out = []
        for p in periods:
            v = self._get(p, fieldname, segment)
            if v is not None:
                out.append((p, v))
        return out

    def _fact(self, period, fieldname, kind, label, segment=None) -> Optional[str]:
        v = self._get(period, fieldname, segment)
        if v is None:
            return None
        subject = f"{segment} segment {label}" if segment else label
        extra = ""
        growth = self._get(period, fieldname + "_growth", segment)
        if growth is not None:
            extra = f" ({growth:+.1f}% YoY)"
        return f"{subject.capitalize()} in {_pretty_period(period)} was {_fmt(v, kind)}{extra}."

    def _pair_change(self, p_from, p_to, fieldname, kind, label, segment=None) -> Optional[str]:
        a = self._get(p_from, fieldname, segment)
        b = self._get(p_to, fieldname, segment)
        if a is None or b is None:
            return None
        subject = f"{segment} segment {label}" if segment else label
        frm, to = _pretty_period(p_from), _pretty_period(p_to)
        if kind == "pct":
            d = b - a
            word = "increase" if d >= 0 else "decrease"
            return (
                f"{subject.capitalize()} changed by {abs(d):.1f} percentage points "
                f"({word}) from {a:.1f}% in {frm} to {b:.1f}% in {to}."
            )
        pct = _pct_change(a, b)
        d = b - a
        word = "increase" if d >= 0 else "decrease"
        return (
            f"{subject.capitalize()} showed a {pct:+.2f}% change from {_fmt(a, kind)} in {frm} "
            f"to {_fmt(b, kind)} in {to} — an absolute {word} of {_fmt(abs(d), kind)}."
        )

    def _trend(self, periods, fieldname, kind, label, segment=None, want_average=False) -> Optional[str]:
        series = self._series(periods, fieldname, segment)
        if len(series) < 2:
            return None
        subject = f"{segment} segment {label}" if segment else label
        parts = []
        qoq: list[float] = []
        prev = None
        for p, v in series:
            qtag = p.split("_")[0]
            note = []
            growth = None if kind == "pct" else self._get(p, fieldname + "_growth", segment)
            if growth is not None:
                note.append(f"{growth:+.1f}% YoY")
            if prev is not None:
                if kind == "pct":
                    note.append(f"{v - prev:+.1f}pp QoQ")
                    qoq.append(v - prev)
                else:
                    g = _pct_change(prev, v)
                    note.append(f"{g:+.2f}% QoQ")
                    qoq.append(g)
            prev = v
            suffix = f" ({', '.join(note)})" if note else ""
            parts.append(f"{qtag}: {_fmt(v, kind)}{suffix}")
        text = f"{subject.capitalize()} across {_pretty_period(series[0][0]).split(' ')[1]}: " + ", ".join(parts) + "."
        if want_average and qoq:
            avg = statistics.fmean(qoq)
            unit = "pp" if kind == "pct" else "%"
            text += f" Average quarterly change: {avg:+.2f}{unit}."
        return text

    def _extremum(self, periods, fieldname, kind, label, segment=None, minimum=False) -> Optional[str]:
        series = self._series(periods, fieldname, segment)
        if not series:
            return None
        pick = min(series, key=lambda t: t[1]) if minimum else max(series, key=lambda t: t[1])
        subject = f"{segment} segment {label}" if segment else label
        others = ", ".join(
            f"{p.split('_')[0]}: {_fmt(v, kind)}" for p, v in series if p != pick[0]
        )
        word = "lowest" if minimum else "highest"
        return (
            f"{_pretty_period(pick[0])} had the {word} {subject} at {_fmt(pick[1], kind)}"
            + (f" ({others})." if others else ".")
        )

    def _compare_segments(self, segments, periods, q) -> Optional[str]:
        fieldname, kind, label = self._segment_field(q)
        s1, s2 = segments[0], segments[1]
        if len(periods) >= 2:
            # change comparison between first and last mentioned quarter —
            # growth% for currency fields, pp delta for percentage fields
            # (margins over a range must not silently collapse to one
            # period's snapshot).
            p0, p1 = periods[0], periods[-1]
            parts = []
            for s in (s1, s2):
                a, b = self._get(p0, fieldname, s), self._get(p1, fieldname, s)
                if a is None or b is None:
                    return None
                if kind == "pct":
                    parts.append(f"{s} {label} moved {b - a:+.1f}pp ({a:.1f}% to {b:.1f}%)")
                else:
                    parts.append(f"{s} grew {_pct_change(a, b):+.2f}% ({_fmt(a, kind)} to {_fmt(b, kind)})")
            return (
                f"From {_pretty_period(p0)} to {_pretty_period(p1)}: "
                + " vs ".join(parts) + "."
            )
        p = periods[0] if periods else None
        if p is None:
            return None
        a, b = self._get(p, fieldname, s1), self._get(p, fieldname, s2)
        if a is None or b is None:
            return None
        better = s1 if a >= b else s2
        diff = abs(a - b)
        # pct diffs are percentage POINTS (not _fmt's "%"); currency diffs
        # get full currency formatting, not a bare unitless float.
        span = f"{diff:.1f} percentage points" if kind == "pct" else _fmt(diff, kind)
        return (
            f"In {_pretty_period(p)}, {s1} {label} was {_fmt(a, kind)} vs {s2} {label} "
            f"{_fmt(b, kind)} — {better} outperformed by {span}."
        )

    def _ranking(self, period) -> Optional[str]:
        qd = self.data.get(period)
        if qd is None or not qd.segments:
            return None
        ranked = sorted(qd.segments.items(), key=lambda kv: -(kv[1].get("revenue") or 0.0))
        parts = []
        for i, (name, seg) in enumerate(ranked, 1):
            share = seg.get("share")
            stext = f" ({share:.1f}%)" if share is not None else ""
            parts.append(f"{i}. {name}: {_fmt_cur(seg.get('revenue', 0.0))}{stext}")
        return f"Segment revenue ranking in {_pretty_period(period)}: " + ", ".join(parts) + "."

    def _volatility(self, periods, q) -> Optional[str]:
        fieldname, kind, label = self._segment_field(q)
        ranges = []
        for s in _SEGMENT_NAMES:
            series = [v for _, v in self._series(periods, fieldname, s)]
            if len(series) >= 2:
                ranges.append((s, min(series), max(series)))
        if not ranges:
            return None
        name, lo, hi = max(ranges, key=lambda t: t[2] - t[1])
        span = (
            f"{hi - lo:.1f} percentage points" if kind == "pct" else _fmt(hi - lo, kind)
        )
        return (
            f"The {name} segment showed the most volatile {label}, ranging from "
            f"{_fmt(lo, kind)} to {_fmt(hi, kind)} (a range of {span})."
        )

    def _metric_volatility(self, periods, fieldname, kind, label) -> Optional[str]:
        series = self._series(periods, fieldname)
        if len(series) < 2:
            return None
        lo = min(series, key=lambda t: t[1])
        hi = max(series, key=lambda t: t[1])
        return (
            f"{label.capitalize()} ranged from {_fmt(lo[1], kind)} in "
            f"{_pretty_period(lo[0])} to {_fmt(hi[1], kind)} in "
            f"{_pretty_period(hi[0])} — a spread of {_fmt(hi[1] - lo[1], kind)}."
        )

    def _improvements(self, periods, q) -> Optional[str]:
        fieldname, kind, label = self._segment_field(q)
        if len(periods) < 2:
            return None
        p0, p1 = periods[0], periods[-1]
        improved = []
        for s in _SEGMENT_NAMES:
            a, b = self._get(p0, fieldname, s), self._get(p1, fieldname, s)
            if a is not None and b is not None and b > a:
                if kind == "pct":
                    improved.append(f"{s} improved by {b - a:.1f}pp ({a:.1f}% to {b:.1f}%)")
                else:
                    improved.append(
                        f"{s} improved {_pct_change(a, b):+.2f}% ({_fmt(a, kind)} to {_fmt(b, kind)})"
                    )
        if not improved:
            return None
        return (
            f"Segments with {label} improvement between {_pretty_period(p0)} and "
            f"{_pretty_period(p1)}: " + "; ".join(improved) + "."
        )

    # --- entry point ---------------------------------------------------------
    def answer(self, question: str) -> Optional[tuple[str, list[str]]]:
        """Answer a question; returns (answer, chunk ids consumed) or None
        when the question does not match the analytical vocabulary."""
        ql = question.lower()
        if self._names_other_company(ql):
            # The question names a different company than this answerer is
            # scoped to — a confident answer here would present the scoped
            # company's figures as the other company's.
            return None
        try:
            periods = self._quarters_in_question(question)
        except _UncoveredPeriod as e:
            return (
                f"The indexed data does not cover {e.period}; available "
                f"periods span FY{', FY'.join(e.available)}.",
                [],
            )
        if not periods:
            return None
        segments = self._segments_in_question(question)
        metric = self._metric_in_question(question)
        # "least" only counts as a minimum-extremum cue outside "at least".
        minimum = any(w in ql for w in _MIN_WORDS if w != "least") or bool(
            re.search(r"\bleast\b", ql.replace("at least", ""))
        )
        extremum = any(w in ql for w in _EXTREMUM_WORDS)
        want_avg = "average" in ql
        # Scan scope for extremum/volatility: every quarter of the
        # question's year(s) — NOT every year in a multi-year corpus
        # (FilteredSearch's latest-FY scoping applies here too).
        yearset = {p.split("_FY")[1] for p in periods if "_FY" in p}
        all_q = self._chronological(
            p for p in self.data if "_FY" in p and p.split("_FY")[1] in yearset
        )

        answer: Optional[str] = None
        used_periods = periods

        if "ranking" in ql or ("contribution" in ql and "rank" in ql):
            answer = self._ranking(periods[-1])
        elif "volatile" in ql or "volatility" in ql:
            used_periods = all_q
            if segments or "segment" in ql or metric is None:
                answer = self._volatility(all_q, question)
            else:
                # A plain metric named with "volatile" is about THAT metric,
                # not segment revenue.
                fieldname, kind, label, _ct = metric
                answer = self._metric_volatility(all_q, fieldname, kind, label)
        elif ("which segments" in ql or "what segments" in ql) and (
            "improvement" in ql or "improved" in ql
        ):
            answer = self._improvements(periods, question)
        elif len(segments) >= 2:
            answer = self._compare_segments(segments, periods, question)
        elif segments:
            fieldname, kind, label = self._segment_field(question)
            seg = segments[0]
            if extremum:
                used_periods = all_q
                answer = self._extremum(all_q, fieldname, kind, label, seg, minimum)
            elif len(periods) == 2 and not want_avg:
                answer = self._pair_change(periods[0], periods[1], fieldname, kind, label, seg)
            elif len(periods) > 2 or want_avg:
                answer = self._trend(periods if len(periods) > 2 else all_q, fieldname, kind, label, seg, want_avg)
            else:
                answer = self._fact(periods[0], fieldname, kind, label, seg)
        elif metric is not None:
            fieldname, kind, label, _ct = metric
            if extremum:
                used_periods = all_q
                answer = self._extremum(all_q, fieldname, kind, label, minimum=minimum)
            elif len(periods) == 2:
                answer = self._pair_change(periods[0], periods[1], fieldname, kind, label)
            elif len(periods) > 2:
                answer = self._trend(periods, fieldname, kind, label, want_average=want_avg)
            else:
                answer = self._fact(periods[0], fieldname, kind, label)

        if answer is None:
            return None
        ids: list[str] = []
        for p in used_periods:
            qd = self.data.get(p)
            if qd:
                ids.extend(qd.source_ids)
        return answer, ids
