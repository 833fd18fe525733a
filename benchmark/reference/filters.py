"""Frozen copy of the question-scoping rules of the production path.

The period, chunk-type and company parsing of ``retrieval/queryfilter.py``,
the financial-idiom expansion it parses (``models/synonyms.py``), and the
tier-group plan that ``FilteredSearch`` builds from them: (company, periods,
type) beside (company, periods), then (company), then unscoped, a question
with no year taking its company's latest fiscal year. Copied so that the
reference derives each question's scope without the program's code.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

LEXICON: dict[str, str] = {
    # profit / income-statement idioms
    "bottom line": "net profit",
    "net earnings": "net profit",
    "profit after tax": "net profit",
    "after tax profit": "net profit",
    "after taxes": "net profit",
    "pat": "net profit",
    "earnings": "profit",
    "top line": "total income revenue",
    "turnover": "revenue income",
    "sales": "revenue",
    "brought in": "revenue",
    "nii": "interest income",
    "net interest income": "interest income",
    "fee income": "other income",
    "lucrative": "profit margin",
    "profitable": "profit margin",
    "profitability": "profit margin",
    "money made": "profit",
    "made money": "profit",
    # cost idioms
    "spending": "expenses",
    "expenditure": "expenses",
    "outgoings": "expenses",
    "opex": "operating expenses",
    "overheads": "operating expenses",
    "cost to income": "cost ratio",
    "cost-to-income": "cost ratio",
    "expense to income": "cost ratio",
    "expense-to-income": "cost ratio",
    "efficiency ratio": "cost ratio",
    # balance-sheet idioms
    "loan book": "advances",
    "loans": "advances",
    "lending": "advances",
    "credit growth": "advances growth",
    "parked": "deposits",
    "deposited": "deposits",
    "casa": "deposits",
    "borrowed funds": "borrowings",
    "net worth": "equity reserves",
    "shareholder funds": "equity",
    "shareholders equity": "equity",
    "shareholders' equity": "equity",
    "balance sheet size": "total assets",
    "book value": "equity",
    # per-share
    "per share earnings": "eps",
    "per-share earnings": "eps",
    "earnings per share": "eps",
    # segments (standard Indian-bank reporting aliases)
    "business line": "segment",
    "business lines": "segment",
    "business unit": "segment",
    "business units": "segment",
    "division": "segment",
    "divisions": "segment",
    "verticals": "segment",
    "corporate banking": "wholesale banking segment",
    "institutional banking": "wholesale banking segment",
    "consumer banking": "retail banking segment",
    "insurance business": "life insurance segment",
    "markets business": "treasury segment",
    # sell-side shorthand (standard Indian-market research abbreviations;
    # single-token so they only fire on whole words — "adv" never matches
    # inside "advances")
    "seg": "segment",
    "rev": "revenue",
    "dep": "deposits",
    "adv": "advances",
    "tot": "total",
    "inc": "income",
    "prov": "provisions",
    "c/i": "cost ratio",
    "c/i ratio": "cost ratio",
    "cost income ratio": "cost ratio",
    # time idioms
    "three-month": "quarter",
    "three month": "quarter",
    "three months": "quarter",
    "3-month": "quarter",
    "stretch": "quarter",
    # growth / trend idioms
    "expand": "growth",
    "expanded": "growth",
    "expansion": "growth",
    "grew": "growth",
    "rise": "growth",
    "rose": "growth",
    "increase": "growth",
    "increased": "growth",
    "moved": "trend",
    "evolve": "trend",
    "evolved": "trend",
    "develop": "trend",
    "trajectory": "trend growth",
    "overall": "total",
}


_PATTERNS = [
    (re.compile(rf"\b{re.escape(k)}\b", re.IGNORECASE), v)
    for k, v in sorted(LEXICON.items(), key=lambda kv: -len(kv[0]))
]


def expand_query(text: str) -> str:
    additions: list[str] = []
    seen = set()
    for pat, expansion in _PATTERNS:
        if pat.search(text) and expansion not in seen:
            seen.add(expansion)
            additions.append(expansion)
    if not additions:
        return text
    return text + " ; " + " ; ".join(additions)


_ORDINALS = {
    "first": 1, "1st": 1,
    "second": 2, "2nd": 2,
    "third": 3, "3rd": 3,
    "fourth": 4, "4th": 4, "last": 4, "final": 4,
}

# Calendar month -> (fiscal quarter, fiscal-year offset from the calendar
# year). Indian fiscal convention, same mapping the reference chunker uses
# for its period->month keys (chunking_storing (1).py:77-89): FY2024 spans
# Apr 2023 - Mar 2024, so "June 2023" is Q1 FY2024 (offset +1) and
# "March 2024" is Q4 FY2024 (offset 0).
_MONTH_QUARTER = {
    "april": (1, 1), "apr": (1, 1), "may": (1, 1), "june": (1, 1), "jun": (1, 1),
    "july": (2, 1), "jul": (2, 1), "august": (2, 1), "aug": (2, 1),
    "september": (2, 1), "sept": (2, 1), "sep": (2, 1),
    "october": (3, 1), "oct": (3, 1), "november": (3, 1), "nov": (3, 1),
    "december": (3, 1), "dec": (3, 1),
    "january": (4, 0), "jan": (4, 0), "february": (4, 0), "feb": (4, 0),
    "march": (4, 0), "mar": (4, 0),
}
_MONTH_YEAR = re.compile(
    r"\b(" + "|".join(_MONTH_QUARTER) + r")\s+(\d{4})\b"
)

# Chunk-type hints, checked in order (first match wins); multi-topic
# questions (rankings across segments etc.) get no type filter.
_TYPE_HINTS = [
    ("segment_analysis", ("segment", "retail banking", "wholesale", "treasury",
                          "life insurance", "business line")),
    ("balance_sheet_analysis", ("deposit", "balance sheet", "asset", "equity",
                                "advances", "borrowing", "reserves", "capital position")),
    ("financial_ratios", ("eps", "earnings per share", "per share")),
    ("profitability_analysis", ("profit", "income", "margin", "cost ratio",
                                "expense", "provision", "profitability", "earnings")),
]



def extract_filters(question: str, known_periods: Sequence[str]) -> tuple[list, Optional[str]]:
    """Parse period/type constraints from a question.

    ``known_periods`` is the corpus's period vocabulary; only periods that
    actually exist become filters (a question about an uncovered year yields
    no filter rather than an empty result set).
    """
    ql = question.lower()
    years_vocab = sorted({p.split("_FY")[1] for p in known_periods if "_FY" in p})
    known = set(known_periods)

    def full_year(y: str) -> list[str]:
        """2-digit fiscal years ("FY24") resolve against the corpus's year
        vocabulary; 4-digit years pass through."""
        if len(y) == 4:
            return [y]
        return [v for v in years_vocab if v.endswith(y)]

    # Explicit quarter+year pairs first ("Q4 FY2024", "FY2024 Q4",
    # "Q2 of/in FY2024", and the Indian-market compact forms "Q1FY24" /
    # "3QFY24") so multi-year comparisons keep each quarter with ITS year;
    # the matched spans are cut out before leftover parsing.
    pairs: list[tuple[int, str]] = []
    spans: list[tuple[int, int]] = []
    def relative_shift(pos: int) -> int:
        """±1 fiscal-quarter shift for temporal-offset phrases preceding a
        period mention: "the quarter (right) after June 2023" means Q2, not
        the June quarter itself; "the quarter before Q3 FY2024" means Q2."""
        prefix = ql[:pos]
        if re.search(r"\b(?:quarter|quater|qtr|period)\s+(?:right\s+|immediately\s+|just\s+)?(?:after|following)\s*$", prefix):
            return 1
        if re.search(r"\b(?:quarter|quater|qtr|period)\s+(?:right\s+|immediately\s+|just\s+)?(?:before|preceding|prior\s+to)\s*$", prefix):
            return -1
        return 0

    def shifted(qn: int, y: str, shift: int) -> tuple[int, str]:
        if not shift:
            return qn, y
        qn += shift
        if qn > 4:
            return 1, str(int(y) + 1)
        if qn < 1:
            return 4, str(int(y) - 1)
        return qn, y

    for pat, qg, yg in (
        (r"\bq([1-4])\s*(?:of|in|for)?[\s_-]*(?:fy|fiscal)\s?(\d{4}|\d{2})\b", 1, 2),
        (r"\b([1-4])q[\s_-]*(?:fy|fiscal)\s?(\d{4}|\d{2})\b", 1, 2),
        (r"\b(?:fy|fiscal)\s?(\d{4})\s*(?:,)?[\s_-]*q([1-4])\b", 2, 1),
    ):
        for m in re.finditer(pat, ql):
            shift = relative_shift(m.start())
            for y in full_year(m.group(yg)):
                pairs.append(shifted(int(m.group(qg)), y, shift))
            spans.append(m.span())
    # Calendar month+year mentions ("the June 2023 quarter", "quarter ending
    # September 2023") map through the fiscal calendar. "may" doubles as an
    # English modal ("how much may 2024 bring?") — accept it as a month only
    # when the original question capitalizes it.
    for m in _MONTH_YEAR.finditer(ql):
        if m.group(1) == "may" and question[m.start():m.start() + 1] != "M":
            continue
        qn, offset = _MONTH_QUARTER[m.group(1)]
        pairs.append(shifted(qn, str(int(m.group(2)) + offset), relative_shift(m.start())))
        spans.append(m.span())
    residual = list(ql)
    for a, b in spans:
        residual[a:b] = " " * (b - a)
    residual = "".join(residual)

    rest_years = [
        y
        for raw in dict.fromkeys(re.findall(r"(?:fy|fiscal)\s?(\d{4}|\d{2})\b", residual))
        for y in full_year(raw)
    ]
    rest_years = list(dict.fromkeys(rest_years))
    rest_qnums = [int(n) for n in re.findall(r"\bq([1-4])\b", residual)]
    # "second quarter" / "4th qtr" / the common "quater" typo, plus the
    # "first|final three months" idiom.
    for word, num in _ORDINALS.items():
        if re.search(rf"\b{word}\s+(?:quarter|quater|qtr)", residual):
            rest_qnums.append(num)
        if re.search(rf"\b{word}\s+three\s+months", residual):
            rest_qnums.append(num)
    # Half-year convention: H1/first half = Q1+Q2, H2/second half = Q3+Q4.
    # A comparative ellipsis ("the second half ... than the first") names
    # BOTH halves — the elided half must stay in scope (recall-safety).
    halves = set()
    if re.search(r"\b(?:h1|1h|first\s+half)\b", residual):
        halves.add(1)
    if re.search(r"\b(?:h2|2h|second\s+half|latter\s+half)\b", residual):
        halves.add(2)
    if halves and re.search(r"\b(?:than|vs|versus|against|over)\s+the\s+(?:first|second|other)\b", residual):
        halves = {1, 2}
    if 1 in halves:
        rest_qnums += [1, 2]
    if 2 in halves:
        rest_qnums += [3, 4]
    rest_qnums = list(dict.fromkeys(rest_qnums))

    periods: list[str] = [f"Q{n}_FY{y}" for n, y in dict.fromkeys(pairs)]
    if rest_qnums:
        if rest_years:
            # Loose quarters pair with every mentioned year (recall-safe).
            periods += [f"Q{n}_FY{y}" for y in rest_years for n in rest_qnums]
        elif pairs:
            periods += [
                f"Q{n}_FY{y}" for y in dict.fromkeys(y for _, y in pairs)
                for n in rest_qnums
            ]
        elif len(years_vocab) == 1:
            # Quarter named without any year, in a single-year corpus.
            periods += [f"Q{n}_FY{years_vocab[0]}" for n in rest_qnums]
    else:
        # Year(s) named without a quarter (trend questions): all quarters.
        for y in rest_years:
            periods += [p for p in known_periods if p.endswith(f"FY{y}")]
    periods = [p for p in dict.fromkeys(periods) if p in known]

    # First match wins; _TYPE_HINTS is ordered most-specific-first (segment
    # words beat the generic profit/income vocabulary). The hint is a
    # ranking prior, not a hard filter: FilteredSearch always fetches the
    # untyped sibling tier too (see its docstring for the semantics).
    chunk_type = None
    for ctype, words in _TYPE_HINTS:
        if any(w in ql for w in words):
            chunk_type = ctype
            break

    return periods, chunk_type


# Words too generic to identify a company on their own ("Bank of Baroda"
# must not claim every question containing "bank").
_GENERIC_NAME_TOKENS = frozenset(
    {"bank", "banking", "the", "of", "and", "india", "indian", "state",
     "national", "life", "general", "limited", "ltd", "finance",
     "financial", "services", "capital", "group", "corp", "corporation"}
)


def company_for_question(
    question: str, companies: Sequence[str], default: Optional[str] = None
) -> Optional[str]:
    """Resolve which company a question is about (shared by the vector
    pipeline's scoping and the graph strategy dispatch — reference parity:
    both its Milvus collection and its KG Organization node are single-
    tenant, so every question is implicitly scoped; a multi-company store
    must scope explicitly or conflate banks).

    Full-name match first (most tokens wins), then a distinctive token
    exactly one company owns; otherwise ``default``. A single-company list
    returns None (no mask needed)."""
    companies = list(companies)
    if len(companies) <= 1:
        return None
    qtokens = set(re.findall(r"[a-z0-9&]+", question.lower()))
    for c in sorted(companies, key=lambda c: -len(c.split())):
        toks = [t.lower() for t in c.split()]
        if all(t in qtokens for t in toks):
            return c
    owners: dict[str, set] = {}
    for c in companies:
        for t in set(c.lower().split()) - _GENERIC_NAME_TOKENS:
            owners.setdefault(t, set()).add(c)
    for t, cs in owners.items():
        if t in qtokens and len(cs) == 1:
            return next(iter(cs))
    return default


def tier_groups(question: str, known_periods: Sequence[str], companies: Sequence[str],
                by_company: dict, default_company: Optional[str] = "ICICI Bank",
                use_type_hint: bool = True) -> list[list[dict]]:
    """The question's tier groups, most specific first; each tier a filter
    dict of ``periods``, ``chunk_type`` and ``company``."""
    periods, chunk_type = extract_filters(expand_query(question), known_periods)
    company = company_for_question(question, companies, default_company)
    scoped_periods = by_company.get(company, set()) if company else known_periods
    latest = None
    if not periods:
        years = sorted({p.split("_FY")[1] for p in scoped_periods if "_FY" in p})
        if years:
            latest = sorted(p for p in scoped_periods if p.endswith(f"FY{years[-1]}"))
    groups: list[list[dict]] = []
    scoped: list[dict] = []
    if chunk_type and use_type_hint:
        scoped.append(dict(periods=periods or latest or None, chunk_type=chunk_type, company=company))
    if periods:
        scoped.append(dict(periods=periods, company=company))
    elif latest:
        scoped.append(dict(periods=latest, company=company))
    if scoped:
        groups.append(scoped)
    if company is not None:
        groups.append([dict(company=company)])
    groups.append([{}])
    return groups
