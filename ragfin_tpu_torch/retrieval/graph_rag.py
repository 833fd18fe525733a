"""Graph retrieval: question → entities → masked-gather strategies (C10-C12).

Rebuilds the reference's three graph query surfaces on the device-resident
fact store (:class:`ragfin_tpu_torch.index.graph_index.GraphIndex`):

- **Question entity extraction** (``graph_cons.py:483-739``): an LLM
  chain-of-thought path with the same output contract, plus a deterministic
  lexical matcher over the fixed entity vocabulary — the offline default
  (SURVEY.md §3.5 suggests exactly this: "a device entity-matcher over the
  fixed vocabulary").
- **Strategy dispatch** (``graph_cons.py:345-481``): the six strategy
  branches (segment×multi-quarter, metric×multi-quarter, single-quarter
  deep-dive, segment-all-quarters, metric-trend, keyword fallback), each
  lowering onto one masked-gather kernel call instead of a Cypher template.
- **LLM query planning** (``graph_rag_mcp/services/graph_service.py:65-256``):
  instead of generating Cypher for an external store, the LLM emits a small
  JSON *query plan* executed on device; invalid output falls back to the
  reference's fallback semantics (latest metrics, limit N).

Plus :class:`GraphBuilder` (C10): chunk loop → extraction → fact appends with
per-chunk failure accounting and text/structured auto-detection
(``graph_rag_mcp/tools/graph_tools.py:90-156``).
"""

from __future__ import annotations

import json
import re
from typing import Any, Optional, Sequence

from ..config.constants import FINANCIAL_ENTITY_TYPES, SUPPORTED_QUARTERS
from ..data.models import ExtractedEntities, FinancialChunk
from ..extraction.service import (
    EntityExtractor,
    RuleBasedExtractor,
    clean_llm_json,
    convert_structured_to_entities,
)
from ..index.graph_index import BALANCE, METRIC, RATIO, SEGMENT, GraphIndex, _period_key
from ..llm.providers import LLMProvider

# ---------------------------------------------------------------------------
# Question entity extraction
# ---------------------------------------------------------------------------

# Lexical surface → canonical entity (the vocabulary the reference's CoT
# prompt teaches its LLM; graph_cons.py:505-521 and the commented mapping
# table at :592-685 document the same aliases).
_QUARTER_ALIASES = {
    "q1": "Q1_FY2024", "first quarter": "Q1_FY2024",
    "q2": "Q2_FY2024", "second quarter": "Q2_FY2024",
    "q3": "Q3_FY2024", "third quarter": "Q3_FY2024",
    "q4": "Q4_FY2024", "fourth quarter": "Q4_FY2024",
}
_SEGMENT_ALIASES = {
    "retail": "RETAIL BANKING SEGMENT",
    "wholesale": "WHOLESALE BANKING SEGMENT",
    "corporate": "WHOLESALE BANKING SEGMENT",
    "treasury": "TREASURY SEGMENT",
    "insurance": "LIFE INSURANCE SEGMENT",
    "other segments": "OTHERS SEGMENT",
    "others segment": "OTHERS SEGMENT",
}
_METRIC_ALIASES = {
    "net profit": "NET PROFIT",
    "profit": "NET PROFIT",
    "net income": "NET PROFIT",
    "operating profit": "Operating Profit",
    "interest income": "Interest Income",
    "other income": "Other Income",
    "total income": "Total Income",
    "revenue": "Total Income",
    "total expenses": "Total Expenses",
    "interest expense": "Interest Expenses",
    "operating expenses": "Operating Expenses",
    "provisions": "Provisions",
}
_RATIO_ALIASES = {
    "basic eps": "Basic EPS",
    "diluted eps": "Diluted EPS",
    "eps": "Basic EPS",
    "earnings per share": "Basic EPS",
    "net margin": "Net Margin",
    "operating margin": "Operating Margin",
    "cost ratio": "Cost Ratio",
    "margin": "Net Margin",
    "profitability": "Net Margin",
}
_BALANCE_ALIASES = {
    "advances": "Advances", "loans": "Advances",
    "investments": "Investments",
    "deposits": "Customer Deposits",
    "total assets": "Total Assets",
    "assets": "Total Assets",
    "equity": "Total Equity",
    "cash": "Cash & RBI Balances",
    "borrowings": "Borrowings",
    "share capital": "Share Capital",
    "reserves": "Reserves & Surplus",
}

_COMPARATIVE = re.compile(r"\b(which|compare|comparison|best|worst|drove|ranking|rank|better|versus|vs)\b", re.I)
_ALL_QUARTERS = re.compile(
    r"\b(across|evolve|evolution|trend|over time|throughout|each quarter|all quarters|quarterly|every quarter|q1 to q4|from q1)\b",
    re.I,
)


def lexical_question_entities(question: str) -> list[dict[str, str]]:
    """Deterministic question → entity list (same contract as the LLM path:
    [{"name", "type"}] with types Quarter|Segment|Metric|Ratio|BalanceSheetItem)."""
    q = question.lower()
    entities: list[dict[str, str]] = []
    seen = set()

    def add(name: str, type_: str):
        key = (name, type_)
        if key not in seen:
            seen.add(key)
            entities.append({"name": name, "type": type_})

    # Year-aware quarter mapping: bare aliases default to the supported
    # year, but a question naming a fiscal year must NOT be silently
    # answered from another year's facts — an uncovered year yields no
    # quarter entity (the caller falls back instead of being wrong).
    years = re.findall(r"fy\s?(\d{4})", q)
    for alias, period in _QUARTER_ALIASES.items():
        if re.search(rf"\b{re.escape(alias)}\b", q):
            if years:
                qtag = period.split("_FY")[0]
                for y in years:
                    cand = f"{qtag}_FY{y}"
                    if cand in SUPPORTED_QUARTERS:
                        add(cand, "Quarter")
            else:
                add(period, "Quarter")
    mentions_all_segments = _COMPARATIVE.search(q) and re.search(r"\bsegments?\b|\bbusiness\b", q)
    for alias, name in _SEGMENT_ALIASES.items():
        if re.search(rf"\b{re.escape(alias)}\b", q):
            add(name, "Segment")
    if mentions_all_segments and not any(e["type"] == "Segment" for e in entities):
        for name in FINANCIAL_ENTITY_TYPES["business_segments"]:
            add(name, "Segment")
    # Longest-alias-first so "operating profit" wins over "profit"; matched
    # spans suppress their substrings but NOT co-mentioned entities ("interest
    # income and other income" must yield both metrics).
    def add_all(aliases: dict, etype: str) -> None:
        matched_spans: list[str] = []
        for alias, name in sorted(aliases.items(), key=lambda kv: -len(kv[0])):
            # Word-bounded: bare substring tests let "eps" match inside
            # "steps" and "profit" inside "profitability", polluting the
            # entity set and flipping strategy dispatch.
            if re.search(rf"\b{re.escape(alias)}\b", q) and not any(
                alias in span for span in matched_spans
            ):
                add(name, etype)
                matched_spans.append(alias)

    add_all(_METRIC_ALIASES, "Metric")
    add_all(_RATIO_ALIASES, "Ratio")
    add_all(_BALANCE_ALIASES, "BalanceSheetItem")
    if _ALL_QUARTERS.search(q) and not any(e["type"] == "Quarter" for e in entities):
        for period in SUPPORTED_QUARTERS:
            add(period, "Quarter")
    return entities


def build_question_entity_prompt(question: str) -> str:
    """CoT prompt with the reference's output contract (graph_cons.py:490-572)."""
    segments = ", ".join(FINANCIAL_ENTITY_TYPES["business_segments"])
    metrics = ", ".join(FINANCIAL_ENTITY_TYPES["financial_metrics"])
    ratios = ", ".join(FINANCIAL_ENTITY_TYPES["financial_ratios"])
    return (
        "You analyze financial questions about ICICI Bank FY2024 quarterly data.\n"
        f'Question: "{question}"\n\n'
        "Identify, step by step: (1) which quarters are referenced (map Q1/first "
        "quarter/... to Q1_FY2024..Q4_FY2024; comparative or trend questions that "
        "span quarters need every relevant quarter), (2) which business segments "
        f"(canonical names: {segments}; 'which segment'-style comparisons need all "
        f"five), (3) which metrics/ratios (canonical names: {metrics}; {ratios}).\n\n"
        "Answer with ONLY this JSON:\n"
        '{"reasoning": "...", "entities": [{"name": "<canonical name>", '
        '"type": "Quarter|Segment|Metric|Ratio|BalanceSheetItem"}]}\n'
    )


async def llm_question_entities(question: str, provider: LLMProvider) -> list[dict[str, str]]:
    """LLM path with lexical fallback on any failure (reference returns [])."""
    try:
        response = await provider.generate_content(build_question_entity_prompt(question))
        parsed = clean_llm_json(response)
        entities = (parsed or {}).get("entities", [])
        valid = [
            {"name": e["name"], "type": e["type"]}
            for e in entities
            if isinstance(e, dict) and e.get("name") and e.get("type")
        ]
        if valid:
            return valid
    except Exception:
        pass
    return lexical_question_entities(question)


# ---------------------------------------------------------------------------
# Strategy dispatch (C12)
# ---------------------------------------------------------------------------


def _question_companies(graph: GraphIndex, question: str) -> Optional[list[str]]:
    """Company scope for a graph query: the reference KG is single-tenant
    (one Organization node), so every Cypher strategy is implicitly scoped;
    a multi-company fact table must scope explicitly or another bank's facts
    crowd the limit-capped results (measured: strategy recall 0.975 → 0.55
    at 1M with 2k multi-company noise chunks before this scoping)."""
    from .queryfilter import company_for_question

    companies = list(getattr(graph, "_companies", []) or [])
    company = company_for_question(question, companies, default=graph.company)
    return [company] if company else None


def strategy_search(
    graph: GraphIndex,
    question: str,
    entities: Optional[list[dict[str, str]]] = None,
    limit: int = 30,
    companies: Optional[Sequence[str]] = None,
) -> dict[str, Any]:
    """Six-branch strategy dispatch (graph_cons.py:345-481 semantics).

    Returns {"strategy", "entities", "results"}; results capped at ``limit``
    (the reference's safety cap of 30). ``companies`` scopes the fact table
    (default: the company the question names, else the graph's default —
    reference parity, see :func:`_question_companies`).
    """
    if entities is None:
        entities = lexical_question_entities(question)
    if companies is None:
        companies = _question_companies(graph, question)
    quarters = [e["name"] for e in entities if e["type"] == "Quarter"]
    segments = [e["name"] for e in entities if e["type"] == "Segment"]
    metrics = [e["name"] for e in entities if e["type"] == "Metric"]
    ratios = [e["name"] for e in entities if e["type"] == "Ratio"]
    balance = [e["name"] for e in entities if e["type"] == "BalanceSheetItem"]

    results: list[dict] = []
    strategy = "pattern_fallback"

    # Implicit temporal scope: a question naming NO quarter/year means the
    # scoped company's latest fiscal year on record — the reference's
    # latest-metrics fallback convention (graph_service.py:249-256), the
    # same rule the vector pipeline applies (FilteredSearch
    # _latest_fy_periods). Without it, a multi-year fact store answers
    # "which quarter had the lowest cost ratio?" from whichever year's
    # facts happen to sit first in CSR order.
    latest_fy: Optional[list[str]] = None
    if not quarters:
        scope_quarters = None
        if companies:
            scope_quarters = set().union(
                *(graph.organizations.get(c, set()) for c in companies)
            )
        if not scope_quarters:
            scope_quarters = set(graph.quarters)
        years = sorted({p.split("_FY")[1] for p in scope_quarters if "_FY" in p})
        if years:
            latest_fy = sorted(
                p for p in scope_quarters if p.endswith(f"FY{years[-1]}")
            )

    # Extremum questions ("which quarter did X peak / hit its low") lower onto
    # the device aggregation kernel — an enhancement over the reference,
    # whose strategies could only list per-quarter rows (graph_cons.py TA05-
    # style questions fell through to vector retrieval).
    extremum = re.search(r"\b(peak|highest|best|maximum|lowest|worst|minimum|trough)\b", question, re.I)
    if extremum and (segments or metrics or ratios or balance) and not quarters:
        names = segments + metrics + ratios + balance
        types = [SEGMENT] if segments else None
        field = "aux" if (segments and re.search(r"margin", question, re.I)) else "value"
        agg = graph.aggregate(
            companies=companies, quarters=latest_fy, names=names, types=types, field=field
        )
        if agg:
            word = extremum.group(1).lower()
            key = "min" if word in ("lowest", "worst", "minimum", "trough") else "max"
            trend = graph.match(
                companies=companies, quarters=latest_fy, names=names, types=types, limit=limit
            )
            return {
                "strategy": "extremum_aggregate",
                "entities": entities,
                "results": [dict(agg[key], extremum=key, mean=agg["mean"])] + trend[: limit - 1],
            }

    if segments and len(quarters) > 1:
        strategy = "segment_multi_quarter"
        results = graph.match(companies=companies, quarters=quarters, names=segments, types=[SEGMENT], limit=limit)
    elif (metrics or ratios or balance) and len(quarters) > 1:
        strategy = "metric_multi_quarter"
        results = graph.match(companies=companies, 
            quarters=quarters, names=metrics + ratios + balance,
            types=[METRIC, RATIO, BALANCE], limit=limit,
        )
    elif len(quarters) == 1:
        strategy = "single_quarter_deep_dive"
        if segments:
            results += graph.match(companies=companies, quarters=quarters, names=segments, types=[SEGMENT], limit=limit)
        if metrics:
            results += graph.match(companies=companies, quarters=quarters, names=metrics, types=[METRIC], limit=limit)
        if ratios:
            results += graph.match(companies=companies, quarters=quarters, names=ratios, types=[RATIO], limit=limit)
        if balance:
            results += graph.match(companies=companies, quarters=quarters, names=balance, types=[BALANCE], limit=limit)
        if not (segments or metrics or ratios or balance):
            # Reference: headline metrics only for a bare quarter.
            results = graph.match(companies=companies, 
                quarters=quarters,
                names=["NET PROFIT", "Operating Profit", "Total Income"],
                types=[METRIC],
                limit=limit,
            )
    elif segments and not quarters:
        strategy = "segment_all_quarters"
        results = graph.match(
            companies=companies, quarters=latest_fy, names=segments,
            types=[SEGMENT], limit=limit,
        )
    elif (metrics or ratios or balance) and not quarters:
        strategy = "metric_trend"
        results = graph.match(
            companies=companies, quarters=latest_fy,
            names=metrics + ratios + balance, types=[METRIC, RATIO, BALANCE], limit=limit,
        )
    else:
        # Keyword pattern fallback (reference :459-472).
        if "retail" in question.lower() and re.search(r"compare|performance|across", question, re.I):
            results = graph.match(companies=companies, 
                names=["RETAIL BANKING SEGMENT"], types=[SEGMENT], limit=limit
            )
    return {"strategy": strategy, "entities": entities, "results": results[:limit]}


# ---------------------------------------------------------------------------
# LLM query planning (C11)
# ---------------------------------------------------------------------------

_TYPE_BY_NAME = {"metrics": METRIC, "segments": SEGMENT, "ratios": RATIO, "balance_sheet_items": BALANCE}


def build_plan_prompt(question: str, limit: int) -> str:
    vocab = {k: v for k, v in FINANCIAL_ENTITY_TYPES.items()}
    return (
        "Translate this ICICI Bank financial question into a JSON retrieval plan "
        "over a fact store keyed by quarter and entity name.\n"
        f'Question: "{question}"\n\n'
        f"Known quarters: {SUPPORTED_QUARTERS}\n"
        f"Known entity names by type: {json.dumps(vocab)}\n\n"
        "Reply with ONLY this JSON (no prose):\n"
        "{\n"
        '  "quarters": ["Q1_FY2024"],        // [] means all quarters\n'
        '  "names": ["NET PROFIT"],          // [] means all entities\n'
        '  "types": ["metrics"],             // subset of ["metrics","segments","ratios","balance_sheet_items"], [] = all\n'
        f'  "limit": {limit},\n'
        '  "compare": null                   // or {"name": "NET PROFIT", "from": "Q1_FY2024", "to": "Q4_FY2024"}\n'
        "}\n"
        "Use only canonical names from the lists. Trend/comparison questions "
        "across quarters leave quarters empty to get every quarter in order. "
        'Growth questions between two specific quarters set "compare" (the '
        "engine computes the growth percentage, like the reference's "
        "Growth_Pct Cypher pattern).\n"
    )


class GraphQueryEngine:
    """LLM-planned graph query with deterministic fallback (C11)."""

    def __init__(self, graph: GraphIndex, provider: Optional[LLMProvider] = None):
        self.graph = graph
        self.provider = provider

    def fallback_plan(self, limit: int) -> dict:
        """Reference fallback: LATEST-quarter metrics (graph_service.py:249-256).

        The latest quarter must be the match FILTER — an unfiltered match
        truncates at ``limit`` in chronological CSR order and would return
        the OLDEST quarters' metrics despite the quarter_desc sort."""
        quarters = sorted(self.graph.quarters, key=_period_key, reverse=True)[:1]
        return {"quarters": quarters, "names": [], "types": ["metrics"],
                "limit": limit, "order": "quarter_desc", "_fallback": True}

    def _execute(self, plan: dict, companies: Optional[Sequence[str]] = None) -> list[dict]:
        compare = plan.get("compare")
        if compare and compare.get("name") and compare.get("from") and compare.get("to"):
            return self._execute_compare(compare, companies=companies)
        types = [_TYPE_BY_NAME[t] for t in plan.get("types", []) if t in _TYPE_BY_NAME] or None
        results = self.graph.match(
            quarters=plan.get("quarters") or None,
            names=plan.get("names") or None,
            types=types,
            limit=int(plan.get("limit", 10)),
            companies=companies,
        )
        if plan.get("order") == "quarter_desc":
            results = sorted(results, key=lambda r: _period_key(r.get("quarter", "")), reverse=True)
        return results

    def _execute_compare(self, compare: dict, companies: Optional[Sequence[str]] = None) -> list[dict]:
        """Two-quarter growth computation (the reference's Growth_Pct Cypher
        pattern, graph_service.py:146-148)."""
        name, q_from, q_to = compare["name"], compare["from"], compare["to"]
        rows = self.graph.match(quarters=[q_from, q_to], names=[name], companies=companies)
        vals: dict[str, dict] = {}
        for r in rows:
            vals[r["quarter"]] = r
        out = [vals[q] for q in (q_from, q_to) if q in vals]
        if q_from in vals and q_to in vals:
            # .get(key, default) returns a STORED None without falling back
            # (_rows_to_dicts emits value=None for NaN facts) — coalesce on
            # None explicitly: `or` would treat a legitimately stored 0.0 as
            # missing and silently compute growth against the revenue field.
            v0 = vals[q_from].get("value")
            v0 = vals[q_from].get("revenue") if v0 is None else v0
            v1 = vals[q_to].get("value")
            v1 = vals[q_to].get("revenue") if v1 is None else v1
            if v0 is not None and v0 != 0 and v1 is not None:
                out.append(
                    {
                        "name": name,
                        "from": q_from,
                        "to": q_to,
                        "growth_pct": round((v1 - v0) / v0 * 100, 2),
                    }
                )
        return out

    async def query(self, question: str, limit: int = 10) -> dict[str, Any]:
        # Company scope for every execution path (reference parity: the KG's
        # Organization node makes its Cypher implicitly single-tenant).
        companies = _question_companies(self.graph, question)
        plan = None
        if self.provider is not None:
            try:
                response = await self.provider.generate_content(build_plan_prompt(question, limit))
                parsed = clean_llm_json(response)
                if parsed is not None and isinstance(parsed.get("quarters", []), list):
                    compare = parsed.get("compare")
                    plan = {
                        "quarters": [q for q in parsed.get("quarters", []) if isinstance(q, str)],
                        "names": [n for n in parsed.get("names", []) if isinstance(n, str)],
                        "types": [t for t in parsed.get("types", []) if t in _TYPE_BY_NAME],
                        "limit": min(int(parsed.get("limit", limit) or limit), 100),
                        "compare": compare if isinstance(compare, dict) else None,
                    }
            except Exception:
                plan = None
        if plan is None:
            # Deterministic planning from the lexical entity matcher.
            entities = lexical_question_entities(question)
            if entities:
                dispatch = strategy_search(self.graph, question, entities, limit=limit)
                if dispatch["results"]:
                    return {"plan": {"strategy": dispatch["strategy"]},
                            "results": dispatch["results"], "fallback": False}
                # Half-recognized question with no matching facts: retry
                # with the latest-metrics fallback, same as the LLM-plan
                # path (reference graph_service.py:249-256 semantics).
                fb = self.fallback_plan(limit)
                return {"plan": fb, "results": self._execute(fb, companies=companies), "fallback": True}
            plan = self.fallback_plan(limit)
        results = self._execute(plan, companies=companies)
        if not results:
            fb = self.fallback_plan(limit)
            results = self._execute(fb, companies=companies)
            return {"plan": fb, "results": results, "fallback": True}
        return {"plan": plan, "results": results, "fallback": bool(plan.get("_fallback"))}


# ---------------------------------------------------------------------------
# GraphBuilder (C10)
# ---------------------------------------------------------------------------


class GraphBuilder:
    """Chunk loop → extract → save with failure accounting (C10).

    ``extractor`` is any object with ``async extract(chunk) ->
    ExtractedEntities`` (LLM-backed EntityExtractor or the deterministic
    RuleBasedExtractor). Structured-format chunks (dicts with
    ``financialResults``) bypass the extractor (reference safe_chunk_processing,
    graph_tools.py:90-156).
    """

    def __init__(self, graph: Optional[GraphIndex] = None, extractor=None, provider: Optional[LLMProvider] = None):
        self.graph = graph if graph is not None else GraphIndex()
        if extractor is None:
            extractor = EntityExtractor(provider=provider) if provider is not None else RuleBasedExtractor()
        self.extractor = extractor
        self.query_engine = GraphQueryEngine(self.graph, provider)

    @property
    def current_model(self) -> str:
        return getattr(self.extractor, "current_model", "rule-based")

    def switch_extraction_model(self, model_name: str, api_key: Optional[str] = None) -> None:
        from ..extraction.service import EntityExtractor, RuleBasedExtractor

        if isinstance(self.extractor, RuleBasedExtractor):
            # RuleBasedExtractor.switch_model is a no-op (it has no LLM);
            # switching TO a real model must replace the extractor, or the
            # endpoint would report success while extraction stays
            # rule-based.
            self.extractor = EntityExtractor(model_name, api_key)
        else:
            self.extractor.switch_model(model_name, api_key)

    async def build(
        self,
        chunks: Sequence[FinancialChunk | dict],
        dataset_id: str = "icici_fy2024",
        clear_existing: bool = False,
        companies: Optional[Sequence[Optional[str]]] = None,
    ) -> dict[str, Any]:
        """``companies`` (optional, parallel to ``chunks``) scopes each
        chunk's facts to its owning company — FinancialChunk (reference
        pydantic parity) carries no company field, so without the hint a
        multi-company bootstrap would conflate every bank's figures under
        the graph's default company."""
        if clear_existing:
            self.graph.clear_data(dataset_id)
        processed = failed = total_entities = 0
        failed_chunks: list[str] = []
        for pos, chunk in enumerate(chunks):
            chunk_id = chunk.get("id", "?") if isinstance(chunk, dict) else chunk.id
            try:
                entities, company = await self._extract_any(chunk)
                if company is None and companies is not None:
                    company = companies[pos]
                if not entities.quarter:
                    failed += 1
                    failed_chunks.append(chunk_id)
                    continue
                self.graph.save_entities(entities, chunk_id, dataset_id, company_name=company)
                processed += 1
                total_entities += entities.total_count()
            except Exception:
                failed += 1
                failed_chunks.append(chunk_id)
        return {
            "success": True,
            "chunks_processed": processed,
            "chunks_failed": failed,
            "total_entities_created": total_entities,
            "dataset_id": dataset_id,
            "failed_chunk_ids": failed_chunks,
        }

    async def _extract_any(self, chunk) -> tuple[ExtractedEntities, Optional[str]]:
        if isinstance(chunk, dict) and "financialResults" in chunk:
            return convert_structured_to_entities(chunk)
        if isinstance(chunk, dict):
            chunk = FinancialChunk.model_validate(chunk)
        return await self.extractor.extract(chunk), None

    def build_from_vector_index(self, vector_index, dataset_id: str = "icici_fy2024"):
        """Bootstrap the KG from the vector store — the reference's de-facto
        resume path (graph_cons.py:34-53). Each record's company scopes its
        facts (without it a multi-company store conflates every bank's
        figures under the default company)."""
        import asyncio

        records = list(vector_index.records)
        chunks = [r.to_financial_chunk() for r in records]
        companies = [getattr(r, "company", None) for r in records]
        return asyncio.run(self.build(chunks, dataset_id=dataset_id, companies=companies))

    async def query(self, question: str, limit: int = 10) -> list[dict]:
        return (await self.query_engine.query(question, limit))["results"]

    def is_healthy(self) -> bool:
        return self.graph.health_check()

    def get_stats(self) -> dict:
        return self.graph.stats()

    def clear(self, dataset_id: Optional[str] = None) -> None:
        self.graph.clear_data(dataset_id)
