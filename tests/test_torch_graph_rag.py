"""The port's graph retrieval layer (copied pure Python over the torch
graph store) against the JAX package's: question entities, every strategy
of ``strategy_search``, the LLM-planned ``GraphQueryEngine`` with a
``FakeProvider``, and ``GraphBuilder`` with failures and the structured
path. All outputs are equal dicts (the only floats are fact values read
from the same host columns, and the aggregate's mean, within 1e-5
relative)."""

import asyncio
import json

import pytest

from ragfin_tpu.extraction import service as JS
from ragfin_tpu.index.graph_index import GraphIndex as JGraph
from ragfin_tpu.llm.providers import FakeProvider as JFake
from ragfin_tpu.retrieval import graph_rag as JR
from ragfin_tpu_torch.eval.distractors import generate_distractors
from ragfin_tpu_torch.extraction import service as TS
from ragfin_tpu_torch.index.graph_index import GraphIndex as TGraph
from ragfin_tpu_torch.llm.providers import FakeProvider as TFake
from ragfin_tpu_torch.retrieval import graph_rag as TR

QUESTIONS = [
    "What was HDFC Bank's net profit in Q1 FY2024?",
    "How did Axis Bank's retail segment do across all quarters?",
    "Compare SBI's net profit in Q1 and Q3 FY2024",
    "Which quarter did Kotak Bank's cost ratio hit its lowest?",
    "Which segment of HDFC Bank had the highest margin?",
    "How did retail and treasury do in Q2 and Q4 for Axis Bank?",
    "What were Yes Bank's deposits and advances trend?",
    "Tell me about Q2",
    "interest income and other income in the first quarter",
    "steps to improve profitability",
    "Compare retail performance",
    "hello there",
]


def _mean_close(a, b):
    """Equal results; a row's ``mean`` (an f32 device sum) within 1e-5."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = dict(x), dict(y)
        if "mean" in x or "mean" in y:
            assert x.pop("mean") == pytest.approx(y.pop("mean"), rel=1e-5)
        assert x == y


@pytest.fixture(scope="module")
def filings():
    return generate_distractors(600, seed=11)


@pytest.fixture(scope="module")
def graphs(filings):
    t, j = TGraph(device="cpu"), JGraph()
    for r in filings:
        t.save_entities(TS.rule_based_extract(r.text), r.id, company_name=r.company)
        j.save_entities(JS.rule_based_extract(r.text), r.id, company_name=r.company)
    return t, j


@pytest.mark.parametrize("question", QUESTIONS)
def test_lexical_question_entities(question):
    assert TR.lexical_question_entities(question) == JR.lexical_question_entities(question)


@pytest.mark.parametrize("question", QUESTIONS)
def test_strategy_search(graphs, question):
    t, j = graphs
    got, want = TR.strategy_search(t, question), JR.strategy_search(j, question)
    assert got["strategy"] == want["strategy"] and got["entities"] == want["entities"]
    _mean_close(got["results"], want["results"])


def test_every_strategy_is_reached(graphs):
    t, _ = graphs
    seen = {TR.strategy_search(t, q)["strategy"] for q in QUESTIONS}
    assert seen >= {
        "single_quarter_deep_dive", "segment_all_quarters", "metric_multi_quarter",
        "extremum_aggregate", "segment_multi_quarter", "metric_trend", "pattern_fallback",
    }
    assert any(TR.strategy_search(t, q)["results"] for q in QUESTIONS[:7])


def test_llm_question_entities_with_fallback():
    reply = json.dumps({"reasoning": "r", "entities": [{"name": "NET PROFIT", "type": "Metric"}, {"bad": 1}]})
    for canned in ([(".*", reply)], [(".*", "not json")]):
        got = asyncio.run(TR.llm_question_entities("net profit in q1", TFake(canned=canned)))
        want = asyncio.run(JR.llm_question_entities("net profit in q1", JFake(canned=canned)))
        assert got == want


PLANS = {
    "valid": {"quarters": ["Q1_FY2024", "Q2_FY2024"], "names": ["NET PROFIT"], "types": ["metrics"], "limit": 5},
    "invalid": "I cannot answer that",
    "wrong_shape": {"quarters": "Q1_FY2024"},
    "no_match": {"quarters": ["Q1_FY1999"], "names": ["NET PROFIT"], "types": ["metrics"]},
    "compare": {"quarters": [], "names": [], "types": [], "compare":
                {"name": "NET PROFIT", "from": "Q1_FY2024", "to": "Q4_FY2024"}},
}


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("question", [
    "What was HDFC Bank's net profit growth from Q1 to Q4?", "hello there",
])
def test_graph_query_engine_with_fake_provider(graphs, plan, question):
    t, j = graphs
    reply = PLANS[plan] if isinstance(PLANS[plan], str) else json.dumps(PLANS[plan])
    got = asyncio.run(TR.GraphQueryEngine(t, TFake(canned=[(".*", reply)])).query(question, limit=8))
    want = asyncio.run(JR.GraphQueryEngine(j, JFake(canned=[(".*", reply)])).query(question, limit=8))
    assert got["plan"] == want["plan"] and got["fallback"] == want["fallback"]
    _mean_close(got["results"], want["results"])


@pytest.mark.parametrize("question", QUESTIONS[:4] + ["hello there"])
def test_graph_query_engine_offline(graphs, question):
    t, j = graphs
    got = asyncio.run(TR.GraphQueryEngine(t).query(question))
    want = asyncio.run(JR.GraphQueryEngine(j).query(question))
    assert got["plan"] == want["plan"] and got["fallback"] == want["fallback"]
    _mean_close(got["results"], want["results"])


STRUCTURED = {
    "company": "axis_bank_results.pdf",
    "periods": {"march2024": {}},
    "financialResults": {
        "income": {"interestEarned": {"march2024": "1,0".replace(",", ""), "march2023": 9.5}, "bad": 3},
        "profitAndLoss": {"netProfitForThePeriod": {"march2024": 7.0, "x": "n/a"}},
        "ratios": {"Return on assets %": {"march2024": 1.8}, "Debt equity": {"march2024": "0.9"}},
    },
}


def _build_inputs(filings):
    chunks = [r.to_financial_chunk() for r in filings[:40]]
    dicts = [c.model_dump() for c in chunks[:5]]
    return (
        chunks[5:]
        + dicts
        + [
            {"id": "bad_period", "period": "FY24", "type": "t", "size": 20, "text": "x" * 20},
            {"id": "short_text", "period": "Q1_FY2024", "type": "t", "size": 3, "text": "abc"},
            {"id": "no_quarter", "period": "Q1_FY2024", "type": "t", "size": 30,
             "text": "NET PROFIT: ₹12 crore and nothing else here"},
            STRUCTURED,
            {"financialResults": {}, "company": "unknown"},
        ]
    )


def test_graph_builder_build_with_failures_and_structured(filings):
    t_chunks = _build_inputs(filings)
    from ragfin_tpu.data.models import FinancialChunk as JChunk

    j_chunks = [JChunk(**c.model_dump()) if not isinstance(c, dict) else c for c in t_chunks]
    companies = [r.company for r in filings[5:40]] + [None] * (len(t_chunks) - 35)
    tb = TR.GraphBuilder(TGraph(device="cpu"))
    jb = JR.GraphBuilder(JGraph())
    got = asyncio.run(tb.build(t_chunks, dataset_id="d", companies=companies))
    want = asyncio.run(jb.build(j_chunks, dataset_id="d", companies=companies))
    assert got == want
    assert got["chunks_failed"] >= 4 and got["chunks_processed"] >= 36
    assert tb.get_stats() == jb.get_stats()
    assert tb.graph.match(limit=1000) == jb.graph.match(limit=1000)
    assert tb.graph.match(companies=["Axis Bank"], names=["Interest Income"]) == \
        jb.graph.match(companies=["Axis Bank"], names=["Interest Income"])
    assert tb.current_model == jb.current_model == "rule-based"
    again = asyncio.run(tb.build(t_chunks[:3], dataset_id="d", clear_existing=True))
    assert again == asyncio.run(jb.build(j_chunks[:3], dataset_id="d", clear_existing=True))
    assert tb.get_stats() == jb.get_stats()


def test_llm_extractor_through_fake_provider(filings):
    """The LLM extraction path: a reply with numeric strings, an item missing
    its required field (filtered), and one whose nested record is invalid
    (the whole extraction comes back empty)."""
    chunk = filings[0].to_financial_chunk()
    good = json.dumps({
        "quarter": "Q1_FY2024",
        "financial_metrics": [{"name": "NET PROFIT", "value": "10636.0", "growth_yoy": 44}, {"name": "x"}],
        "financial_ratios": [{"name": "Net Margin", "value": 20.4, "unit": "percentage"}],
    })
    bad = json.dumps({"quarter": "Q1_FY2024", "business_segments": [{"name": "RETAIL", "revenue": 5}]})
    from ragfin_tpu.data.models import FinancialChunk as JChunk

    for reply in (good, "```json\n" + good + "\n```", bad, "no json"):
        got = asyncio.run(TS.EntityExtractor(provider=TFake(canned=[(".*", reply)])).extract(chunk))
        want = asyncio.run(JS.EntityExtractor(provider=JFake(canned=[(".*", reply)])).extract(JChunk(**chunk.model_dump())))
        assert got.model_dump() == want.model_dump()
    assert got.total_count() == 0


def test_convert_structured_to_entities():
    (te, tc), (je, jc) = TS.convert_structured_to_entities(STRUCTURED), JS.convert_structured_to_entities(STRUCTURED)
    assert tc == jc == "Axis Bank" and te.model_dump() == je.model_dump()
    assert te.quarter == "Q4_FY2024" and te.total_count() >= 4
