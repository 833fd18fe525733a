"""The eval harness, answer scoring and graph arms over both packages'
engines, and the engines' ``health()``, on one generated corpus.

Both engines are built from the same generated ``extract_data`` tree with the
trained encoder (the port on ``device="cpu"``). Reports must be equal apart
from latencies. The harness scores ids against labels, and the two encoders
differ by up to 6e-4 in a score (``tests/test_torch_engine.py``): the best
hit of every question is the same, while two lower-ranked chunks of nearly
equal score may swap places, which moves no metric of these reports. The pure
functions (scoring, tie-aware agreement, number matching) are copies and must
agree exactly.
"""

import asyncio
import json

import numpy as np
import pytest

from ragfin_tpu.config.settings import Settings as JSettings
from ragfin_tpu.eval import answers as j_answers
from ragfin_tpu.eval import datasets as j_datasets
from ragfin_tpu.eval import graph_arms as j_arms
from ragfin_tpu.eval import harness as j_harness
from ragfin_tpu.retrieval.queryfilter import FilteredSearch as JFiltered
from ragfin_tpu.serving.engine import RagFinEngine as JEngine
from ragfin_tpu_torch.config.settings import Settings as TSettings
from ragfin_tpu_torch.eval import answers as t_answers
from ragfin_tpu_torch.eval import datasets as t_datasets
from ragfin_tpu_torch.eval import graph_arms as t_arms
from ragfin_tpu_torch.eval import harness as t_harness
from ragfin_tpu_torch.eval.statements import write_extract_data
from ragfin_tpu_torch.retrieval.queryfilter import FilteredSearch as TFiltered
from ragfin_tpu_torch.serving.engine import RagFinEngine as TEngine

TIMING_KEYS = ("latency", "time", "qps", "date")


def strip(doc):
    """Drop every timing entry of a report."""
    if isinstance(doc, dict):
        return {k: strip(v) for k, v in doc.items() if not any(t in k.lower() for t in TIMING_KEYS)}
    if isinstance(doc, list):
        return [strip(v) for v in doc]
    return doc


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    tree = write_extract_data(str(root / "extract_data"), seed=44)
    jeng = JEngine(JSettings(default_model="fake", data_dir=tree, index_dir="", batch_queries=False))
    teng = TEngine(
        TSettings(default_model="fake", data_dir=tree, index_dir="", batch_queries=False),
        device="cpu",
    )
    texts = {c.id: c.text for c in teng.chunks}
    kinds = {
        "net profit": "profitability_analysis", "total customer deposits": "balance_sheet_health",
        "basic EPS": "key_ratios", "retail banking segment revenue": "segment_performance",
    }
    questions = []
    for n in range(1, 5):
        for topic, kind in kinds.items():
            cid = f"icici_q{n}_fy2024_{kind}"
            figure = next(t for t in texts[cid].replace(",", "").split() if t.lstrip("₹").replace(".", "").isdigit())
            questions.append({
                "id": f"q{n}_{kind}", "category": kind, "question": f"What was ICICI Bank's {topic} in Q{n} FY2024?",
                "expected_relevant_chunks": [cid],
                "ground_truth_answer": f"It was {figure.lstrip('₹')} crore in Q{n} FY2024.",
                "key_supporting_facts": [],
            })
    (root / "qa.json").write_text(json.dumps({"questions": questions}))
    (root / "vector.json").write_text(json.dumps({"evaluation_questions": [
        {"id": q["id"], "category": q["category"], "question": q["question"], "difficulty": "easy",
         "expected_chunks": [f"Q{q['id'][1]}_FY2024_profitability_analysis"], "expected_answer": ""}
        for q in questions[::4]
    ]}))
    yield {"root": root, "jeng": jeng, "teng": teng}
    jeng.close()
    teng.close()


def test_dataset_loaders_equal(setup):
    root = setup["root"]
    for name, loader in (("qa.json", "load_qa_subset"), ("vector.json", "load_vector_eval")):
        got = getattr(t_datasets, loader)(str(root / name))
        want = getattr(j_datasets, loader)(str(root / name))
        assert [vars(q) for q in got] == [vars(q) for q in want] and got
    got, want = t_datasets.load_holdout_phrasings(), j_datasets.load_holdout_phrasings()
    assert [vars(q) for q in got] == [vars(q) for q in want] and len(got) > 10
    for label in ("Q1_FY2024_profitability_analysis", "icici_x", "Q3_FY2024_financial_ratios", "odd"):
        assert t_datasets.normalize_chunk_label(label) == j_datasets.normalize_chunk_label(label)


@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("pipeline", ["raw", "filtered"])
def test_evaluate_retrieval_equal(setup, k, pipeline):
    qj = j_datasets.load_qa_subset(str(setup["root"] / "qa.json"))
    qt = t_datasets.load_qa_subset(str(setup["root"] / "qa.json"))
    sj, st = setup["jeng"].vector_index, setup["teng"].vector_index
    if pipeline == "filtered":
        sj, st = JFiltered(sj), TFiltered(st)
    rj = j_harness.evaluate_retrieval(sj, qj, k=k, batch_size=5)
    rt = t_harness.evaluate_retrieval(st, qt, k=k, batch_size=5)
    assert strip(rt.summary()) == strip(rj.summary())
    assert [r.retrieved[0] for r in rt.results] == [r.retrieved[0] for r in rj.results]
    assert [len(r.retrieved) for r in rt.results] == [len(r.retrieved) for r in rj.results]
    assert strip(t_harness.to_research_summary(rt)) == strip(j_harness.to_research_summary(rj))
    if pipeline == "filtered":
        assert rt.summary()["retrieval_recall"]["mean"] == 1.0


def test_score_retrieval_and_tie_aware_agreement_equal():
    rng = np.random.default_rng(0)
    for _ in range(20):
        expected = [f"c{i}" for i in rng.choice(12, rng.integers(0, 4), replace=False)]
        retrieved = [f"c{i}" for i in rng.choice(12, rng.integers(0, 6), replace=False)]
        assert t_harness.score_retrieval(expected, retrieved) == j_harness.score_retrieval(expected, retrieved)
    exact = [[(f"c{i}", float(s)) for i, s in enumerate(sorted(rng.choice([0.9, 0.8, 0.8, 0.7], 14), reverse=True))]
             for _ in range(6)]
    approx = [[f"c{i}" for i in rng.choice(14, 12, replace=False)] for _ in range(6)]
    for kwargs in ({}, {"k": 5}, {"k": 5, "wide": 14}, {"eps": 0.11}):
        assert t_harness.tie_aware_agreement(exact, approx, **kwargs) == \
            j_harness.tie_aware_agreement(exact, approx, **kwargs)


def test_answer_scoring_functions_equal():
    texts = [
        "Net profit was ₹10,636 crore (+44.0% YoY) and EPS ₹13.86.", "no figures here",
        "Total income of Rs. 42,569.1 crore; margin 19.9%; 2,345 and 1e3", "",
    ]
    for a in texts:
        assert t_answers.extract_numbers(a) == j_answers.extract_numbers(a)
        assert t_answers.extract_figures(a) == j_answers.extract_figures(a)
        for b in texts:
            assert t_answers.answer_accuracy(a, b) == j_answers.answer_accuracy(a, b)
            assert t_answers.token_overlap(a, b) == j_answers.token_overlap(a, b)
            assert t_answers.faithfulness(a, [b, texts[0]]) == j_answers.faithfulness(a, [b, texts[0]])
    assert t_answers.number_matches(100.0, [99.6, 5]) == j_answers.number_matches(100.0, [99.6, 5])


def test_evaluate_answers_equal(setup):
    qj = j_datasets.load_qa_subset(str(setup["root"] / "qa.json"))
    qt = t_datasets.load_qa_subset(str(setup["root"] / "qa.json"))
    rj = asyncio.run(j_answers.evaluate_answers(setup["jeng"].vector_rag, qj, top_k=3))
    rt = asyncio.run(t_answers.evaluate_answers(setup["teng"].vector_rag, qt, top_k=3))
    for report in (rt, rj):
        for row in report["detailed_results"]:
            row["retrieved_chunks"] = [row["retrieved_chunks"][0]] + sorted(row["retrieved_chunks"][1:])
    assert rt == rj
    assert rt["questions"] == 16 and rt["numeric_questions"] > 0 and rt["answer_accuracy_mean"] > 0.5


def test_graph_hybrid_arms_equal(setup):
    qj = j_datasets.load_qa_subset(str(setup["root"] / "qa.json"))
    qt = t_datasets.load_qa_subset(str(setup["root"] / "qa.json"))
    jeng, teng = setup["jeng"], setup["teng"]
    rj = j_arms.graph_hybrid_arms(jeng.vector_index, jeng.chunks, qj, ks=(3,),
                                  vector_searcher=JFiltered(jeng.vector_index), noise_chunks=jeng.chunks[:2])
    rt = t_arms.graph_hybrid_arms(teng.vector_index, teng.chunks, qt, ks=(3,),
                                  vector_searcher=TFiltered(teng.vector_index), noise_chunks=teng.chunks[:2])
    assert strip(rt) == strip(rj)
    assert rt["graph_build"]["facts"] > 16 and "hybrid_pipeline_k3" in rt


@pytest.mark.parametrize("weight,index_type", [(0.0, "flat"), (0.0, "ivf"), (0.5, "ivf")])
def test_health_equal(setup, weight, index_type):
    """Both engines' health() on the same corpus: equal keys and values; the
    port's extra ``dtype`` and ``device`` entries under ``vector_index`` are
    the only difference. With a weight configured over an IVF index (no
    FilteredSearch pipeline) both report it INACTIVE."""
    chunks_j, chunks_t = setup["jeng"].chunks, setup["teng"].chunks
    common = dict(default_model="fake", index_dir="", batch_queries=False, integrity_weight=weight,
                  index_type=index_type)
    if (weight, index_type) == (0.0, "flat"):
        jeng, teng = setup["jeng"], setup["teng"]
    else:
        jeng = JEngine(JSettings(**common), chunks=chunks_j)
        teng = TEngine(TSettings(**common), chunks=chunks_t, device="cpu")
    hj, ht = jeng.health(), teng.health()
    assert set(ht) == set(hj)
    assert set(ht["vector_index"]) - set(hj["vector_index"]) == {"dtype", "device"}
    assert ht["vector_index"]["dtype"] == "float32" and ht["vector_index"]["device"] == "cpu"
    for key in set(hj) - {"vector_index", "config_issues"}:
        assert ht[key] == hj[key], key
    for key in hj["vector_index"]:
        assert ht["vector_index"][key] == hj["vector_index"][key], key
    assert ht["integrity_active"] is False
    inactive = [i for i in ht["config_issues"] if "INACTIVE" in i]
    assert inactive == [i for i in hj["config_issues"] if "INACTIVE" in i]
    assert bool(inactive) == (weight > 0)
    if weight == 0:
        assert ht["config_issues"] == hj["config_issues"] == []
    else:
        # Both also carry validate()'s static warning; its wording names the
        # backends each package has.
        assert len(ht["config_issues"]) == len(hj["config_issues"]) == 2


def test_health_reports_an_active_weight_over_the_flat_index(setup):
    common = dict(default_model="fake", index_dir="", batch_queries=False, integrity_weight=0.5)
    jeng = JEngine(JSettings(**common), chunks=setup["jeng"].chunks)
    teng = TEngine(TSettings(**common), chunks=setup["teng"].chunks, device="cpu")
    hj, ht = jeng.health(), teng.health()
    assert ht["integrity_active"] is hj["integrity_active"] is True
    assert not [i for i in ht["config_issues"] + hj["config_issues"] if "INACTIVE" in i]
