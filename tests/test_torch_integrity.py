"""Integrity-weighted retrieval in the port against the JAX package.

The tree is a generated ``extract_data`` tree (``write_extract_data``, seed
44: the 16 ICICI FY2024 chunks) plus in-scope tampered copies of those
chunks (``generate_inscope_distractors``, tiers reword and dupe): copies
with the right company, period and type whose figures were perturbed, which
no metadata filter can reject. Each package loads the tree and makes the
copies itself; the copies must be equal chunk for chunk.

Both packages search with the committed trained encoder over shared
embeddings: the port's index is built from the JAX index's normalised f32
corpus embeddings and encodes queries with the JAX embedder, so everything
after the encoder (the integrity column, the multiplier, the weighted dense
tiers, the int8 tiers, the query filters) is held to the JAX package: the
same ids in the same order, scores within 1e-5 (f32 summation order differs
between XLA and torch). The column and the multiplier are host arithmetic
on the same text and must be bitwise equal.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from ragfin_tpu.config.settings import Settings as JSettings
from ragfin_tpu.data.loader import build_corpus as j_build_corpus
from ragfin_tpu.eval.distractors import generate_inscope_distractors as j_inscope
from ragfin_tpu.index.vector_index import DeviceVectorIndex as JIndex
from ragfin_tpu.retrieval.vector_rag import VectorRAG as JRAG
from ragfin_tpu.serving.engine import RagFinEngine as JEngine
from ragfin_tpu_torch.config.settings import Settings as TSettings
from ragfin_tpu_torch.data.loader import build_corpus as t_build_corpus
from ragfin_tpu_torch.eval.distractors import generate_inscope_distractors as t_inscope
from ragfin_tpu_torch.eval.statements import write_extract_data
from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex as TIndex
from ragfin_tpu_torch.retrieval.consistency import smooth, strictify
from ragfin_tpu_torch.retrieval.vector_rag import VectorRAG as TRAG
from ragfin_tpu_torch.serving.engine import RagFinEngine as TEngine

EXACT_TOL = 1e-5
# Own encoders (each package's bf16 MiniLM forward) move a cosine by up to
# a few 1e-4 (tests/test_torch_engine.py).
ENCODER_TOL = 2e-3
N_TAMPERED = 48
TAMPER_SEED = 3
REPRO = "What was the net profit in Q2 FY2024?"
QUESTIONS = [
    REPRO,
    "What was ICICI Bank's net profit in Q1 FY2024?",
    "What were total customer deposits in Q3 FY2024?",
    "What was the basic EPS in Q4 FY2024?",
    "How did retail banking segment revenue do in Q2 FY2024?",
    "What was the net profit?",
    "Total assets and borrowings",
]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_extract_data(str(tmp_path_factory.mktemp("integrity") / "extract_data"), seed=44)


@pytest.fixture(scope="module")
def corpora(tree):
    """(JAX chunks, port chunks): the loaded tree plus its tampered copies,
    each made by its own package."""
    jc, tc = j_build_corpus(tree), t_build_corpus(tree)
    tiers = ("reword", "dupe")
    return (
        jc + j_inscope(jc, N_TAMPERED, seed=TAMPER_SEED, tiers=tiers),
        tc + t_inscope(tc, N_TAMPERED, seed=TAMPER_SEED, tiers=tiers),
    )


@pytest.fixture(scope="module")
def jax_engine(corpora):
    engine = JEngine(
        JSettings(default_model="fake", index_dir="", batch_queries=False, integrity_weight=0.5),
        chunks=corpora[0],
    )
    yield engine
    engine.close()


@pytest.fixture(scope="module")
def indexes(jax_engine, corpora):
    """{dtype: (JAX index, port index)} over the JAX engine's embeddings and
    query encoder."""
    jidx = jax_engine.vector_index
    emb = np.asarray(jidx.matrix_t, np.float32)[:, : jidx.n].T.copy()
    j8 = JIndex(emb, corpora[0], dtype=jnp.int8, normalize=False)
    j8.embedder = jidx.embedder
    out = {"float32": (jidx, None), "int8": (j8, None)}
    for dtype in out:
        t = TIndex(emb, corpora[1], dtype=dtype, normalize=False, device="cpu")
        t.embedder = jidx.embedder
        out[dtype] = (out[dtype][0], t)
    return out


@pytest.mark.parametrize("seed", [TAMPER_SEED, 11])
@pytest.mark.parametrize("tier", ["regen", "reword", "dupe", "scaled"])
def test_inscope_distractors_equal(tree, seed, tier):
    jc, tc = j_build_corpus(tree), t_build_corpus(tree)
    a = j_inscope(jc, 40, seed=seed, tiers=(tier,))
    b = t_inscope(tc, 40, seed=seed, tiers=(tier,))
    assert len(a) == len(b) == 40
    for x, y in zip(a, b):
        assert x.model_dump() == y.model_dump()


def test_inscope_distractors_default_tiers_equal(tree):
    a, b = j_inscope(j_build_corpus(tree), 30, seed=5), t_inscope(t_build_corpus(tree), 30, seed=5)
    assert [x.model_dump() for x in a] == [y.model_dump() for y in b]
    assert {x.id.split("_")[1] for x in b} == {"regen", "reword"}


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_integrity_column_equal(indexes, dtype):
    jidx, tidx = indexes[dtype]
    a, b = np.asarray(jidx.integrity_column()), tidx.integrity_column()
    assert b.dtype == np.float32 and b.shape == (tidx.matrix_t.shape[1],)
    np.testing.assert_array_equal(a, b)
    # Padding columns are ones; the tampered copies carry the penalties.
    assert np.all(b[tidx.n:] == 1.0)
    assert np.any(b[16 : tidx.n] < 1.0)
    assert tidx.integrity_column() is b


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("weight", [0.5, 0.95])
def test_integrity_mult_equal(indexes, strict, weight):
    jidx, tidx = indexes["float32"]
    a = np.asarray(jidx._integrity_mult(weight, strict))
    b = tidx._integrity_mult(weight, strict)
    assert b.device == tidx.device and b.dtype.is_floating_point
    np.testing.assert_array_equal(a, b.numpy())
    col = tidx.integrity_column()
    want = strictify(col, weight) if strict else smooth(col, weight)
    np.testing.assert_array_equal(b.numpy(), want.astype(np.float32))
    # Cached per (weight, strict, width): the same device tensor again.
    assert tidx._integrity_mult(weight, strict) is b


def _same_hits(ha, hb, label):
    assert [h.id for h in ha] == [h.id for h in hb], label
    np.testing.assert_allclose(
        [h.score for h in ha], [h.score for h in hb], rtol=0, atol=EXACT_TOL, err_msg=label
    )


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("weight", [0.5, 0.95])
@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("period", [None, "Q2_FY2024"])
def test_search_texts_weighted_equal(indexes, dtype, weight, strict, period):
    jidx, tidx = indexes[dtype]
    kw = dict(top_k=10, consistency_weight=weight, consistency_strict=strict, period=period)
    a, b = jidx.search_texts(QUESTIONS, **kw), tidx.search_texts(QUESTIONS, **kw)
    for q, ha, hb in zip(QUESTIONS, a, b):
        assert hb, q
        _same_hits(ha, hb, q)
        if period is not None:
            assert all(h.record.period == period for h in hb), q
    # The weight moves the order: unweighted hits differ somewhere.
    plain = tidx.search_texts(QUESTIONS, top_k=10, period=period)
    assert any([h.id for h in x] != [h.id for h in y] for x, y in zip(plain, b))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("strict", [True, False])
def test_search_texts_tiers_weighted_equal(indexes, dtype, strict):
    jidx, tidx = indexes[dtype]
    tiers = [{"period": "Q2_FY2024", "company": "ICICI Bank"}, {"period": "Q2_FY2024"}, {}]
    kw = dict(top_k=6, consistency_weight=0.5, consistency_strict=strict)
    a = jidx.search_texts_tiers(QUESTIONS, tiers, **kw)
    b = tidx.search_texts_tiers(QUESTIONS, tiers, **kw)
    for flt, ta, tb in zip(tiers, a, b):
        for q, ha, hb in zip(QUESTIONS, ta, tb):
            _same_hits(ha, hb, f"{q} {flt}")


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_vector_rag_weighted_equal(indexes, dtype):
    jidx, tidx = indexes[dtype]
    jrag, trag = JRAG(jidx, integrity_weight=0.5), TRAG(tidx, integrity_weight=0.5)
    for q in QUESTIONS:
        a, b = jrag.search(q, top_k=5), trag.search(q, top_k=5)
        assert b, q
        assert [h["id"] for h in a] == [h["id"] for h in b], q
        np.testing.assert_allclose(
            [h["score"] for h in a], [h["score"] for h in b], rtol=0, atol=EXACT_TOL, err_msg=q
        )
    top = trag.search(REPRO, top_k=5)
    assert top[0]["id"] == "icici_q2_fy2024_profitability_analysis"
    # Every tampered copy of the source that fails a check ranks below it.
    assert all(h["id"].startswith("inscope_") for h in top[1:])


def test_repro_question_through_both_engines(jax_engine, corpora):
    """ROADMAP's repro: each engine with its own encoder and
    ``Settings(integrity_weight=0.5)``. JAX answers with the source chunk
    at 0.8018; the port must too, within the encoders' tolerance."""
    teng = TEngine(
        TSettings(default_model="fake", index_dir="", batch_queries=False, integrity_weight=0.5),
        chunks=corpora[1], device="cpu",
    )
    try:
        a = jax_engine.vector_rag.search(REPRO, top_k=3)
        b = teng.vector_rag.search(REPRO, top_k=3)
        assert a[0]["id"] == b[0]["id"] == "icici_q2_fy2024_profitability_analysis"
        assert abs(a[0]["score"] - 0.8018) < 1e-4
        assert abs(b[0]["score"] - a[0]["score"]) < ENCODER_TOL
        assert b[1]["score"] < 0.5 * b[0]["score"] + ENCODER_TOL
    finally:
        teng.close()
