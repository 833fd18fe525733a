"""Hashed-backend index paths of the port against the JAX package, on the CPU.

The corpus is a generated ``extract_data`` tree (``write_extract_data``,
seed 44: 16 ICICI FY2024 chunks), 3,000 generated filings and 48 in-scope
tampered copies of the ICICI chunks; each package makes its own copy and
builds its own hashed index (``DeviceVectorIndex.build(chunks)``, the
default backend). The two matrices differ by f32 summation order (within
2e-6), so hits are compared as ``hits_equal`` says: scores within 1e-5, ids
equal wherever neighbouring scores differ by more than 1e-6. After a sparse
re-rank or on the exact-bucket path the scores are the same host arithmetic
and the hits must be exactly equal.

Persistence: an index (flat and IVF, f32 and int8, untuned and with a tuned
``encoder_table.npy``) saved by either package loads in the other with the
same top-k.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ragfin_tpu.config.settings import Settings as JSettings
from ragfin_tpu.data.loader import build_corpus as j_build_corpus
from ragfin_tpu.eval.distractors import generate_distractors as j_distractors
from ragfin_tpu.eval.distractors import generate_inscope_distractors as j_inscope
from ragfin_tpu.index.ivf_index import IVFVectorIndex as JIVF
from ragfin_tpu.index.vector_index import DeviceVectorIndex as JIndex
from ragfin_tpu.models.bag_encoder import BagEncoder as JBag
from ragfin_tpu.serving.engine import RagFinEngine as JEngine
from ragfin_tpu_torch.config.settings import Settings as TSettings
from ragfin_tpu_torch.data.loader import build_corpus as t_build_corpus
from ragfin_tpu_torch.eval.distractors import generate_distractors as t_distractors
from ragfin_tpu_torch.eval.distractors import generate_inscope_distractors as t_inscope
from ragfin_tpu_torch.eval.statements import write_extract_data
from ragfin_tpu_torch.index.ivf_index import IVFVectorIndex as TIVF
from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex as TIndex
from ragfin_tpu_torch.models.bag_encoder import BagEncoder as TBag
from ragfin_tpu_torch.models.embedder import HashedEmbedder
from ragfin_tpu_torch.serving.engine import RagFinEngine as TEngine
from tests._jax_fasthash import jax_native_from_port_build  # noqa: F401

TOL = 1e-5
TIE = 1e-6
N_FILINGS = 3000
N_TAMPERED = 48
QUESTIONS = [
    "What was ICICI Bank's net profit in Q1 FY2024?",
    "What were total customer deposits in Q3 FY2024?",
    "What was the basic EPS?",
    "How did the bottom line move this quarter?",
    "How did retail banking segment revenue do in Q2 FY2024?",
    "Total assets and borrowings",
]
CASES = {
    "plain": {},
    "rerank": {"rerank": 64},
    "no_expansion": {"rerank": 64, "query_expansion": False},
    "period": {"period": "Q2_FY2024", "rerank": 64},
    "periods_type": {"periods": ["Q1_FY2024", "Q3_FY2024"], "chunk_type": "profitability_analysis"},
    "company": {"company": "ICICI Bank"},
    "bucket_strict": {"period": "Q1_FY2024", "consistency_weight": 0.5, "rerank": 64},
    "bucket_smooth": {"period": "Q2_FY2024", "consistency_weight": 0.5,
                      "consistency_strict": False},
    "weighted_unscoped": {"consistency_weight": 0.5, "rerank": 64},
    "weighted_no_rerank": {"consistency_weight": 0.5},
}
TIERS = [{"period": "Q1_FY2024", "company": "ICICI Bank"}, {"period": "Q1_FY2024"}, {}]


def hits_equal(t_hits, j_hits, exact=False):
    assert len(t_hits) == len(j_hits), ([h.id for h in t_hits], [h.id for h in j_hits])
    if not j_hits:
        return
    ts = np.array([h.score for h in t_hits])
    js = np.array([h.score for h in j_hits])
    ti, ji = [h.id for h in t_hits], [h.id for h in j_hits]
    if exact:
        assert ti == ji and np.array_equal(ts, js), (ti, ji, ts, js)
        return
    assert np.max(np.abs(ts - js)) <= TOL, (ts, js)
    gaps = np.abs(np.diff(js))
    prev = np.r_[np.inf, gaps]
    nxt = np.r_[gaps, np.inf]
    for i in range(len(ji)):
        if prev[i] > TIE and nxt[i] > TIE:
            assert ti[i] == ji[i], (i, ti, ji, js)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_extract_data(str(tmp_path_factory.mktemp("hashed") / "extract_data"), seed=44)


@pytest.fixture(scope="module")
def corpora(tree):
    jc, tc = j_build_corpus(tree), t_build_corpus(tree)
    jc = jc + j_distractors(N_FILINGS, seed=7) + j_inscope(jc, N_TAMPERED, seed=3)
    tc = tc + t_distractors(N_FILINGS, seed=7) + t_inscope(tc, N_TAMPERED, seed=3)
    assert [c.model_dump() for c in jc] == [c.model_dump() for c in tc]
    return jc, tc


@pytest.fixture(scope="module")
def indexes(corpora):
    """{dtype: (JAX index, port index)}, each package's own hashed build."""
    out = {}
    for dtype in ("float32", "int8"):
        j = JIndex.build(corpora[0], dtype=jnp.int8 if dtype == "int8" else jnp.float32)
        t = TIndex.build(corpora[1], dtype=dtype, device="cpu")
        out[dtype] = (j, t)
    return out


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_build_is_hashed_like_jax(indexes, dtype):
    j, t = indexes[dtype]
    assert isinstance(t.embedder, HashedEmbedder)
    assert t.featurizer is t.embedder.featurizer and t.encoder is t.embedder.encoder
    assert t.featurizer.state_dict() == j.featurizer.state_dict()
    assert t.encoder.state_dict() == j.encoder.state_dict()
    assert t.quantized == (dtype == "int8") and t.n == j.n
    got, ref = t._dense_rows(), (j._exact_rows if dtype == "int8"
                                 else np.asarray(j.matrix_t)[:, : j.n].T)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def test_build_fits_an_unfitted_featurizer_and_keeps_a_fitted_one(corpora):
    from ragfin_tpu_torch.models.featurizer import HashedFeaturizer

    texts = [c.text for c in corpora[1][:200]]
    fitted = HashedFeaturizer().fit(texts[:50])
    idx = TIndex.build(corpora[1][:200], featurizer=fitted, device="cpu")
    assert idx.featurizer is fitted and fitted.n_docs == 50
    fresh = HashedFeaturizer()
    idx = TIndex.build(corpora[1][:200], featurizer=fresh, device="cpu")
    assert fresh.n_docs == 200


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_search_texts_matches_jax(indexes, dtype, case):
    j, t = indexes[dtype]
    kw = CASES[case]
    a = t.search_texts(QUESTIONS, top_k=8, **kw)
    b = j.search_texts(QUESTIONS, top_k=8, **kw)
    exact = bool(kw.get("rerank")) or case.startswith("bucket")
    for ha, hb in zip(a, b):
        assert ha, case
        hits_equal(ha, hb, exact=exact)


def test_exact_bucket_path_runs_no_device_search(indexes, monkeypatch):
    """A scoped integrity-weighted search with a bucket of at most
    exact_bucket_max rows is answered on the host, without encoding the
    queries; a larger bucket goes to the device tiers, as in JAX."""
    j, t = indexes["float32"]
    calls = []
    monkeypatch.setattr(t, "_encode_queries", lambda qs: calls.append(qs) or 1 / 0)
    hits = t.search_texts(QUESTIONS[:2], top_k=5, period="Q1_FY2024", consistency_weight=0.5)
    assert not calls and all(hits)
    monkeypatch.undo()
    encode = t._encode_queries
    monkeypatch.setattr(t, "_encode_queries", lambda qs: calls.append(qs) or encode(qs))
    for idx in (j, t):
        idx.exact_bucket_max = 4
    try:
        a = t.search_texts(QUESTIONS[:2], top_k=5, period="Q1_FY2024", consistency_weight=0.5)
        b = j.search_texts(QUESTIONS[:2], top_k=5, period="Q1_FY2024", consistency_weight=0.5)
        assert len(calls) == 1
        for ha, hb in zip(a, b):
            hits_equal(ha, hb)
    finally:
        for idx in (j, t):
            del idx.exact_bucket_max


@pytest.mark.parametrize("weight", [0.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_search_texts_tiers_matches_jax(indexes, dtype, weight):
    j, t = indexes[dtype]
    kw = dict(top_k=6, rerank=64, consistency_weight=weight)
    a = t.search_texts_tiers(QUESTIONS, TIERS, **kw)
    b = j.search_texts_tiers(QUESTIONS, TIERS, **kw)
    assert len(a) == len(b) == len(TIERS)
    for ta, tb_ in zip(a, b):
        for ha, hb in zip(ta, tb_):
            hits_equal(ha, hb, exact=True)


@pytest.mark.parametrize("integrity", [0.0, 0.5])
def test_engine_and_vector_rag_match_jax(corpora, integrity):
    """The hashed engine (embed_backend="hashed": the default build) and
    VectorRAG through FilteredSearch (rerank 64, query expansion)."""
    common = dict(default_model="fake", index_dir="", batch_queries=False,
                  embed_backend="hashed", integrity_weight=integrity)
    je = JEngine(JSettings(**common), chunks=corpora[0])
    te = TEngine(TSettings(**common), chunks=corpora[1], device="cpu")
    try:
        assert isinstance(te.vector_index.embedder, HashedEmbedder)
        assert te.health()["integrity_active"] == je.health()["integrity_active"] == (integrity > 0)
        assert te.health()["config_issues"] == je.health()["config_issues"]
        for q in QUESTIONS:
            a, b = te.vector_rag.search(q, top_k=5), je.vector_rag.search(q, top_k=5)
            assert [h["id"] for h in a] == [h["id"] for h in b], q
            np.testing.assert_allclose([h["score"] for h in a], [h["score"] for h in b],
                                       rtol=0, atol=TOL)
    finally:
        te.close()
        je.close()


def test_extended_with_refit_matches_jax(corpora):
    base_j, base_t = corpora[0][:1500], corpora[1][:1500]
    new_j, new_t = corpora[0][1500:1600], corpora[1][1500:1600]
    j = JIndex.build(base_j).extended_with(new_j, refit=True)
    t = TIndex.build(base_t, device="cpu").extended_with(new_t, refit=True)
    assert t.n == j.n == 1600 and t.featurizer.n_docs == j.featurizer.n_docs == 1600
    assert t.featurizer.state_dict() == j.featurizer.state_dict()
    for ha, hb in zip(t.search_texts(QUESTIONS, top_k=5, rerank=64),
                      j.search_texts(QUESTIONS, top_k=5, rerank=64)):
        hits_equal(ha, hb, exact=True)
    frozen = TIndex.build(base_t, device="cpu").extended_with(new_t, refit=False)
    assert frozen.featurizer.n_docs == 1500 and frozen.n == 1600


def _tuned_table(vocab=1 << 16, dim=384):
    rng = np.random.default_rng(9)
    return (rng.standard_normal((vocab, dim)) / np.sqrt(dim)).astype(np.float32)


def _built(side, corpora, dtype, tuned, kind):
    """An index of the first 1,200 chunks built by one package."""
    chunks = (corpora[0] if side == "j" else corpora[1])[:1200]
    table = _tuned_table() if tuned else None
    if side == "j":
        enc = JBag(table=jnp.asarray(table)) if tuned else JBag()
        idx = JIndex.build(chunks, encoder=enc, dtype=jnp.int8 if dtype == "int8" else jnp.float32)
        return JIVF.from_dense(idx, cell=128, nprobe=4) if kind == "ivf" else idx
    enc = TBag(table=table, device="cpu") if tuned else TBag(device="cpu")
    idx = TIndex.build(chunks, encoder=enc, dtype=dtype, device="cpu")
    return TIVF.from_dense(idx, cell=128, nprobe=4) if kind == "ivf" else idx


@pytest.mark.parametrize("tuned", [False, True], ids=["untuned", "tuned"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("kind", ["flat", "ivf"])
@pytest.mark.parametrize("saver", ["jax", "port"])
def test_saved_index_loads_in_the_other_package(corpora, tmp_path, saver, kind, dtype, tuned):
    src = _built("j" if saver == "jax" else "t", corpora, dtype, tuned, kind)
    src.save(str(tmp_path))
    assert os.path.exists(tmp_path / "encoder_table.npy") == tuned
    loader = {("flat", "jax"): TIndex, ("ivf", "jax"): TIVF,
              ("flat", "port"): JIndex, ("ivf", "port"): JIVF}[(kind, saver)]
    kwargs = {"device": "cpu"} if saver == "jax" else {}
    dst = loader.load(str(tmp_path), **kwargs)
    if saver == "jax":
        enc = dst.encoder if kind == "flat" else dst.embedder.encoder
        assert enc.tuned == tuned
        assert np.array_equal(enc.table.numpy(), np.asarray(src.encoder.table))
    kw = {"rerank": 64} if kind == "flat" else {}
    if kind == "ivf":
        # A saved IVF index keeps its repair rows as f16: compare with the
        # saver's own reload of the directory.
        src = type(src).load(str(tmp_path), **({} if saver == "jax" else {"device": "cpu"}))
    for a, b in zip(dst.search_texts(QUESTIONS, top_k=8, **kw),
                    src.search_texts(QUESTIONS, top_k=8, **kw)):
        hits_equal(a, b, exact=kind == "flat")


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_untuned_resave_removes_a_stale_table(corpora, tmp_path, kind):
    _built("t", corpora, "float32", True, kind).save(str(tmp_path))
    assert (tmp_path / "encoder_table.npy").exists()
    _built("t", corpora, "float32", False, kind).save(str(tmp_path))
    assert not (tmp_path / "encoder_table.npy").exists()
    meta = json.load(open(tmp_path / ("ivf.json" if kind == "ivf" else "index.json")))
    assert meta["encoder"]["tuned"] is False
    loader = TIVF if kind == "ivf" else TIndex
    assert not loader.load(str(tmp_path), device="cpu").encoder.tuned


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_ivf_search_texts_matches_jax(corpora, tmp_path, dtype):
    """A JAX-built hashed IVF index, saved and loaded in the port: the
    port's search_texts expands and encodes queries as JAX's does."""
    _built("j", corpora, dtype, False, "ivf").save(str(tmp_path))
    j = JIVF.load(str(tmp_path))
    t = TIVF.load(str(tmp_path), device="cpu")
    assert isinstance(t.embedder, HashedEmbedder) and t.featurizer is not None
    for expand in (True, False):
        for a, b in zip(t.search_texts(QUESTIONS, top_k=8, query_expansion=expand),
                        j.search_texts(QUESTIONS, top_k=8, query_expansion=expand)):
            hits_equal(a, b)
    # The featurizer + encoder pair alone serves as well.
    t.embedder = None
    for a, b in zip(t.search_texts(QUESTIONS, top_k=8), j.search_texts(QUESTIONS, top_k=8)):
        hits_equal(a, b)


def test_hashed_index_needs_a_card_unless_asked_for_the_cpu(corpora, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TIndex.build(corpora[1][:20])
    JIVF.from_dense(JIndex.build(corpora[0][:300]), cell=64, nprobe=2).save(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TIVF.load(str(tmp_path))
    assert isinstance(TIVF.load(str(tmp_path), device="cpu").embedder, HashedEmbedder)
