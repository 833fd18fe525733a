"""The port's vector-RAG engine against the JAX engine, on the same seeded
generated filings, with the committed trained encoder.

Two comparisons:

- Shared embeddings: the port's index is built from the JAX index's own
  (normalised f32) corpus embeddings and encodes queries with the JAX
  embedder, so everything after the encoder is held to the JAX package
  exactly: the same hit ids in the same order, scores within 1e-5 (f32
  summation order differs between XLA and torch), and the same extractive
  answers, for the f32 and the int8 index.
- Own encoders: each engine encodes with its own MiniLM forward in bf16.
  The two forwards round bf16 activations in different places, so a
  query's cosine to a chunk moves by up to a few 1e-4 (observed <= 6e-4
  here). Scores must agree within 2e-3 rank by rank, and ids must be equal
  except inside a tie band: neighbouring scores closer than 2e-3, where the
  two encoders may order two chunks either way. Where the ids agree, the
  extractive answers must be equal.
"""

import asyncio
import threading

import numpy as np
import pytest

from ragfin_tpu.config.settings import Settings as JSettings
from ragfin_tpu.eval.distractors import generate_distractors as j_generate
from ragfin_tpu.index.vector_index import DeviceVectorIndex as JIndex
from ragfin_tpu.serving.engine import RagFinEngine as JEngine
from ragfin_tpu_torch.config.settings import Settings as TSettings
from ragfin_tpu_torch.eval.distractors import generate_distractors as t_generate
from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex as TIndex
from ragfin_tpu_torch.serving.engine import RagFinEngine as TEngine

N_CHUNKS = 320
SEED = 7
EXACT_TOL = 1e-5
ENCODER_TOL = 2e-3


def _questions(chunks):
    """Scoped questions (a bank and period present in the corpus) and
    unscoped ones (no bank or period named)."""
    scoped, seen = [], set()
    for c in chunks:
        if (c.company, c.period) in seen:
            continue
        seen.add((c.company, c.period))
        q, fy = c.period.split("_")
        scoped.append(f"What was {c.company}'s net profit in {q} {fy}?")
        if len(scoped) == 6:
            break
    unscoped = [
        "What were total customer deposits?",
        "How did treasury segment revenue do?",
        "What was the basic EPS growth?",
        "How did the bottom line move this quarter?",
        "What were the provisions and cost ratio?",
        "Total assets and borrowings",
    ]
    return scoped + unscoped


@pytest.mark.parametrize("seed", [0, SEED])
def test_generated_filings_identical(seed):
    a, b = j_generate(150, seed=seed), t_generate(150, seed=seed)
    assert len(a) == len(b) == 150
    for x, y in zip(a, b):
        assert x.model_dump() == y.model_dump()


@pytest.fixture(scope="module")
def corpora():
    """The filings of the seven banks other than the pipeline's default
    company (ICICI Bank): a question that names no bank then falls through
    the company tiers to the unscoped search, the fused kernels' path."""
    def cut(chunks):
        out = [c for c in chunks if c.company != "ICICI Bank"][:N_CHUNKS]
        assert len(out) == N_CHUNKS
        return out

    pool = int(N_CHUNKS * 1.3)
    return cut(j_generate(pool, seed=SEED)), cut(t_generate(pool, seed=SEED))


@pytest.fixture(scope="module")
def jax_engine(corpora):
    settings = JSettings(
        default_model="fake", embed_backend="trained", index_dir="", batch_queries=False
    )
    engine = JEngine(settings=settings, chunks=corpora[0])
    yield engine
    engine.batcher and engine.batcher.stop()


@pytest.fixture(scope="module")
def questions(corpora):
    return _questions(corpora[1])


def _shared_engines(jax_engine, corpora, dtype):
    """(JAX engine, port engine) over the same embeddings and query encoder."""
    jidx = jax_engine.vector_index
    emb = np.asarray(jidx.matrix_t, np.float32)[:, : jidx.n].T.copy()
    embedder = jidx.embedder
    if dtype == "int8":
        import jax.numpy as jnp

        j8 = JIndex(emb, corpora[0], dtype=jnp.int8, normalize=False)
        j8.embedder = embedder
        jeng = JEngine(
            settings=JSettings(default_model="fake", embed_backend="trained", index_dir="",
                               batch_queries=False),
            chunks=corpora[0], vector_index=j8,
        )
    else:
        jeng = jax_engine
    tidx = TIndex(emb, corpora[1], dtype=dtype, normalize=False, device="cpu")
    tidx.embedder = embedder
    teng = TEngine(
        settings=TSettings(embed_backend="trained", index_dtype=dtype, batch_queries=False),
        vector_index=tidx, device="cpu",
    )
    return jeng, teng


def _answer(engine, q):
    return asyncio.run(engine.vector_rag.search_and_answer(q, top_k=3))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_shared_embeddings_same_hits_and_answers(jax_engine, corpora, questions, dtype):
    jeng, teng = _shared_engines(jax_engine, corpora, dtype)
    for q in questions:
        a = jeng.vector_rag.search(q, top_k=5)
        b = teng.vector_rag.search(q, top_k=5)
        assert [h["id"] for h in a] == [h["id"] for h in b], q
        np.testing.assert_allclose(
            [h["score"] for h in a], [h["score"] for h in b], rtol=0, atol=EXACT_TOL, err_msg=q
        )
        ra, rb = _answer(jeng, q), _answer(teng, q)
        assert ra["answer"] == rb["answer"], q
        assert ra.get("answer_mode") == rb.get("answer_mode"), q
    # The unscoped index search alone, at the pipeline's fetch width.
    a = jeng.vector_index.search_texts(questions, top_k=64)
    b = teng.vector_index.search_texts(questions, top_k=64)
    for q, ha, hb in zip(questions, a, b):
        assert [h.id for h in ha] == [h.id for h in hb], q
        np.testing.assert_allclose(
            [h.score for h in ha], [h.score for h in hb], rtol=0, atol=EXACT_TOL, err_msg=q
        )


def _ids_agree_outside_tie_bands(a, b, tol):
    sa = np.array([h["score"] for h in a], np.float64)
    gaps = np.abs(np.diff(sa))
    prev = np.concatenate([[np.inf], gaps])
    nxt = np.concatenate([gaps, [np.inf]])
    # The last rank's successor is unknown: treat it as inside a band.
    nxt[-1] = 0.0
    strict = (prev > tol) & (nxt > tol)
    ia = np.array([h["id"] for h in a], object)
    ib = np.array([h["id"] for h in b], object)
    return bool(np.array_equal(ia[strict], ib[strict]))


@pytest.fixture(scope="module")
def torch_engine(corpora):
    settings = TSettings(embed_backend="trained", index_dir="", batch_queries=False)
    engine = TEngine(settings=settings, chunks=corpora[1], device="cpu")
    yield engine
    engine.close()


def test_own_encoders_agree(jax_engine, torch_engine, questions):
    same_ids = 0
    for q in questions:
        a = jax_engine.vector_rag.search(q, top_k=5)
        b = torch_engine.vector_rag.search(q, top_k=5)
        assert len(a) == len(b) == 5, q
        np.testing.assert_allclose(
            [h["score"] for h in a], [h["score"] for h in b], rtol=0, atol=ENCODER_TOL, err_msg=q
        )
        assert _ids_agree_outside_tie_bands(a, b, ENCODER_TOL), q
        if [h["id"] for h in a] == [h["id"] for h in b]:
            same_ids += 1
            assert _answer(jax_engine, q)["answer"] == _answer(torch_engine, q)["answer"], q
    # Tie bands are the exception: most questions must agree outright.
    assert same_ids >= len(questions) - 4


def test_index_stats_and_health(torch_engine):
    stats = torch_engine.vector_index.stats()
    assert stats["num_entities"] == N_CHUNKS and stats["dim"] == 384
    assert stats["dtype"] == "float32" and stats["device"] == "cpu"
    health = torch_engine.health()
    assert health["status"] == "healthy"
    assert health["vector_index"]["entities"] == N_CHUNKS
    assert health["provider"] == "offline"


def test_batched_concurrent_searches_match_single(torch_engine, corpora, questions):
    """Concurrent callers through the QueryBatcher get the hits of a single
    search. A query encoded in a larger padded batch moves by ~1e-4 in bf16
    (the row bucket changes the matmul shapes), hence ENCODER_TOL."""
    single = {q: torch_engine.vector_rag.search(q, top_k=3) for q in questions}
    engine = TEngine(
        settings=TSettings(embed_backend="trained", batch_queries=True),
        vector_index=torch_engine.vector_index, device="cpu",
    )
    try:
        got, lock = {}, threading.Lock()

        def ask(q):
            hits = engine.vector_rag.search(q, top_k=3)
            with lock:
                got[q] = hits

        threads = [threading.Thread(target=ask, args=(q,)) for q in questions]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        engine.close()
    for q in questions:
        np.testing.assert_allclose(
            [h["score"] for h in single[q]], [h["score"] for h in got[q]],
            rtol=0, atol=ENCODER_TOL, err_msg=q,
        )
        assert _ids_agree_outside_tie_bands(single[q], got[q], ENCODER_TOL), q


def test_warmup_runs(torch_engine):
    torch_engine.warmup()


# --- graph half ----------------------------------------------------------


def test_graph_half_is_built_and_reported(torch_engine, jax_engine):
    assert torch_engine.provider is None and torch_engine.graph.n_facts == 0
    assert torch_engine.health()["graph"] == {"facts": 0}
    assert torch_engine.health()["extraction_model"] == "rule-based"
    built = torch_engine.graph_builder.build_from_vector_index(torch_engine.vector_index)
    want = jax_engine.graph_builder.build_from_vector_index(jax_engine.vector_index)
    assert built == want and built["chunks_processed"] == N_CHUNKS
    assert torch_engine.graph.stats() == jax_engine.graph.stats()
    assert torch_engine.health()["graph"]["facts"] == torch_engine.graph.n_facts > 1000
    assert str(torch_engine.graph.device) == "cpu"
    torch_engine.warmup()  # now with the graph match
    q = "Which quarter did HDFC Bank's net profit peak?"
    got = asyncio.run(torch_engine.graph_builder.query(q))
    want = asyncio.run(jax_engine.graph_builder.query(q))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        a, b = dict(a), dict(b)
        assert a.pop("mean", 0.0) == pytest.approx(b.pop("mean", 0.0), rel=1e-5)
        assert a == b


def test_persist_and_reload_graph(torch_engine, tmp_path):
    if torch_engine.graph.n_facts == 0:
        torch_engine.graph_builder.build_from_vector_index(torch_engine.vector_index)
    torch_engine.settings.index_dir = str(tmp_path)
    try:
        torch_engine.persist()
    finally:
        torch_engine.settings.index_dir = ""
    assert (tmp_path / "index.json").exists() and (tmp_path / "graph" / "graph.json").exists()
    again = TEngine(
        settings=TSettings(embed_backend="trained", index_dir=str(tmp_path), batch_queries=False),
        vector_index=torch_engine.vector_index, device="cpu",
    )
    assert again.graph.stats() == torch_engine.graph.stats()
    assert again.graph.match(names=["NET PROFIT"]) == torch_engine.graph.match(names=["NET PROFIT"])
    # Without chunks and without an index handed in, the saved flat index is
    # loaded and serves the same hits.
    loaded = TEngine(
        settings=TSettings(embed_backend="trained", index_dir=str(tmp_path), batch_queries=False),
        device="cpu",
    )
    assert loaded.chunks == [] and loaded.vector_index.n == torch_engine.vector_index.n
    q = "What were total customer deposits?"
    assert loaded.vector_rag.search(q, top_k=3) == torch_engine.vector_rag.search(q, top_k=3)
    # A store that cannot be read raises; nothing falls back to an empty graph.
    (tmp_path / "graph" / "graph.json").write_text("{broken")
    with pytest.raises(ValueError):
        TEngine(
            settings=TSettings(embed_backend="trained", index_dir=str(tmp_path), batch_queries=False),
            vector_index=torch_engine.vector_index, device="cpu",
        )


def test_llm_provider_selects_the_llm_extractor(torch_engine):
    from ragfin_tpu_torch.extraction.service import EntityExtractor
    from ragfin_tpu_torch.llm.providers import FakeProvider

    eng = TEngine(
        settings=TSettings(embed_backend="trained", index_dir="", batch_queries=False,
                           default_model="gemini-2.0-flash", gemini_api_key="k"),
        vector_index=torch_engine.vector_index, provider=FakeProvider(), device="cpu",
    )
    assert isinstance(eng.graph_builder.extractor, EntityExtractor)
    assert eng.graph_builder.extractor.client is eng.provider is eng.hybrid.provider
    assert eng.health()["extraction_model"] == "gemini-2.0-flash"


def test_settings_graph_and_ivf_fields(monkeypatch):
    for key, value in (("RAGFIN_MODEL", "gemini-2.0-flash"), ("GEMINI_API_KEY", "abc"),
                       ("RAGFIN_INDEX_TYPE", "ivf"), ("RAGFIN_IVF_NPROBE", "7")):
        monkeypatch.setenv(key, value)
    from ragfin_tpu.config import settings as JS
    from ragfin_tpu_torch.config import settings as TS

    t, j = TS._from_env(), JS._from_env()
    for name in ("default_model", "gemini_api_key", "openai_api_key", "groq_api_key",
                 "ollama_base_url", "index_type", "ivf_nprobe"):
        assert getattr(t, name) == getattr(j, name), name
    for model in ("gemini-2.0-flash", "gpt-4o", "llama3", "fake"):
        assert t.get_api_key_for_model(model) == j.get_api_key_for_model(model)
    assert TSettings().default_model == "fake" and TSettings().ivf_nprobe == 32
    bad = TSettings(default_model="nope", index_type="hnsw", ivf_nprobe=0)
    want = JSettings(default_model="nope", index_type="hnsw", ivf_nprobe=0).validate()
    for issue in ("unknown default_model 'nope'", "unknown index_type 'hnsw'", "ivf_nprobe must be >= 1"):
        assert issue in bad.validate() and issue in want


# --- index_type="ivf" ----------------------------------------------------


@pytest.fixture(scope="module")
def ivf_engines(jax_engine, corpora):
    """(JAX, port) engines over IVF indexes clustered from the same f32
    embeddings: 320 chunks in 128-wide cells, so three cells."""
    from ragfin_tpu.index.ivf_index import IVFVectorIndex as JIVF
    from ragfin_tpu_torch.index.ivf_index import IVFVectorIndex as TIVF

    jidx = jax_engine.vector_index
    emb = np.asarray(jidx.matrix_t, np.float32)[:, : jidx.n].T.copy()
    tdense = TIndex(emb, corpora[1], normalize=False, device="cpu")
    tdense.embedder = jidx.embedder
    jivf = JIVF.from_dense(jidx, cell=128, nprobe=2)
    tivf = TIVF.from_dense(tdense, cell=128, nprobe=2)
    jeng = JEngine(
        settings=JSettings(default_model="fake", embed_backend="trained", index_dir="",
                           index_type="ivf", batch_queries=False),
        chunks=corpora[0], vector_index=jivf,
    )
    teng = TEngine(
        settings=TSettings(embed_backend="trained", index_dir="", index_type="ivf",
                           batch_queries=False),
        vector_index=tivf, device="cpu",
    )
    yield jeng, teng
    jeng.close()
    teng.close()


def test_ivf_engines_agree(ivf_engines, questions):
    jeng, teng = ivf_engines
    assert np.array_equal(np.asarray(jeng.vector_index.ivf.orig_ids),
                          teng.vector_index.ivf.orig_ids.numpy())
    assert teng.vector_rag._searcher is None  # no filters over an IVF index
    for q in questions:
        a = jeng.vector_rag.search(q, top_k=5)
        b = teng.vector_rag.search(q, top_k=5)
        assert [h["id"] for h in a] == [h["id"] for h in b], q
        np.testing.assert_allclose(
            [h["score"] for h in a], [h["score"] for h in b], rtol=0, atol=EXACT_TOL, err_msg=q
        )
    assert teng.health()["vector_index"]["dtype"] == "float32"


def test_ivf_full_probe_equals_the_flat_engine(ivf_engines, jax_engine, corpora, questions):
    _, teng = ivf_engines
    _, flat = _shared_engines(jax_engine, corpora, "float32")
    teng.vector_index.nprobe = teng.vector_index.ivf.n_cells
    try:
        a = flat.vector_index.search_texts(questions, top_k=10)
        b = teng.vector_index.search_texts(questions, top_k=10)
    finally:
        teng.vector_index.nprobe = 2
    for q, ha, hb in zip(questions, a, b):
        assert [h.id for h in ha] == [h.id for h in hb], q
        np.testing.assert_allclose(
            [h.score for h in ha], [h.score for h in hb], rtol=0, atol=EXACT_TOL, err_msg=q
        )


def test_engine_builds_saves_and_loads_ivf(corpora, tmp_path):
    """``Settings(index_type="ivf")`` builds the IVF index with
    ``ivf_nprobe``; ``persist`` writes it; an engine over that ``index_dir``
    loads it (with the settings' embedder attached) and answers alike."""
    settings = TSettings(embed_backend="trained", index_dir=str(tmp_path), index_type="ivf",
                         ivf_nprobe=1, batch_queries=False)
    eng = TEngine(settings=settings, chunks=corpora[1], device="cpu")
    assert eng.vector_index.stats()["index_type"] == "IVF_BALANCED"
    assert eng.vector_index.nprobe == 1 and eng.vector_index.n == N_CHUNKS
    assert eng.settings.validate() == []
    q = "What were total customer deposits?"
    hits = eng.vector_rag.search(q, top_k=3)
    assert len(hits) == 3
    eng.graph_builder.build_from_vector_index(eng.vector_index)
    hybrid = eng.hybrid.hybrid_query_simple("Which quarter did HDFC Bank's net profit peak?")
    assert hybrid["vector_hits"] == 10 and hybrid["chunks"]
    eng.persist()
    assert (tmp_path / "ivf.json").exists() and (tmp_path / "graph" / "graph.json").exists()
    loaded = TEngine(settings=settings, device="cpu")
    assert loaded.vector_index.embedder is not None
    again = loaded.vector_rag.search(q, top_k=3)
    # The saved exact-repair shadow is f16, so scores move by up to ~1e-3.
    np.testing.assert_allclose([h["score"] for h in hits], [h["score"] for h in again], atol=ENCODER_TOL)
    assert _ids_agree_outside_tie_bands(hits, again, ENCODER_TOL)
    assert loaded.graph.stats() == eng.graph.stats()
    (tmp_path / "ivf.npz").unlink()
    with pytest.raises(FileNotFoundError):
        TEngine(settings=settings, device="cpu")


def test_engine_needs_chunks_or_an_index(tmp_path):
    # Nothing to load: an empty, degraded engine, as in the JAX package.
    empty = TEngine(
        settings=TSettings(index_dir="", data_dir=str(tmp_path), batch_queries=False),
        device="cpu",
    )
    assert empty.vector_index.n == 0 and empty.health()["status"] == "degraded"
    with pytest.raises(ValueError, match="index_type"):
        TEngine(settings=TSettings(index_dir="", index_type="hnsw"), chunks=[], device="cpu")
