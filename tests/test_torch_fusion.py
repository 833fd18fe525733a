"""``fuse_results`` and the hybrid slice as a whole, port against JAX.

``fuse_results``: random vector and graph row lists with ``-1`` padding,
repeats inside the graph rows and overlap with the vector rows: exact
equality with the JAX function (which pads nothing itself; the port's
``k = min(k_out, Kv + G)`` is JAX's).

``HybridRAG.hybrid_query``: the port's engine and the JAX engine over one
generated corpus, the port's index built from the JAX index's embeddings
and encoding queries with the JAX embedder (so everything after the encoder
is compared): the same chunk ids in the same order, the same sources and
graph results, scores within 1e-4 (f32 products summed in another order).
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragfin_tpu.config.settings import Settings as JSettings
from ragfin_tpu.eval.distractors import generate_distractors as j_generate
from ragfin_tpu.ops.fusion import fuse_results as j_fuse
from ragfin_tpu.serving.engine import RagFinEngine as JEngine
from ragfin_tpu_torch.config.settings import Settings as TSettings
from ragfin_tpu_torch.eval.distractors import generate_distractors as t_generate
from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex as TIndex
from ragfin_tpu_torch.ops.fusion import fuse_results as t_fuse
from ragfin_tpu_torch.serving.engine import RagFinEngine as TEngine

SCORE_TOL = 1e-4


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("shape", [(1, 8, 8), (3, 16, 4), (2, 4, 32), (1, 1, 1), (2, 5, 0), (1, 0, 6)])
def test_fuse_results_random(seed, shape):
    q, kv, g = shape
    rng = np.random.default_rng(seed)
    vec = rng.integers(0, 12, size=(q, kv)).astype(np.int32)
    vec[rng.uniform(size=vec.shape) < 0.25] = -1  # padding anywhere
    graph = rng.integers(0, 12, size=(g,)).astype(np.int32)  # repeats and overlap are likely
    graph[rng.uniform(size=graph.shape) < 0.2] = -1
    for k_out in (1, 6, 20, 64):
        jf, jo = j_fuse(jnp.asarray(vec), jnp.asarray(graph), k_out)
        tf, to = t_fuse(torch.from_numpy(vec), torch.from_numpy(graph), k_out)
        assert tf.dtype == to.dtype == torch.int32
        assert np.array_equal(np.asarray(jf), tf.numpy())
        assert np.array_equal(np.asarray(jo), to.numpy())


def test_fuse_results_order_by_hand():
    vec = torch.tensor([[5, -1, 7, 2]], dtype=torch.int32)
    graph = torch.tensor([7, 9, -1, 9, 3, 5], dtype=torch.int32)
    fused, origin = t_fuse(vec, graph, 8)
    assert fused[0].tolist() == [5, 7, 2, 9, 3, -1, -1, -1]
    assert origin[0].tolist() == [0, 0, 0, 1, 1, -1, -1, -1]


N_CHUNKS = 400
SEED = 5


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) over the same corpus and embeddings, each
    with its graph built from its vector index by rule-based extraction."""
    j_chunks, t_chunks = j_generate(N_CHUNKS, seed=SEED), t_generate(N_CHUNKS, seed=SEED)
    jeng = JEngine(
        settings=JSettings(default_model="fake", embed_backend="trained", index_dir="",
                           batch_queries=False),
        chunks=j_chunks,
    )
    jidx = jeng.vector_index
    emb = np.asarray(jidx.matrix_t, np.float32)[:, : jidx.n].T.copy()
    tidx = TIndex(emb, t_chunks, normalize=False, device="cpu")
    tidx.embedder = jidx.embedder
    teng = TEngine(
        settings=TSettings(embed_backend="trained", index_dir="", batch_queries=False),
        vector_index=tidx, device="cpu",
    )
    built_j = jeng.graph_builder.build_from_vector_index(jeng.vector_index)
    built_t = teng.graph_builder.build_from_vector_index(teng.vector_index)
    assert built_j == built_t and built_t["chunks_processed"] == N_CHUNKS
    yield jeng, teng
    jeng.close()
    teng.close()


QUESTIONS = [
    "What was HDFC Bank's net profit in Q1 FY2024?",
    "How did Axis Bank's net profit evolve across all quarters?",
    "How did the retail segment of SBI do?",
    "Which quarter did Kotak Bank's net profit peak?",
    "Which quarter had the lowest cost ratio for Yes Bank?",
    "What were total customer deposits?",
    "hello there",
]


@pytest.mark.parametrize("question", QUESTIONS)
def test_hybrid_query_matches_jax(engines, question):
    jeng, teng = engines
    want = asyncio.run(jeng.hybrid.hybrid_query(question, vector_k=10, k_out=20))
    got = asyncio.run(teng.hybrid.hybrid_query(question, vector_k=10, k_out=20))
    assert [c["id"] for c in got["chunks"]] == [c["id"] for c in want["chunks"]]
    assert [c["source"] for c in got["chunks"]] == [c["source"] for c in want["chunks"]]
    np.testing.assert_allclose(
        [c["score"] for c in got["chunks"]], [c["score"] for c in want["chunks"]],
        rtol=0, atol=SCORE_TOL,
    )
    for key in ("vector_hits", "graph_hits", "graph_strategy", "graph_entities"):
        assert got[key] == want[key], key
    _rows_close(got["graph_results"], want["graph_results"])


def _rows_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = dict(a), dict(b)
        if "mean" in a:
            assert a.pop("mean") == pytest.approx(b.pop("mean"), rel=1e-5)
        assert a == b


def test_hybrid_fused_order_and_sources(engines):
    """Vector hits first, then graph-only chunks at score 1.0, no repeats."""
    _, teng = engines
    graph_only = 0
    for q in QUESTIONS:
        out = teng.hybrid.hybrid_query_simple(q, vector_k=5, k_out=12)
        sources = [c["source"] for c in out["chunks"]]
        n_vec = sources.count("vector")
        assert n_vec == out["vector_hits"] == 5 and sources[:n_vec] == ["vector"] * n_vec
        assert set(sources[n_vec:]) <= {"graph"}
        ids = [c["id"] for c in out["chunks"]]
        assert len(ids) == len(set(ids))
        assert all(c["score"] == 1.0 for c in out["chunks"][n_vec:])
        graph_only += len(sources) - n_vec
    assert graph_only > 0


def test_graph_search_and_builder_query(engines):
    jeng, teng = engines
    for q in QUESTIONS[:5]:
        got = asyncio.run(teng.hybrid.graph_search(q))
        want = asyncio.run(jeng.hybrid.graph_search(q))
        assert got["strategy"] == want["strategy"]
        _rows_close(got["results"], want["results"])
        _rows_close(asyncio.run(teng.graph_builder.query(q)), asyncio.run(jeng.graph_builder.query(q)))
    assert teng.graph.stats() == jeng.graph.stats()
