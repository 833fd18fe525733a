"""The port's mesh, corpus-sharded top-k, ShardedVectorIndex and
distributed helpers (ragfin_tpu_torch.parallel) against the JAX package's
on the same seeded inputs.

The JAX side runs on conftest's 8-device virtual CPU mesh at P devices;
the port's mesh lists the CPU P times, and its fused wrappers run their
plain versions (chip_smoke.py holds the CUDA kernels against those on the
card). Tolerances: f32 ids equal wherever neighbouring scores differ by
more than 1e-5, scores within 1e-5 (summation order differs); int8 scores
and ids bitwise equal (the integer dot is exact and both apply the same
scales in the same order). One test joins two port processes with gloo.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ragfin_tpu.eval.distractors import generate_distractors as j_distractors
from ragfin_tpu.index.vector_index import DeviceVectorIndex as JIndex
from ragfin_tpu.ops.quantize import quantize_corpus_t as j_quantize
from ragfin_tpu.parallel import mesh as jmesh
from ragfin_tpu.parallel import sharded as jsharded
from ragfin_tpu_torch.eval.distractors import generate_distractors as t_distractors
from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex as TIndex
from ragfin_tpu_torch.ops import topk as ttopk
from ragfin_tpu_torch.parallel import distributed as tdist
from ragfin_tpu_torch.parallel import mesh as tmesh
from ragfin_tpu_torch.parallel import sharded as tsharded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _negative_corpus(rng, n, d):
    """Unit vectors all in the half-space opposite the query ``base``."""
    base = _unit(rng, 1, d)[0]
    corpus = _unit(rng, n, d)
    corpus = corpus - 2 * np.maximum(corpus @ base, 0)[:, None] * base
    return corpus / np.linalg.norm(corpus, axis=1, keepdims=True), base[None, :]


def _meshes(p):
    return (jmesh.make_mesh(("data",), devices=jax.devices()[:p]),
            tmesh.make_mesh(("data",), devices=["cpu"] * p))


def _jax_cols(mesh, arr):
    return jax.device_put(jnp.asarray(arr), NamedSharding(mesh, P(None, "data")))


def _same_topk(got, want, tol=TOL):
    """ids equal outside tie bands of ``tol``, scores within ``tol``."""
    gs, gi = (np.asarray(x) for x in got)
    ws, wi = (np.asarray(x) for x in want)
    assert gs.shape == ws.shape and gi.shape == wi.shape
    np.testing.assert_allclose(gs, ws, atol=tol, rtol=0)
    gaps = np.abs(np.diff(ws.astype(np.float64), axis=1))
    inf = np.full((ws.shape[0], 1), np.inf)
    strict = (np.concatenate([inf, gaps], 1) > tol) & (np.concatenate([gaps, inf], 1) > tol)
    np.testing.assert_array_equal(gi[strict], wi[strict])


# --- mesh -----------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 4, 6, 7, 8])
def test_factor_mesh_shape_as_jax(n):
    for axes in (1, 2, 3):
        assert tmesh.factor_mesh_shape(n, axes) == jmesh.factor_mesh_shape(n, axes)


def test_mesh_lists_a_device_many_times():
    m = tmesh.make_mesh(("pp", "dp"), (2, 4), devices=["cpu"] * 8)
    j = jmesh.make_mesh(("pp", "dp"), (2, 4), devices=jax.devices())
    assert m.shape == dict(j.shape) == {"pp": 2, "dp": 4}
    assert m.size == 8 and m.axis_names == ("pp", "dp")
    assert m.axis_devices("dp") == [torch.device("cpu")] * 4
    assert tmesh.make_mesh(("data", "x"), devices=["cpu"] * 3).shape == {"data": 3, "x": 1}


def test_default_mesh_needs_a_card():
    """With no devices passed, the mesh is every CUDA device: without one it
    raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default mesh is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(("data",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.global_corpus_mesh()


def test_collectives():
    cpu = torch.device("cpu")
    parts = [torch.full((2, 3), float(i)) for i in range(4)]
    assert torch.equal(tmesh.all_gather(parts, cpu, 1), torch.cat(parts, 1))
    assert torch.equal(tmesh.psum(parts, cpu), torch.full((2, 3), 6.0))
    x = torch.ones(3, requires_grad=True)
    (tmesh.ppermute(x, cpu) * 2).sum().backward()
    assert torch.equal(x.grad, torch.full((3,), 2.0))
    assert torch.equal(tmesh.gather_processes(parts[1], 0), parts[1])


def test_shard_places_equal_parts():
    mesh = tmesh.make_mesh(("data",), devices=["cpu"] * 4)
    t = torch.arange(24).reshape(2, 12)
    parts = tmesh.shard(mesh, "data", t, 1)
    assert [tuple(p.shape) for p in parts] == [(2, 3)] * 4
    assert torch.equal(torch.cat(parts, 1), t)
    with pytest.raises(ValueError, match="does not split"):
        tmesh.shard(mesh, "data", torch.zeros(2, 10), 1)


# --- sharded top-k ----------------------------------------------------------


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("method", ["auto", "dense", "blocked", "fused"])
def test_sharded_topk_matches_jax(p, method):
    rng = np.random.default_rng(3)
    n, d, q, k = 1024, 64, 7, 9
    corpus, queries = _unit(rng, n, d), _unit(rng, q, d)
    jm, tm = _meshes(p)
    jmethod = method if method == "blocked" else "dense"  # the reference: one function
    want = jsharded.sharded_cosine_topk(jm, "data", jnp.asarray(queries), _jax_cols(jm, corpus.T),
                                        k, n_valid=n, method=jmethod)
    got = tsharded.sharded_cosine_topk(tm, "data", torch.from_numpy(queries),
                                       tmesh.shard(tm, "data", torch.from_numpy(corpus.T.copy()), 1),
                                       k, n_valid=n, method=method)
    assert got[1].dtype == torch.int32
    _same_topk(got, want)


def test_padding_masked_self_retrieval():
    rng = np.random.default_rng(4)
    n, d = 100, 32  # not divisible by 8: padded shards
    corpus = _unit(rng, n, d)
    ct = np.pad(corpus.T, ((0, 0), (0, -n % (8 * 16))))
    jm, tm = _meshes(8)
    want = jsharded.sharded_cosine_topk(jm, "data", jnp.asarray(corpus[:3]), _jax_cols(jm, ct), 5, n_valid=n)
    s, i = tsharded.sharded_cosine_topk(tm, "data", torch.from_numpy(corpus[:3]),
                                        tmesh.shard(tm, "data", torch.from_numpy(ct), 1), 5, n_valid=n)
    assert int(i.max()) < n and i[:, 0].tolist() == [0, 1, 2]
    _same_topk((s, i), want)


@pytest.mark.parametrize("method", ["dense", "blocked", "fused"])
def test_pads_never_displace_negative_scores(method):
    """An all-negative-similarity corpus with about 98 % padding over 8
    shards: six shards are pure padding (their local limit is 0), and the
    result is the true negative-score top-k, as in JAX."""
    rng = np.random.default_rng(7)
    n, d, k = 100, 32, 5
    corpus, query = _negative_corpus(rng, n, d)
    ct = np.pad(corpus.T, ((0, 0), (0, -n % (8 * 128))))
    jm, tm = _meshes(8)
    want = jsharded.sharded_cosine_topk(jm, "data", jnp.asarray(query), _jax_cols(jm, ct), k,
                                        n_valid=n, method=method)
    got = tsharded.sharded_cosine_topk(tm, "data", torch.from_numpy(query),
                                       tmesh.shard(tm, "data", torch.from_numpy(ct), 1), k,
                                       n_valid=n, method=method)
    _same_topk(got, want)
    oracle = np.argsort(-(query @ corpus.T), axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(got[1].numpy(), oracle)
    assert float(got[0].max()) < 0.0


@pytest.mark.parametrize("p", [2, 8])
@pytest.mark.parametrize("negative", [False, True])
def test_sharded_int8_bitwise_equal_to_jax(p, negative):
    rng = np.random.default_rng(8)
    n, d, k = 96, 32, 5
    if negative:
        corpus, query = _negative_corpus(rng, n, d)
    else:
        corpus, query = _unit(rng, n, d), _unit(rng, 3, d)
    ct = np.pad(corpus.T, ((0, 0), (0, -n % (8 * 128)))).astype(np.float32)
    c8, sc = (np.array(a) for a in j_quantize(jnp.asarray(ct)))
    jm, tm = _meshes(p)
    want = jsharded.sharded_cosine_topk(jm, "data", jnp.asarray(query), _jax_cols(jm, c8), k,
                                        n_valid=n, method="int8", scales=_jax_cols(jm, sc))
    got = tsharded.sharded_cosine_topk(
        tm, "data", torch.from_numpy(query), tmesh.shard(tm, "data", torch.from_numpy(c8), 1), k,
        n_valid=n, method="auto", scales=tmesh.shard(tm, "data", torch.from_numpy(sc), 1),
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_int8_requires_scales():
    _, tm = _meshes(2)
    with pytest.raises(ValueError, match="scales"):
        tsharded.sharded_cosine_topk(tm, "data", torch.zeros(1, 8),
                                     tmesh.shard(tm, "data", torch.zeros(8, 64, dtype=torch.int8), 1),
                                     3, n_valid=64, method="int8")


def test_empty_slots_are_sentinels():
    """k past the valid columns: the extra slots are (-inf, INT32_MAX) even
    where a shard's local id plus its base would pass int32."""
    _, tm = _meshes(4)
    ct = torch.from_numpy(_unit(np.random.default_rng(1), 3, 16).T.copy())
    ct = torch.nn.functional.pad(ct, (0, 5))
    s, i = tsharded.sharded_cosine_topk(tm, "data", ct.T[:1].contiguous(),
                                        tmesh.shard(tm, "data", ct, 1), 6, n_valid=3, method="fused")
    assert torch.isinf(s[0, 3:]).all() and (i[0, 3:] == ttopk.INT32_MAX).all()
    assert sorted(i[0, :3].tolist()) == [0, 1, 2]


# --- ShardedVectorIndex ---------------------------------------------------


class _Embedder:
    """A fixed text -> vector map, shared by both packages' indexes."""

    backend = "trained"

    def __init__(self, vectors):
        self.vectors = vectors

    def encode_texts(self, texts):
        return np.stack([self.vectors[t] for t in texts])


@pytest.fixture(scope="module")
def index_data():
    rng = np.random.default_rng(11)
    n, d = 300, 48
    emb = _unit(rng, n, d)
    texts = [f"question {i}" for i in range(5)]
    vectors = {t: v for t, v in zip(texts, _unit(rng, len(texts), d))}
    return emb, texts, _Embedder(vectors), j_distractors(n, seed=5), t_distractors(n, seed=5)


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_sharded_index_from_dense_matches_jax(index_data, p, dtype):
    emb, texts, embedder, j_records, t_records = index_data
    jm, tm = _meshes(p)
    # The rows are unit already: the two packages' normalisations round
    # differently in the last place, which int8 scales would carry.
    j_dense = JIndex(emb, j_records, dtype=dtype, normalize=False)
    t_dense = TIndex(emb, t_records, dtype=dtype, normalize=False, device="cpu")
    j_dense.embedder = t_dense.embedder = embedder
    # An int8 source is dequantized; dtype="int8" quantizes it again.
    j_sh = jsharded.ShardedVectorIndex.from_dense(j_dense, mesh=jm, dtype=dtype)
    t_sh = tsharded.ShardedVectorIndex.from_dense(t_dense, mesh=tm, dtype=dtype)
    assert len(t_sh) == len(j_sh) == emb.shape[0] and t_sh.quantized == (dtype == "int8")
    want = j_sh.search_texts(texts, top_k=7)
    got = t_sh.search_texts(texts, top_k=7)
    for w, g in zip(want, got):
        assert [h.id for h in g] == [h.id for h in w]
        scores_g, scores_w = [h.score for h in g], [h.score for h in w]
        if dtype == "int8":
            assert scores_g == scores_w
        else:
            np.testing.assert_allclose(scores_g, scores_w, atol=TOL, rtol=0)
    if dtype == "float32":  # and equal to the flat index it came from
        flat = t_dense.search_texts(texts, top_k=7)
        assert [[h.id for h in hs] for hs in flat] == [[h.id for h in hs] for hs in got]


def test_sharded_index_normalizes_and_needs_an_encoder(index_data):
    emb, texts, _, j_records, t_records = index_data
    jm, tm = _meshes(2)
    raw = emb * 3.0
    want = jsharded.ShardedVectorIndex(raw, j_records, mesh=jm).search_embeddings(emb[:4], top_k=5)
    t_sh = tsharded.ShardedVectorIndex(raw, t_records, mesh=tm)
    _same_topk(t_sh.search_embeddings(emb[:4], top_k=5), want)
    with pytest.raises(ValueError, match="no embedder"):
        t_sh.search_texts(texts[:1])


# --- distributed ------------------------------------------------------------


def test_initialize_single_process_noop(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    info = tdist.initialize_distributed(num_processes=1, process_id=0)
    assert set(info) == {"process_id", "num_processes", "local_devices", "global_devices"}
    assert info["num_processes"] == 1 and info["process_id"] == 0
    assert not torch.distributed.is_initialized()
    mesh = tdist.global_corpus_mesh(devices=["cpu"] * 4)
    assert mesh.axis_names == ("data",) and mesh.size == 4
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert tdist.initialize_distributed()["num_processes"] == 1


_WORKER = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "flax", "optax", "orbax", "ragfin_tpu"):
        sys.modules[name] = None
    sys.path.insert(0, sys.argv[4])
    import numpy as np
    import torch
    from ragfin_tpu_torch.parallel.distributed import global_corpus_mesh, initialize_distributed
    from ragfin_tpu_torch.parallel.mesh import shard
    from ragfin_tpu_torch.parallel.sharded import sharded_cosine_topk

    rank, port, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    info = initialize_distributed(f"127.0.0.1:{port}", 2, rank)
    assert torch.distributed.get_backend() == "gloo" and info["num_processes"] == 2
    data = np.load(f"{work}/in.npz")
    mesh = global_corpus_mesh(devices=["cpu", "cpu"])
    q = torch.from_numpy(data["q"])
    out = {}
    for method in ("dense", "fused"):
        s, i = sharded_cosine_topk(mesh, "data", q, shard(mesh, "data", torch.from_numpy(data["ct"]), 1),
                                   int(data["k"]), n_valid=int(data["n"]), method=method)
        out[f"{method}_s"], out[f"{method}_i"] = s.numpy(), i.numpy()
    s, i = sharded_cosine_topk(mesh, "data", q, shard(mesh, "data", torch.from_numpy(data["c8"]), 1),
                               int(data["k"]), n_valid=int(data["n"]),
                               scales=shard(mesh, "data", torch.from_numpy(data["sc"]), 1))
    out["int8_s"], out["int8_i"] = s.numpy(), i.numpy()
    np.savez(f"{work}/out{rank}.npz", **out)
    torch.distributed.destroy_process_group()
""")


def test_process_group_merge_matches_jax_4_devices(tmp_path):
    """Two port processes (gloo, no JAX), two CPU shards each: their merged
    top-k equals JAX's on a 4-device mesh, f32 and int8."""
    rng = np.random.default_rng(21)
    n, d, q, k = 500, 32, 5, 8
    corpus, queries = _unit(rng, n, d), _unit(rng, q, d)
    ct = np.pad(corpus.T, ((0, 0), (0, -n % (4 * 128)))).astype(np.float32)
    c8, sc = (np.array(a) for a in j_quantize(jnp.asarray(ct)))
    np.savez(tmp_path / "in.npz", q=queries, ct=ct, c8=c8, sc=sc, k=k, n=n)
    jm = jmesh.make_mesh(("data",), devices=jax.devices()[:4])
    want = jsharded.sharded_cosine_topk(jm, "data", jnp.asarray(queries), _jax_cols(jm, ct), k, n_valid=n)
    want8 = jsharded.sharded_cosine_topk(jm, "data", jnp.asarray(queries), _jax_cols(jm, c8), k,
                                         n_valid=n, method="int8", scales=_jax_cols(jm, sc))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k_: v for k_, v in os.environ.items() if k_ not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(port), str(tmp_path), ROOT],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
    for r in range(2):
        got = np.load(tmp_path / f"out{r}.npz")
        for method in ("dense", "fused"):
            _same_topk((got[f"{method}_s"], got[f"{method}_i"]), want)
        np.testing.assert_array_equal(got["int8_s"], np.asarray(want8[0]))
        np.testing.assert_array_equal(got["int8_i"], np.asarray(want8[1]))
