"""The port's IVF index against the JAX package's, on the CPU.

``ivf_topk``: the port (probe stage, the pruned kernel's plain version, id
mapping) against the JAX function with its Pallas kernel in interpret mode,
on a JAX-built index carried across with ``ivf_from_numpy`` so that both
sides search the same clustering. f32 "exact": scores within 1e-5 (f32
products summed in another order), ids equal outside 1e-5 tie bands. int8:
scores bitwise equal (integer dot products, then the same two f32
multiplies in the same order) and ids equal. ``build_ivf``: invariants, and
the same assignment as JAX's on a well-separated clustered corpus.
``IVFVectorIndex``: exact repair, tie expansion, save/load across packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ragfin_tpu.index.ivf_index import IVFVectorIndex as JIVF
from ragfin_tpu.index.ivf_index import _dup_groups_from_rows as j_dup_groups
from ragfin_tpu.ops import ivf as J
from ragfin_tpu_torch.data.models import IndexedChunk
from ragfin_tpu_torch.index import ivf_index as TI
from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex as TIndex
from ragfin_tpu_torch.ops import ivf as T
from ragfin_tpu_torch.ops.topk import INT32_MAX, cosine_topk_dense

TOL = 1e-5
N, D, CELL, N_CLUSTERS = 1000, 32, 128, 8


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _clustered(n=N, d=D, clusters=N_CLUSTERS, seed=0, spread=1.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, d)) * 3
    return _unit(centers[rng.integers(0, clusters, n)] + spread * rng.normal(size=(n, d)))


def _queries(q, seed, d=D):
    return _unit(np.random.default_rng(seed).normal(size=(q, d)))


def _carry(ji, device="cpu"):
    cells = np.asarray(ji.cells)
    if ji.cells.dtype == jnp.bfloat16:
        cells = cells.view(np.uint16)
    return T.ivf_from_numpy(
        cells, None if ji.scales is None else np.asarray(ji.scales),
        np.asarray(ji.centroids), np.asarray(ji.orig_ids), ji.n_valid, device=device,
    )


@pytest.fixture(scope="module")
def corpus():
    return _clustered()


@pytest.fixture(scope="module")
def indexes(corpus):
    """{tier: (JAX index, the same index carried into the port)}."""
    out = {}
    for tier, kw in (("f32", {}), ("int8", dict(quantize=True)), ("bf16", {})):
        ji = J.build_ivf(jnp.asarray(corpus.T), cell=CELL, **kw)
        if tier == "bf16":  # XLA on the CPU has no bf16 x bf16 product to build with
            ji = ji._replace(cells=ji.cells.astype(jnp.bfloat16))
        out[tier] = (ji, _carry(ji))
    return out


def _ids_equal_outside_tie_bands(s, a, b, tol=TOL):
    s = np.asarray(s, np.float64)
    gaps = np.abs(np.diff(s, axis=1))
    inf = np.full((s.shape[0], 1), np.inf)
    prev, nxt = np.concatenate([inf, gaps], 1), np.concatenate([gaps, np.zeros_like(inf)], 1)
    strict = (prev > tol) & (nxt > tol)
    return bool(np.array_equal(np.asarray(a)[strict], np.asarray(b)[strict]))


@pytest.mark.parametrize("block_q", [8, 16])
@pytest.mark.parametrize("nprobe", [1, 3, 8])
@pytest.mark.parametrize("q", [1, 5, 16, 19])  # 5 and 19 are not multiples of block_q
def test_ivf_topk_f32_exact_vs_jax_interpret(indexes, q, nprobe, block_q):
    ji, ti = indexes["f32"]
    qs = _queries(q, seed=q)
    js, jid = J.ivf_topk(jnp.asarray(qs), ji, 10, nprobe=nprobe, block_q=block_q,
                         precision="exact", interpret=True)
    ts, tid = T.ivf_topk(torch.from_numpy(qs), ti, 10, nprobe=nprobe, block_q=block_q,
                         precision="exact")
    assert ts.shape == (q, 10) and tid.dtype == torch.int32
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=0, atol=TOL)
    assert _ids_equal_outside_tie_bands(np.asarray(js), np.asarray(jid), tid.numpy())


@pytest.mark.parametrize("nprobe", [2, 8])
@pytest.mark.parametrize("q", [1, 7, 16])
def test_ivf_topk_int8_bitwise_vs_jax_interpret(indexes, q, nprobe):
    ji, ti = indexes["int8"]
    qs = _queries(q, seed=100 + q)
    js, jid = J.ivf_topk(jnp.asarray(qs), ji, 12, nprobe=nprobe, block_q=8, interpret=True)
    ts, tid = T.ivf_topk(torch.from_numpy(qs), ti, 12, nprobe=nprobe, block_q=8)
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert np.array_equal(np.asarray(jid), tid.numpy())


@pytest.mark.parametrize("precision", ["fast", "exact"])
def test_ivf_topk_bf16_vs_jax_interpret(indexes, precision):
    ji, ti = indexes["bf16"]
    assert ti.cells.dtype == torch.bfloat16
    qs = _queries(9, seed=7)
    # XLA on the CPU has no bf16 x bf16 product, so JAX's "fast" tier is run
    # as its "exact" one (bf16 cells widened to f32) over queries rounded to
    # bf16 first: the same products, each exact in f32.
    jq = jnp.asarray(qs)
    if precision == "fast":
        jq = jq.astype(jnp.bfloat16).astype(jnp.float32)
    js, jid = J.ivf_topk(jq, ji, 10, nprobe=4, block_q=8, precision="exact", interpret=True)
    ts, tid = T.ivf_topk(torch.from_numpy(qs), ti, 10, nprobe=4, block_q=8, precision=precision)
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=0, atol=TOL)
    assert _ids_equal_outside_tie_bands(np.asarray(js), np.asarray(jid), tid.numpy())


def test_k_above_the_probed_columns_pads_with_sentinels(indexes):
    ji, ti = indexes["f32"]
    qs = _queries(3, seed=3)
    k = CELL + 20  # one probed cell holds fewer columns than k
    js, jid = J.ivf_topk(jnp.asarray(qs), ji, k, nprobe=1, block_q=8, precision="exact",
                         interpret=True)
    ts, tid = T.ivf_topk(torch.from_numpy(qs), ti, k, nprobe=1, block_q=8, precision="exact")
    assert np.array_equal(np.asarray(jid) == INT32_MAX, tid.numpy() == INT32_MAX)
    assert (tid.numpy() == INT32_MAX).any() and np.isneginf(ts.numpy()[tid.numpy() == INT32_MAX]).all()
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("tier", ["f32", "int8"])
def test_full_probe_equals_the_exact_oracle(indexes, corpus, tier):
    _, ti = indexes[tier]
    qs = _queries(11, seed=5)
    ts, tid = T.ivf_topk(torch.from_numpy(qs), ti, 10, nprobe=ti.n_cells, block_q=8,
                         precision="exact")
    exact = qs.astype(np.float64) @ corpus.T.astype(np.float64)
    order = np.argsort(-exact, axis=1, kind="stable")[:, :10]
    if tier == "f32":
        np.testing.assert_allclose(ts.numpy(), np.take_along_axis(exact, order, 1), rtol=0, atol=TOL)
        assert _ids_equal_outside_tie_bands(ts.numpy(), order, tid.numpy())
        ds, di = cosine_topk_dense(torch.from_numpy(qs), torch.from_numpy(corpus.T.copy()), 10)
        np.testing.assert_allclose(ts.numpy(), ds.numpy(), rtol=0, atol=TOL)
        assert _ids_equal_outside_tie_bands(ds.numpy(), di.numpy(), tid.numpy())
    else:  # int8 scores carry quantization error: the neighbours are the oracle's
        overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(order, tid.numpy())])
        assert overlap >= 0.9


@pytest.mark.parametrize("n", [1000, 1024, 130])
@pytest.mark.parametrize("quantize", [False, True])
def test_build_ivf_invariants(n, quantize):
    x = _clustered(n=n, seed=2)
    idx = T.build_ivf(torch.from_numpy(x.T.copy()), cell=CELL, quantize=quantize)
    n_cells = -(-n // CELL)
    assert tuple(idx.cells.shape) == (n_cells, D, CELL) and idx.n_valid == n
    assert idx.cells.dtype == (torch.int8 if quantize else torch.float32)
    assert (idx.scales is not None) == quantize
    ids = idx.orig_ids.numpy()
    assert ids.shape == (n_cells * CELL,)
    # Pads last, and the real ids are a permutation of range(n).
    assert (ids[:n] != INT32_MAX).all() and (ids[n:] == INT32_MAX).all()
    assert np.array_equal(np.sort(ids[:n]), np.arange(n))
    if not quantize:  # every column is the corpus vector its id names
        flat = idx.cells.permute(1, 0, 2).reshape(D, -1).numpy()
        assert np.array_equal(flat[:, :n], x.T[:, ids[:n]])
        assert not flat[:, n:].any()


@pytest.mark.parametrize("quantize", [False, True])
def test_build_ivf_assignment_equals_jax_on_separated_clusters(quantize):
    x = _clustered(n=1024, clusters=8, seed=4, spread=0.3)
    ji = J.build_ivf(jnp.asarray(x.T), cell=CELL, quantize=quantize)
    ti = T.build_ivf(torch.from_numpy(x.T.copy()), cell=CELL, quantize=quantize)
    assert np.array_equal(np.asarray(ji.orig_ids), ti.orig_ids.numpy())
    np.testing.assert_allclose(np.asarray(ji.centroids), ti.centroids.numpy(), rtol=0, atol=1e-6)
    assert np.array_equal(np.asarray(ji.cells), ti.cells.numpy())
    if quantize:
        assert np.array_equal(np.asarray(ji.scales), ti.scales.numpy())


@pytest.mark.parametrize("n", [1024, 1000])  # 1000: the build pads its own copy
@pytest.mark.parametrize("quantize", [False, True])
def test_build_ivf_free_source_same_index(n, quantize):
    """``free_source`` drops the build's reference to the source early; the
    index is the same with it on and off, and equal to JAX's build with it
    on. The caller's tensor is untouched."""
    x = _clustered(n=n, clusters=8, seed=4, spread=0.3)
    ct = torch.from_numpy(x.T.copy())
    off = T.build_ivf(ct, cell=CELL, quantize=quantize)
    on = T.build_ivf(ct, cell=CELL, quantize=quantize, free_source=True)
    assert torch.equal(ct, torch.from_numpy(x.T))
    for a, b in zip(off, on):
        assert a == b if isinstance(a, int) else (a is None and b is None) or torch.equal(a, b)
    ji = J.build_ivf(jnp.asarray(x.T), cell=CELL, quantize=quantize, free_source=True)
    assert np.array_equal(np.asarray(ji.orig_ids), on.orig_ids.numpy())
    np.testing.assert_allclose(np.asarray(ji.centroids), on.centroids.numpy(), rtol=0, atol=1e-6)
    assert np.array_equal(np.asarray(ji.cells), on.cells.numpy())
    if quantize:
        assert np.array_equal(np.asarray(ji.scales), on.scales.numpy())


def _records(n):
    return [IndexedChunk(id=f"c{i}", text=f"chunk {i}", period="Q1_FY2024", chunk_type="x")
            for i in range(n)]


def test_vector_index_repair_is_exact_at_full_probe(corpus):
    for quantize in (False, True):
        idx = TI.IVFVectorIndex.build(corpus, _records(N), cell=CELL, quantize=quantize,
                                      normalize=False, device="cpu")
        qs = _queries(6, seed=9)
        s, i = idx.search_embeddings(qs, top_k=10, nprobe=idx.ivf.n_cells)
        exact = qs @ corpus.T
        order = np.argsort(-exact, axis=1, kind="stable")[:, :10]
        assert np.array_equal(i, order)
        np.testing.assert_allclose(s, np.take_along_axis(exact, order, 1), rtol=0, atol=TOL)
        raw_s, raw_i = idx.search_embeddings(qs, top_k=10, exact_repair=False)
        assert isinstance(raw_i, torch.Tensor) and raw_i.shape == (6, 10)
        assert idx.stats()["exact_repair"] and idx.stats()["quantized"] == quantize


def test_expand_ties_on_a_wide_duplicate_group():
    """200 bitwise-equal rows tie at the top: the kernel keeps those at the
    lowest PERMUTED positions, the repair returns the lowest ORIGINAL ids,
    on both sides."""
    x = _clustered(n=900, seed=6)
    x[100:300] = x[100]
    recs = _records(900)
    t = TI.IVFVectorIndex.build(x, recs, cell=CELL, normalize=False, device="cpu")
    j = JIVF.build(x, recs, cell=CELL, normalize=False)
    q = x[100:101]
    ts, tid = t.search_embeddings(q, top_k=10, nprobe=t.ivf.n_cells)
    js, jid = j.search_embeddings(q, top_k=10, nprobe=j.ivf.n_cells)
    assert tid[0].tolist() == list(range(100, 110)) == np.asarray(jid)[0].tolist()
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=TOL)
    groups_t = TI._dup_groups_from_rows(x)
    for a, b in zip(groups_t, j_dup_groups(x)):
        assert np.array_equal(a, b)
    assert TI._dup_groups_from_rows(x[:100]) is None


def _hit_lists(hits):
    return [[(h.id, h.rank) for h in row] for row in hits], [[h.score for h in row] for row in hits]


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_save_in_one_package_load_in_the_other(corpus, tmp_path, direction, quantize):
    recs = _records(N)
    qs = _queries(5, seed=12)
    if direction == "jax_to_torch":
        src = JIVF.build(corpus, recs, cell=CELL, quantize=quantize, normalize=False, nprobe=3)
        src.save(str(tmp_path))
        dst = TI.IVFVectorIndex.load(str(tmp_path), device="cpu")
    else:
        src = TI.IVFVectorIndex.build(corpus, recs, cell=CELL, quantize=quantize,
                                      normalize=False, nprobe=3, device="cpu")
        src.save(str(tmp_path))
        dst = JIVF.load(str(tmp_path))
    assert dst.stats() == src.stats() and dst.nprobe == 3
    assert [r.model_dump() for r in dst.records] == [r.model_dump() for r in src.records]
    for repair in (True, False):
        a_s, a_i = src.search_embeddings(qs, top_k=8, exact_repair=repair)
        b_s, b_i = dst.search_embeddings(qs, top_k=8, exact_repair=repair)
        a_s, a_i, b_s, b_i = (np.asarray(TI._host(v)) for v in (a_s, a_i, b_s, b_i))
        # The saved shadow is f16: repaired scores are equal on both sides
        # of the save only to f16 resolution of the rows.
        np.testing.assert_allclose(a_s, b_s, rtol=0, atol=2e-3 if repair else TOL)
        if not repair:
            assert _ids_equal_outside_tie_bands(a_s, a_i, b_i)


def test_bf16_cells_round_trip(corpus, tmp_path):
    ji = J.build_ivf(jnp.asarray(corpus.T), cell=CELL)
    ji = ji._replace(cells=ji.cells.astype(jnp.bfloat16))
    j = JIVF(ji, _records(N), nprobe=4)
    j.save(str(tmp_path / "a"))
    t = TI.IVFVectorIndex.load(str(tmp_path / "a"), device="cpu")
    assert t.dtype == torch.bfloat16
    assert np.array_equal(np.asarray(ji.cells).view(np.uint16),
                          t.ivf.cells.view(torch.int16).numpy().view(np.uint16))
    t.save(str(tmp_path / "b"))
    back = JIVF.load(str(tmp_path / "b"))
    assert np.array_equal(np.asarray(back.ivf.cells).view(np.uint16), np.asarray(ji.cells).view(np.uint16))


def test_hashed_branches_raise(corpus, tmp_path):
    """The hashed branches of IVF persistence are ported; what still raises
    is what raises in JAX: a state that says the projection was tuned
    without its table, and text search with no encoder attached."""
    idx = TI.IVFVectorIndex.build(corpus, _records(N), cell=CELL, normalize=False, device="cpu")
    idx.save(str(tmp_path))
    import json

    meta = json.load(open(tmp_path / "ivf.json"))
    meta["encoder"] = {"vocab_size": 64, "dim": corpus.shape[1], "seed": 0, "tuned": True}
    json.dump(meta, open(tmp_path / "ivf.json", "w"))
    with pytest.raises(ValueError, match="tuned"):
        TI.IVFVectorIndex.load(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="no embedder"):
        TI.IVFVectorIndex(idx.ivf, _records(N)).search_texts(["q"])


def test_from_dense_keeps_tier_and_embedder(corpus):
    for dtype in ("float32", "int8"):
        dense = TIndex(corpus, _records(N), dtype=dtype, normalize=False, device="cpu")
        dense.embedder = object()
        ivf = TI.IVFVectorIndex.from_dense(dense, cell=CELL, nprobe=4)
        assert ivf.quantized == (dtype == "int8") and ivf.embedder is dense.embedder
        assert ivf.n == N and ivf.dim == D and len(ivf) == N and "c5" in ivf
        assert not ivf.supports_filters and str(ivf.device) == "cpu"


def test_pruned_topk_refuses_mismatched_inputs(indexes):
    _, ti = indexes["f32"]
    probe = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        T.pruned_topk(torch.zeros((5, D)), None, ti.cells, None, probe, ti.n_valid, 4, 8)
    with pytest.raises(TypeError):
        T.pruned_topk(torch.zeros((8, D), dtype=torch.int8), None, ti.cells, None, probe, ti.n_valid, 4, 8)


def test_cpu_calls_count_no_launch(indexes):
    _, ti = indexes["f32"]
    before = T.pruned_topk.launches
    T.ivf_topk(torch.from_numpy(_queries(3, seed=1)), ti, 5, nprobe=2, block_q=8)
    assert T.pruned_topk.launches == before


@pytest.mark.cuda
class TestOnCard:
    """Runs only where a CUDA card is present (chip_smoke.py covers the same
    comparisons at 1,000,000 vectors and cells of 2048)."""

    @pytest.fixture(autouse=True)
    def _need_card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card; the CPU has no kernel to launch")

    @pytest.mark.parametrize("tier", ["f32", "bf16", "int8"])
    @pytest.mark.parametrize("q,block_q", [(1, 8), (19, 8), (40, 32)])
    def test_pruned_kernel_matches_plain(self, indexes, tier, q, block_q):
        ji, _ = indexes[tier]
        index = _carry(ji, device="cuda")
        precision = "exact" if tier == "f32" else "fast"
        qs = torch.from_numpy(_queries(q, seed=q)).cuda()
        qin, qscale, probe, _ = T.stage_queries(qs, index, 3, block_q, precision)
        args = (qin, qscale, index.cells, index.scales, probe, index.n_valid)
        before = T.pruned_topk.launches
        s, i = T.pruned_topk(*args, 10, block_q)
        ps, pi = T.pruned_topk_plain(*args, 10, block_q)
        assert T.pruned_topk.launches == before + 1
        if tier == "int8":
            assert torch.equal(s, ps) and torch.equal(i, pi)
        else:
            np.testing.assert_allclose(s.cpu().numpy(), ps.cpu().numpy(), rtol=0, atol=TOL)
            assert _ids_equal_outside_tie_bands(ps.cpu().numpy(), pi.cpu().numpy(), i.cpu().numpy())


def _banded(spacing, n_random=700, bands=3, width=150, d=D, seed=21):
    """Random unit rows, and ``bands`` bands of ``width`` rows whose scores
    against their band's query fall by ``spacing`` from 0.9 down (rows
    cos(t) a + sin(t) b, a the query, b a unit vector at right angles to
    it), shuffled together. The random rows score below 0.7."""
    rng = np.random.default_rng(seed)
    rows, queries = [_unit(rng.normal(size=(n_random, d)))], []
    for _ in range(bands):
        a = _unit(rng.normal(size=(1, d)))[0]
        b = rng.normal(size=d)
        b = (b - (b @ a) * a) / np.linalg.norm(b - (b @ a) * a)
        c = 0.9 - spacing * np.arange(width)
        rows.append((c[:, None] * a + np.sqrt(1 - c**2)[:, None] * b).astype(np.float32))
        queries.append(a)
    x = np.concatenate(rows)[rng.permutation(n_random + bands * width)]
    return np.ascontiguousarray(x, np.float32), np.asarray(queries, np.float32)


@pytest.mark.parametrize("spacing", [5e-9, 2e-5])
def test_int8_ivf_full_probe_on_near_duplicate_bands(spacing):
    """The int8 IVF at full probe, as the index serves it (a 64-wide
    shortlist on int8 scores, then the exact host re-score), in both
    packages on one clustering: the same ids. Against the numpy host-exact
    oracle, outside 1e-5 tie bands: a band whose scores lie within 1e-6
    (5e-9 apart) is one tie band, and both packages equal the oracle. A band
    of 150 rows 2e-5 apart, wider than the shortlist, is ordered by the int8
    scores' quantisation error (about 1e-3), not by its gaps: both packages
    miss the same oracle ids, and the f32 index at full probe does not."""
    x, qs = _banded(spacing)
    recs = _records(len(x))
    j = JIVF.build(x, recs, cell=CELL, quantize=True, normalize=False)
    t = TI.IVFVectorIndex(_carry(j.ivf), recs, exact_rows=x)
    js, jid = j.search_embeddings(qs, top_k=10, nprobe=j.ivf.n_cells)
    ts, tid = t.search_embeddings(qs, top_k=10, nprobe=t.ivf.n_cells)
    assert np.array_equal(np.asarray(jid), tid)
    np.testing.assert_array_equal(np.asarray(js), ts)
    exact = qs @ x.T
    order = np.argsort(-exact, axis=1, kind="stable")[:, :10]
    oracle = np.take_along_axis(exact, order, 1)
    own = TI.IVFVectorIndex.build(x, recs, cell=CELL, quantize=True, normalize=False,
                                  device="cpu")
    _, oid = own.search_embeddings(qs, top_k=10, nprobe=own.ivf.n_cells)
    f32 = TI.IVFVectorIndex.build(x, recs, cell=CELL, normalize=False, device="cpu")
    _, fid = f32.search_embeddings(qs, top_k=10, nprobe=f32.ivf.n_cells)
    assert _ids_equal_outside_tie_bands(oracle, order, fid)
    for got in (tid, oid):
        assert _ids_equal_outside_tie_bands(oracle, order, got) == (spacing < 1e-6)
