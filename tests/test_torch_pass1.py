"""Pass 1 of the f32/bf16 fused and pruned top-k kernels (csrc/fused_pass1.cuh),
modelled on the CPU where the card is absent:

- the selection (ops/merge_cases.py queue_topk_plain, the plain model of the
  kernel's gate, queues and drains) against the fused kernels' selection
  contract (ops/topk.py _fused_select), under hypothesis: ties inside and
  across tiles and queue batches, -inf columns, a ragged ``limit``, k from 1
  to 128, queues of 16 to 64 entries, and chunks merged as pass 2 merges
  them (tests/test_torch_select_model.py models the protocol itself);
- the tensor-core products as the kernel forms them, emulated in numpy:
  3xTF32 (cvt.rna rounding: to nearest, ties away from zero) and the
  three-way bf16 split of f32 queries, each against an f64 product (max
  error under 1e-6 on unit vectors at D = 384) and in ids against the
  numpy oracle of tests/test_topk.py outside 1e-5 tie bands;
- the wrapper's tile rule (query rows per block against shared memory).

The card-only tests (marked ``cuda``) run every (dtype, tier, rows per
block) path of the kernels, flat and tile-major, an odd D and an unaligned
corpus, against the plain versions.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ragfin_tpu_torch.ops import ivf as tivf
from ragfin_tpu_torch.ops import topk as ttopk
from ragfin_tpu_torch.ops.merge_cases import queue_topk_plain

INT32_MAX = 0x7FFFFFFF


# --- the selection ---------------------------------------------------


def _masked(scores, limit):
    s = scores.clone()
    s[:, limit:] = float("-inf")
    return s


@settings(max_examples=60, deadline=None)
@given(
    rows=st.integers(1, 3),
    n=st.integers(1, 700),
    k=st.integers(1, 128),
    cap=st.sampled_from([16, 32, 64]),
    cut=st.floats(0.0, 1.0),
    seed=st.integers(0, 2**31 - 1),
    levels=st.integers(1, 6),
)
def test_twolevel_selection_equals_fused_select(rows, n, k, cap, cut, seed, levels):
    rng = np.random.default_rng(seed)
    # Few distinct values: ties everywhere, inside a queue's batch, across
    # batches and across tiles; some columns -inf.
    pool = np.concatenate([rng.standard_normal(levels), [-np.inf]]).astype(np.float32)
    scores = torch.from_numpy(rng.choice(pool, (rows, n)).astype(np.float32))
    limit = int(cut * n)
    got_s, got_i = queue_topk_plain(scores, k, cap=cap, limit=limit)
    want_s, want_i = ttopk._fused_select(_masked(scores, limit), k)
    assert torch.equal(got_s, want_s)
    assert torch.equal(got_i, want_i)


@settings(max_examples=30, deadline=None)
@given(n=st.integers(2, 900), k=st.integers(1, 64), chunks=st.integers(1, 5),
       seed=st.integers(0, 2**31 - 1))
def test_chunks_merged_as_pass_two_equal_one_walk(n, k, chunks, seed):
    """Each chunk walks its columns alone (ids offset by its first column);
    merging the partial lists in (score desc, id asc) order gives the whole
    walk's result, whatever the chunking."""
    rng = np.random.default_rng(seed)
    scores = torch.from_numpy(rng.choice(np.float32([0.5, 0.25, -1.0, 2.0]), (2, n)))
    bounds = np.linspace(0, n, chunks + 1).astype(int) // 128 * 128
    bounds[-1] = n
    parts_s, parts_i = [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        if b <= a:
            continue
        s, i = queue_topk_plain(scores[:, a:b], k)
        parts_s.append(s)
        parts_i.append(torch.where(i == INT32_MAX, i, i + int(a)))
    cat_s, cat_i = torch.cat(parts_s, 1), torch.cat(parts_i, 1)
    order = np.lexsort((cat_i.numpy(), -cat_s.numpy()), axis=1)[:, :k]
    merged_s = torch.gather(cat_s, 1, torch.from_numpy(order))
    merged_i = torch.gather(cat_i, 1, torch.from_numpy(order))
    want_s, want_i = ttopk._fused_select(scores, k)
    w = min(k, merged_s.shape[1])
    assert torch.equal(merged_s[:, :w], want_s[:, :w]) and torch.equal(merged_i[:, :w], want_i[:, :w])


def test_all_minus_inf_row_and_k_above_valid_columns():
    scores = torch.tensor([[float("-inf")] * 200, [1.0] * 3 + [float("-inf")] * 197])
    s, i = queue_topk_plain(scores, 8, limit=150)
    assert torch.isneginf(s[0]).all() and (i[0] == INT32_MAX).all()
    assert s[1, :3].tolist() == [1.0] * 3 and i[1, :3].tolist() == [0, 1, 2]
    assert torch.isneginf(s[1, 3:]).all() and (i[1, 3:] == INT32_MAX).all()


# --- the tensor-core products, emulated ------------------------------------------


def tf32_rna(x):
    """cvt.rna.tf32.f32: keep 10 mantissa bits, to nearest, ties away from zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(x):
    hi = tf32_rna(x)
    return hi, tf32_rna((x - hi).astype(np.float32))


def product_3xtf32(q, ct):
    """res*head + head*res + head*head, products exact, sums in f64."""
    qh, ql = split_tf32(q)
    ch, cl = split_tf32(ct)
    f = lambda a, b: a.astype(np.float64) @ b.astype(np.float64)
    return (f(ql, ch) + f(qh, cl) + f(qh, ch)).astype(np.float32)


def bf16_rne(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def split_bf16x3(q):
    parts, rest = [], q.astype(np.float32)
    for _ in range(3):
        p = bf16_rne(rest)
        parts.append(p)
        rest = (rest - p).astype(np.float32)
    return parts


def product_bf16_split(q, ct_bf16):
    c = ct_bf16.astype(np.float64)
    return sum(p.astype(np.float64) @ c for p in reversed(split_bf16x3(q))).astype(np.float32)


def _numpy_oracle(q, ct, k):
    """tests/test_topk.py's host oracle: f32 scores, stable descending sort."""
    scores = q @ ct
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, order, axis=1), order


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _ids_equal_outside_tie_bands(ref_s, ref_i, got_i, tol=1e-5):
    k = got_i.shape[1]
    gaps = np.abs(np.diff(ref_s.astype(np.float64), axis=1))
    prev = np.concatenate([np.full((ref_s.shape[0], 1), np.inf), gaps], axis=1)[:, :k]
    nxt = np.concatenate([gaps, np.full((ref_s.shape[0], 1), np.inf)], axis=1)[:, :k]
    strict = (prev > tol) & (nxt > tol)
    return np.array_equal(ref_i[:, :k][strict], got_i[strict])


def test_tf32_rounding_is_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0**-10)  # tf32 spacing at 1
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 4, one + 3 * ulp / 4], np.float32)
    np.testing.assert_array_equal(tf32_rna(x), np.array([one + ulp, -(one + ulp), one, one + ulp],
                                                        np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_3xtf32_is_f32_accurate(seed):
    rng = np.random.default_rng(seed)
    ct = _unit(rng, 3000, 384).T.copy()
    q = _unit(rng, 16, 384)
    exact = q.astype(np.float64) @ ct.astype(np.float64)
    got = product_3xtf32(q, ct)
    assert np.max(np.abs(got - exact)) < 1e-6
    one = tf32_rna(q).astype(np.float64) @ tf32_rna(ct).astype(np.float64)
    assert np.max(np.abs(one - exact)) > 1e-5  # one TF32 product alone is not
    es, ei = _numpy_oracle(q, ct, 64)
    gi = np.argsort(-got, axis=1, kind="stable")[:, :64]
    assert _ids_equal_outside_tie_bands(es, ei, gi)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_query_split_is_f32_accurate(seed):
    rng = np.random.default_rng(seed)
    ct = bf16_rne(_unit(rng, 3000, 384).T.copy())
    q = _unit(rng, 16, 384)
    exact = q.astype(np.float64) @ ct.astype(np.float64)
    got = product_bf16_split(q, ct)
    assert np.max(np.abs(got - exact)) < 1e-6
    es, ei = _numpy_oracle(q, ct, 64)
    gi = np.argsort(-got, axis=1, kind="stable")[:, :64]
    assert _ids_equal_outside_tie_bands(es, ei, gi)


def test_bf16_queries_split_into_zero_tails():
    """The kernel takes one product for bf16-valued queries and splits any
    other tile: for bf16 values the split's middle and tail are zero, so the
    two choices give the same sums."""
    rng = np.random.default_rng(3)
    q = bf16_rne(_unit(rng, 8, 384))
    head, mid, tail = split_bf16x3(q)
    np.testing.assert_array_equal(head, q)
    assert not mid.any() and not tail.any()


def test_duplicate_columns_score_bitwise_equal_in_the_emulation():
    rng = np.random.default_rng(4)
    c = _unit(rng, 50, 384)
    ct = np.concatenate([c, c[:10]]).T.copy()
    s = product_3xtf32(_unit(rng, 4, 384), ct)
    np.testing.assert_array_equal(s[:, :10], s[:, 50:])


# --- the wrapper's tile rule --------------------------------------------------------


@pytest.mark.parametrize("nq,item,want", [
    (1, 4, 8), (8, 4, 8), (9, 4, 32), (32, 2, 32), (64, 4, 64), (64, 2, 64), (1024, 4, 64),
])
def test_tile_rule(nq, item, want):
    tq = ttopk._pass1_tile(nq, 384, item)
    assert tq == want and ttopk._pass1_smem(tq, 384, item) <= ttopk._SMEM_LIMIT


def test_tile_rule_refuses_what_no_tile_holds():
    assert ttopk._pass1_tile(64, 384, 4, allowed=(8,)) == 8
    assert ttopk._pass1_tile(64, 768, 4) == 32  # 64 rows of D = 768 do not fit
    with pytest.raises(ValueError, match="shared memory"):
        ttopk._pass1_tile(64, 8192, 4)


# --- on the card ---------------------------------------------------------------------


@pytest.mark.cuda
class TestOnCard:
    @pytest.fixture(autouse=True)
    def _need_card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card; the CPU has no kernel to launch")

    @pytest.mark.parametrize("nq", [3, 20, 64])
    @pytest.mark.parametrize("dtype,precision", [("f32", "exact"), ("bf16", "exact"),
                                                 ("bf16", "fast")])
    @pytest.mark.parametrize("layout", ["flat", "tiled", "odd_d", "unaligned"])
    def test_fused_paths_match_plain(self, nq, dtype, precision, layout):
        rng = np.random.default_rng(nq)
        d = 383 if layout == "odd_d" else 384
        n = 5001 if layout == "unaligned" else 5120
        c = _unit(rng, n, d)
        c[100:110] = c[:10]  # bitwise duplicates across tiles
        dev = torch.device("cuda")
        ct = torch.from_numpy(c.T.copy()).to(dev)
        if dtype == "bf16":
            ct = ct.to(torch.bfloat16)
        if layout == "tiled":
            ct = ttopk.tile_corpus_t(ct, 256)
        q = torch.from_numpy(_unit(rng, nq, d)).to(dev)
        q[0] = torch.from_numpy(c[3]).to(dev)
        before = ttopk.cosine_topk_fused.launches
        s, i = ttopk.cosine_topk_fused(q, ct, 64, n_valid=n - 7, precision=precision)
        torch.cuda.synchronize()
        assert ttopk.cosine_topk_fused.launches == before + 1
        ps, pi = ttopk.fused_topk_plain(q, ct, 65, n_valid=n - 7, precision=precision)
        s, i, ps, pi = (x.cpu().numpy() for x in (s, i, ps, pi))
        assert np.max(np.abs(s - ps[:, :64])) <= 1e-5
        assert _ids_equal_outside_tie_bands(ps, pi, i)
        if dtype == "f32" or precision == "exact":
            assert i[0, 0] == 3 and i[0, 1] == 103 and s[0, 0] == s[0, 1]

    @pytest.mark.parametrize("block_q", [8, 32, 64])
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_pruned_paths_match_plain(self, block_q, dtype):
        rng = np.random.default_rng(block_q)
        dev = torch.device("cuda")
        ct = torch.from_numpy(_unit(rng, 8192, 384).T.copy()).to(dev)
        index = tivf.build_ivf(ct, cell=512, seed=0)
        if dtype == "bf16":
            index = index._replace(cells=index.cells.to(torch.bfloat16))
        q = torch.from_numpy(_unit(rng, 64, 384)).to(dev)
        qin, qs, probe, _ = tivf.stage_queries(q, index, 4, block_q, "exact")
        args = (qin, qs, index.cells, index.scales, probe, index.n_valid)
        s, i = tivf.pruned_topk(*args, 64, block_q)
        torch.cuda.synchronize()
        ps, pi = tivf.pruned_topk_plain(*args, 65, block_q)
        s, i, ps, pi = (x.cpu().numpy() for x in (s, i, ps, pi))
        assert np.max(np.abs(s - ps[:, :64])) <= 1e-5
        assert _ids_equal_outside_tie_bands(ps, pi, i)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_ceiling_stages_at_64_rows(self, dtype):
        from ragfin_tpu_torch.ops import ceiling as C

        rng = np.random.default_rng(7)
        dev = torch.device("cuda")
        ct = torch.from_numpy(rng.standard_normal((384, 20000)).astype(np.float32)).to(dev).to(dtype)
        q = torch.from_numpy(rng.standard_normal((64, 384)).astype(np.float32)).to(dev)
        for stage in C.ladder_stages(dtype):
            got = C.ceiling(q, ct, stage, 1024, n_valid=19990)
            want = C.ceiling_plain(q, ct, stage, 1024, n_valid=19990)
            assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), stage
