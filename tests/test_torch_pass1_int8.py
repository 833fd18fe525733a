"""Pass 1 of the fused and pruned top-k kernels over an int8 corpus
(csrc/fused_pass1.cuh with T = int8_t), modelled on the CPU where the card is
absent:

- the s8 fragment packing, in numpy, step by step as the kernel does it: the
  landed ``[kDK, kCS]`` slice of the cp.async ring, the byte transpose each
  producer applies to the rows it copied (``__byte_perm`` with the kernel's
  selectors) into the k-packed ``[kTN, kTBS]`` buffer, the A registers
  ``ldmatrix`` gives each lane, the B registers each lane reads from the
  queries stored in the same k order, and ``mma.m16n8k32`` assembled from
  those registers by the PTX fragment layout; the accumulators scattered to
  the score tile by the kernel's own index formula must equal
  ``q8 @ c8`` in int32 exactly, for random and extreme bytes and D in
  {100, 384, 388};
- the selection (ops/merge_cases.py queue_topk_plain: the gate, queues that
  overflow, drains) on int8-dequantised scores with heavy ties, under
  hypothesis, against the fused kernels' selection contract (ops/topk.py
  _fused_select);
- the wrapper's shared-memory and tile rule for itemsize 1.

The card-only tests (marked ``cuda``) run every int8 instantiation: 8, 32
and 64 query rows, flat and tile-major, PROBED, every ceiling stage, odd N,
D = 100 and 388, k = 1 / 70 / 128 and an all-zero query row, each bitwise
against its plain version.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ragfin_tpu_torch.ops import ivf as tivf
from ragfin_tpu_torch.ops import topk as ttopk
from ragfin_tpu_torch.ops.merge_cases import queue_topk_plain

KDK, KTN, KCS, KTBS, KSTEP = 128, 128, 144, 36, 32  # csrc/fused_pass1.cuh Slice<int8_t>, kTBS
PRODUCERS = 256


def _layout(tq):
    """csrc/fused_pass1.cuh Layout<TQ>: (WC, WQ, SUBW, MT, NT)."""
    wc = 8 if tq == 8 else 4
    wq = 8 // wc
    sub = KTN // wc
    return wc, wq, sub, sub // 16, tq // wq // 8


def byte_perm(x, y, sel):
    """__byte_perm(x, y, s): byte n of the result is byte (s >> 4n) & 7 of
    the eight bytes x.b0..b3, y.b0..b3."""
    src = [(x >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    src += [(y >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(sel >> (4 * n)) & 7] << np.uint32(8 * n)
    return out


def k_packed(ring):
    """The producers' transpose of one landed slice ``ring [KDK, KCS]`` int8
    into the k-packed buffer ``[KTN * KTBS]`` uint32: thread tid copied (and
    now reads) rows lane + 32 i of columns (tid >> 5) * 16 .. + 15, and
    writes column c's word at c * KTBS + lane (transpose_store)."""
    words = np.ascontiguousarray(ring).view(np.uint32)  # [KDK, KCS // 4]
    kp = np.zeros(KTN * KTBS, np.uint32)
    tid = np.arange(PRODUCERS)
    lane, c = tid & 31, (tid >> 5) * 16
    for q in range(4):  # the uint4's .x .y .z .w: columns c + 4q .. + 3
        w0, w1, w2, w3 = (words[lane + 32 * i, c // 4 + q] for i in range(4))
        lo01, hi01 = byte_perm(w0, w1, 0x5140), byte_perm(w0, w1, 0x7362)
        lo23, hi23 = byte_perm(w2, w3, 0x5140), byte_perm(w2, w3, 0x7362)
        dst = (c + 4 * q) * KTBS + lane
        kp[dst] = byte_perm(lo01, lo23, 0x5410)
        kp[dst + KTBS] = byte_perm(lo01, lo23, 0x7632)
        kp[dst + 2 * KTBS] = byte_perm(hi01, hi23, 0x5410)
        kp[dst + 3 * KTBS] = byte_perm(hi01, hi23, 0x7632)
    return kp


def stored_queries(q8, tq):
    """The block's query rows in shared memory, ``[tq, Dp + 16]`` int8:
    position s * KDK + 4 w + i holds d = s * KDK + w + 32 i, zero past D and
    past the last row."""
    rows, d = q8.shape
    dp = -(-d // KDK) * KDK
    out = np.zeros((tq, dp + 16), np.int8)
    pos = np.arange(dp)
    within = pos % KDK
    src = pos - within + within // 4 + 32 * (within % 4)
    ok = src < d
    out[:rows, pos[ok]] = q8[:, src[ok]]
    return out


def _bytes(words):
    return [((words >> np.uint32(8 * b)) & np.uint32(0xFF)).astype(np.uint8).view(np.int8)
            for b in range(4)]


def mma_m16n8k32(a, b0, b1):
    """mma.sync.m16n8k32.row.col.s32.s8.s8.s32 from the 32 lanes' registers
    (a: 4 arrays [32], b0, b1: [32]) by the PTX fragment layout: returns the
    lanes' c registers [32, 4], c[2h + j] = C[g + 8h, 2 t4 + j]."""
    lane = np.arange(32)
    g, t4 = lane >> 2, lane & 3
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for i in range(4):
        for bb, v in enumerate(_bytes(a[i])):
            A[g + 8 * (i & 1), 4 * t4 + bb + 16 * (i >> 1)] = v
    for j, reg in enumerate((b0, b1)):
        for bb, v in enumerate(_bytes(reg)):
            B[4 * t4 + bb + 16 * j, g] = v
    C = A @ B
    return np.stack([C[g + 8 * (r >> 1), 2 * t4 + (r & 1)] for r in range(4)], axis=1)


def pass1_tile_scores(q8, c8, tq):
    """The int32 score tile ``[tq, KTN]`` of one block over the corpus
    columns ``c8 [D, <= KTN]``, assembled as the producers do: per slice the
    landed ring and its k-packed buffer, per k step each warp's ldmatrix A
    registers and query B registers, one mma per (mt, nt), and the
    accumulators written at the kernel's score-tile index."""
    d, n = c8.shape
    wc_n, wq_n, sub, mt_n, nt_n = _layout(tq)
    qs = stored_queries(q8, tq)
    qwords = qs.view(np.uint32)  # [tq, (Dp + 16) / 4]
    lane = np.arange(32)
    g, t4 = lane >> 2, lane & 3
    acc = np.zeros((PRODUCERS // 32, mt_n, nt_n, 32, 4), np.int64)
    for d0 in range(0, -(-d // KDK) * KDK, KDK):
        ring = np.zeros((KDK, KCS), np.int8)
        ring[: max(0, min(KDK, d - d0)), :n] = c8[d0 : d0 + KDK]
        kp = k_packed(ring)
        for k0 in range(0, KDK, KSTEP):
            for warp in range(PRODUCERS // 32):
                wc, wq = warp % wc_n, warp // wc_n
                cw = wc * sub
                for mt in range(mt_n):
                    # ldmatrix.x4: lane l gives the row address of matrix l >> 3;
                    # lane L receives word L % 4 of row L // 4 of each matrix.
                    def row_addr(l):
                        return ((cw + mt * 16 + ((l >> 3) & 1) * 8 + (l & 7)) * KTBS + k0 // 4
                                + (l >> 4) * 4)
                    a = [kp[row_addr(8 * i + lane // 4) + lane % 4] for i in range(4)]
                    for nt in range(nt_n):
                        row = wq * (tq // wq_n) + nt * 8 + g
                        base = (d0 + k0) // 4 + t4
                        acc[warp, mt, nt] += mma_m16n8k32(a, qwords[row, base], qwords[row, base + 4])
    tile = np.zeros((tq, KTN), np.int64)
    for warp in range(PRODUCERS // 32):
        wc, wq = warp % wc_n, warp // wc_n
        cw, r0 = wc * sub, wq * (tq // wq_n) + 2 * t4
        for mt in range(mt_n):
            for nt in range(nt_n):
                for j in range(4):
                    tile[r0 + nt * 8 + (j & 1), cw + mt * 16 + g + (j >> 1) * 8] = acc[warp, mt, nt, :, j]
    return tile


@pytest.mark.parametrize("d", [100, 384, 388])
@pytest.mark.parametrize("tq", [8, 64])
@pytest.mark.parametrize("kind", ["random", "extreme"])
def test_fragment_packing_reproduces_the_int_product(d, tq, kind):
    rng = np.random.default_rng(d + tq)
    n = 128 if kind == "random" else 97  # a ragged last tile: columns past n are zero
    if kind == "random":
        q8 = rng.integers(-127, 128, (tq - 3, d)).astype(np.int8)
        c8 = rng.integers(-128, 128, (d, n)).astype(np.int8)
    else:
        q8 = rng.choice(np.int8([-128, 127, -127, 0]), (tq, d))
        c8 = rng.choice(np.int8([-128, 127]), (d, n))
    want = q8.astype(np.int64) @ c8.astype(np.int64)
    got = pass1_tile_scores(q8, c8, tq)
    assert np.abs(want).max() < 2**31
    np.testing.assert_array_equal(got[: q8.shape[0], :n], want)
    assert not got[q8.shape[0] :].any() and not got[:, n:].any()


def test_byte_transpose_selectors():
    """The kernel's 4x4 byte transpose: rows of 4 columns in, columns of 4
    rows out (byte i of column j's word is row i)."""
    m = np.arange(16, dtype=np.uint8).reshape(4, 4)  # m[row, column]
    ring = np.zeros((KDK, KCS), np.int8)
    for r in range(4):
        ring[32 * r, :4] = m[r].view(np.int8)  # thread 0's rows: lane 0 + 32 i
    kp = k_packed(ring)
    for col in range(4):
        assert np.array_equal(np.array([kp[col * KTBS]], np.uint32).view(np.uint8), m[:, col])


# --- the selection on int8 scores --------------------------------------


@settings(max_examples=40, deadline=None)
@given(
    rows=st.integers(1, 3),
    n=st.integers(1, 600),
    k=st.sampled_from([1, 70, 128]),
    cap=st.sampled_from([16, 32, 64]),
    values=st.integers(1, 4),
    dup=st.integers(0, 40),
    cut=st.floats(0.0, 1.0),
    seed=st.integers(0, 2**31 - 1),
)
def test_twolevel_selection_on_tied_int8_scores(rows, n, k, cap, values, dup, cut, seed):
    """Few distinct bytes, few distinct scales and duplicated columns: the
    dequantised scores (int -> f32 times the column scale, the fused
    kernel's order before selection) tie everywhere; the queues' drains must
    keep the lowest id first as _fused_select does."""
    rng = np.random.default_rng(seed)
    d = 8
    pool = rng.integers(-127, 128, values).astype(np.int8)
    c8 = rng.choice(pool, (d, n))
    if dup and n > 1:
        src = rng.integers(0, n, dup)
        dst = rng.integers(0, n, dup)
        c8[:, dst] = c8[:, src]
    q8 = rng.choice(pool, (rows, d))
    scales = rng.choice(np.float32([0.01, 0.02, 0.005]), (1, n))
    scores = ttopk._int_scores(torch.from_numpy(q8), torch.from_numpy(c8)) * torch.from_numpy(scales)
    limit = int(cut * n)
    got_s, got_i = queue_topk_plain(scores, k, cap=cap, limit=limit)
    masked = scores.clone()
    masked[:, limit:] = float("-inf")
    want_s, want_i = ttopk._fused_select(masked, k)
    assert torch.equal(got_s, want_s)
    assert torch.equal(got_i, want_i)


# --- the wrapper's tile rule for an int8 corpus ----------------------------------------


def test_int8_shared_memory_mirrors_pass1_smem():
    # D = 384, 64 rows: queries 64 * (384 + 16), ring 3 * 128 * 144, two
    # k-packed buffers 2 * 128 * 36 words, ceiling sums 64 * 12; the
    # selection: two queue buffers of 64 (score, column) pairs a row, their
    # counts, the k-th scores, 16 bytes of control words, 64 * (2 * 64 * 8 +
    # 12) + 16; the ceiling stages: maxima and columns 2 * 64 * 4 * 8.
    assert ttopk._pass1_smem(64, 384, 1) == 25600 + 55296 + 36864 + 768 + 66320
    assert ttopk._pass1_smem(64, 384, 1, select=False) == 25600 + 55296 + 36864 + 768 + 4096
    # D = 100 pads to one 128-deep slice; D = 388 to four.
    assert ttopk._pass1_smem(8, 100, 1) - ttopk._pass1_smem(8, 1, 1) == 0
    assert ttopk._pass1_smem(8, 388, 1) - ttopk._pass1_smem(8, 384, 1) == 8 * 128


@pytest.mark.parametrize("nq,d,want", [
    (1, 384, 8), (8, 100, 8), (9, 388, 32), (32, 384, 32), (64, 384, 64), (1024, 388, 64),
    (64, 4096, 8),
])
def test_int8_tile_fits(nq, d, want):
    tq = ttopk._pass1_tile(nq, d, 1)
    assert tq == want and ttopk._pass1_smem(tq, d, 1) <= ttopk._SMEM_LIMIT


@pytest.mark.parametrize("nq,want", [(1, 8), (8, 8), (9, 32), (32, 32), (33, 64), (64, 64),
                                     (1024, 64)])
def test_int8_wrapper_rule(nq, want):
    """The int8 wrappers (and the ceiling probe, which runs their grid) take
    the f32/bf16 rule: 8, 32 or 64 rows a block, 64 from Q = 33, since the
    queued selection no longer bounds the int8 pass 1 at 64 rows."""
    assert ttopk._tile(nq, 384, 1) == want
    assert ttopk._tile(nq, 384, 2) == (64 if nq > 32 else min(want, 32))


# --- on the card ---------------------------------------------------------------------


def _int8_corpus(rng, d, n):
    c = rng.standard_normal((n, d)).astype(np.float32)
    c[100:110] = c[:10]  # bitwise duplicates across tiles
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    from ragfin_tpu_torch.ops.quantize import quantize_corpus_t

    return quantize_corpus_t(torch.from_numpy(c.T.copy()).cuda())


@pytest.mark.cuda
class TestOnCard:
    @pytest.fixture(autouse=True)
    def _need_card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card; the CPU has no kernel to launch")

    @pytest.mark.parametrize("nq", [3, 20, 64, 1024])
    @pytest.mark.parametrize("k", [1, 70, 128])
    @pytest.mark.parametrize("layout", ["flat", "tiled", "odd_n", "d100", "d388", "rows32"])
    def test_fused_int8_bitwise(self, nq, k, layout, monkeypatch):
        if layout == "rows32":  # the 32-row block the wrapper's rule does not pick from Q = 33
            monkeypatch.setattr(ttopk, "_tile", lambda nq, d, item, select=True:
                                ttopk._pass1_tile(nq, d, item, select, (8, 32)))
        rng = np.random.default_rng(nq + k)
        d = {"d100": 100, "d388": 388}.get(layout, 384)
        n = 5001 if layout == "odd_n" else 5120
        c8, sc = _int8_corpus(rng, d, n)
        if layout == "tiled":
            c8, sc = ttopk.tile_corpus_t(c8, 256), ttopk.tile_scales(sc, 256)
        q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32)).cuda()
        q[0] = ttopk._untile(c8)[:, 3].float()  # ties: column 3 and its copy 103
        if nq > 1:
            q[1] = 0.0  # all-zero row: every score 0, no NaN
        before = ttopk.cosine_topk_fused_int8.launches
        s, i = ttopk.cosine_topk_fused_int8(q, c8, sc, k, n_valid=n - 7)
        torch.cuda.synchronize()
        assert ttopk.cosine_topk_fused_int8.launches == before + 1
        ps, pi = ttopk.fused_topk_int8_plain(q, c8, sc, k, n_valid=n - 7)
        assert torch.equal(s, ps) and torch.equal(i, pi)
        if k >= 2:
            assert i[0, :2].tolist() == [3, 103]
        if nq > 1:
            assert (s[1] == 0).all() and i[1].tolist() == list(range(k))

    @pytest.mark.parametrize("block_q", [8, 32])
    @pytest.mark.parametrize("k", [1, 70, 128])
    @pytest.mark.parametrize("d", [100, 384])
    def test_pruned_int8_bitwise(self, block_q, k, d):
        rng = np.random.default_rng(block_q + k + d)
        ct = torch.from_numpy(rng.standard_normal((d, 8192)).astype(np.float32)).cuda()
        ct = ct / ct.norm(dim=0, keepdim=True)
        index = tivf.build_ivf(ct, cell=512, seed=0, quantize=True)
        q = torch.from_numpy(rng.standard_normal((40, d)).astype(np.float32)).cuda()
        qin, qs, probe, _ = tivf.stage_queries(q, index, 4, block_q, "fast")
        args = (qin, qs, index.cells, index.scales, probe, index.n_valid)
        s, i = tivf.pruned_topk(*args, k, block_q)
        torch.cuda.synchronize()
        ps, pi = tivf.pruned_topk_plain(*args, k, block_q)
        assert torch.equal(s, ps) and torch.equal(i, pi)

    @pytest.mark.parametrize("nq", [3, 20, 64])
    @pytest.mark.parametrize("d", [100, 384])
    @pytest.mark.parametrize("rows32", [False, True])
    def test_ceiling_int8_stages_bitwise(self, nq, d, rows32, monkeypatch):
        from ragfin_tpu_torch.ops import ceiling as C

        if rows32:  # the 32-row block the rule does not pick from Q = 33
            monkeypatch.setattr(C, "_tile", lambda nq, d, item, select=True:
                                ttopk._pass1_tile(nq, d, item, select, (8, 32)))

        rng = np.random.default_rng(nq + d)
        n = 128 * 37 + 52
        ct = torch.from_numpy(rng.integers(-128, 128, (d, n)).astype(np.int8)).cuda()
        q = torch.from_numpy(rng.integers(-127, 128, (nq, d)).astype(np.int8)).cuda()
        sc = torch.from_numpy(rng.uniform(1e-3, 2e-2, (1, n)).astype(np.float32)).cuda()
        for stage in C.ladder_stages(ct.dtype):
            got = C.ceiling(q, ct, stage, 512, n_valid=n - 300, scales=sc)
            want = C.ceiling_plain(q, ct, stage, 512, n_valid=n - 300, scales=sc)
            if C.is_exact(ct.dtype, stage):
                assert torch.equal(got, want), stage
            else:
                # f32 sums over tiles in another order (chunk partials).
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3, msg=stage)
        _, seen = C.ceiling(q, ct, "dma", 512, read_check=True)
        assert seen == C.corpus_xor(ct)
