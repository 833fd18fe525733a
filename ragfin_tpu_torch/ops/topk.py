"""Exact cosine top-k over a device-resident embedding matrix.

Counterpart of ``ragfin_tpu/ops/topk.py``. The corpus is passed transposed,
``corpus_t [D, N]``, as the index stores it. Every tier returns
``(scores [Q, k] f32 descending, ids [Q, k] int32)`` with the lower id first
on ties.

- :func:`cosine_topk_dense` and its int8 / multi-mask variants: one product,
  then a stable descending sort (``torch.topk`` does not promise the
  lowest-id tie rule).
- :func:`cosine_topk_fused` / :func:`cosine_topk_fused_int8`: on a CUDA
  tensor, the hand-written kernels in ``csrc/`` (two passes: per-chunk
  running top-k, then a merge by bound); on a CPU tensor, their plain PyTorch
  versions in this module, which hold the same contract: empty slots are
  ``INT32_MAX`` ids with ``-inf`` scores, the tile-major layout needs
  ``n_valid``. Each wrapper counts its kernel launches in ``.launches``.

The dense tiers are plain torch, as they are plain XLA in JAX.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .quantize import quantize_queries

NEG_INF = float("-inf")
INT32_MAX = 0x7FFFFFFF
# Column count from which the dispatcher sends a CUDA corpus to the fused
# kernel (the JAX package's TPU threshold; PERF.md asks whether it holds on
# the card).
FUSED_MIN_N = 65536
# Largest k the CUDA kernels keep per row (csrc/topk_common.cuh kMaxK).
FUSED_MAX_K = 128
_KERNEL_TILE_N = 128  # csrc kTN: a tile-major block_n must be a multiple


def _score_mask(
    scores: torch.Tensor,
    n_valid: Optional[int],
    row_mask: Optional[torch.Tensor] = None,
    score_mult: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    n = scores.shape[-1]
    if score_mult is not None:
        # Positive similarities are scaled by the column's multiplier in
        # (0, 1]; negatives are left alone (shrinking one toward 0 would
        # raise it past unweighted columns).
        m = score_mult.reshape(-1)[:n].to(scores.dtype)
        scores = torch.where(scores > 0, scores * m, scores)
    if n_valid is not None and n_valid < n:
        cols = torch.arange(n, device=scores.device)
        scores = scores.masked_fill(cols >= n_valid, NEG_INF)
    if row_mask is not None:
        scores = scores.masked_fill(~row_mask.reshape(-1)[:n], NEG_INF)
    return scores


def _select(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along the last axis: descending, lowest index first on ties
    (a stable sort, as ``lax.top_k`` and the numpy oracle order them)."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k].contiguous(), i[..., :k].to(torch.int32)


def _int_scores(q8: torch.Tensor, corpus_i8: torch.Tensor, block: int = 65536) -> torch.Tensor:
    """Exact int8 x int8 dot products, [Q, D] x [D, N] -> f32 [Q, N].

    Computed as an f32 product of the int8 values: every product and partial
    sum is an integer below 2^24 (|sum| <= 384 * 127^2), so f32 holds each
    one exactly in any summation order. Column blocks bound the f32 copy."""
    qf = q8.float()
    out = torch.empty((q8.shape[0], corpus_i8.shape[1]), dtype=torch.float32, device=q8.device)
    for start in range(0, corpus_i8.shape[1], block):
        out[:, start : start + block] = qf @ corpus_i8[:, start : start + block].float()
    return out


def _matmul_scores(queries: torch.Tensor, corpus_t: torch.Tensor) -> torch.Tensor:
    return torch.matmul(queries.float(), corpus_t.float())


def cosine_topk_dense(
    queries: torch.Tensor,
    corpus_t: torch.Tensor,
    k: int,
    n_valid: Optional[int] = None,
    precision: str = "exact",
    row_mask: Optional[torch.Tensor] = None,
    score_mult: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full [Q, N] scores then a stable top-k. ``precision`` is accepted for
    the JAX signature: both tiers are an f32 product here (TF32 is off), as
    JAX's DEFAULT precision is on the CPU."""
    _check_precision(precision)
    scores = _score_mask(_matmul_scores(queries, corpus_t), n_valid, row_mask, score_mult)
    return _select(scores, k)


def _int8_dense_scores(queries, corpus_i8, scales):
    """Dense int8 scores in the JAX dense tiers' order: int * qscale * scales."""
    q8, qscale = quantize_queries(queries)
    return _int_scores(q8, corpus_i8) * qscale * scales.reshape(1, -1)


def cosine_topk_dense_int8(
    queries: torch.Tensor,
    corpus_i8: torch.Tensor,
    scales: torch.Tensor,
    k: int,
    n_valid: Optional[int] = None,
    row_mask: Optional[torch.Tensor] = None,
    score_mult: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense scoring over the int8 corpus without a dequantized copy."""
    scores = _int8_dense_scores(queries, corpus_i8, scales)
    return _select(_score_mask(scores, n_valid, row_mask, score_mult), k)


def _per_tier(scores: torch.Tensor, k: int, row_masks: torch.Tensor):
    n = scores.shape[-1]
    masked = scores[None].masked_fill(~row_masks[:, None, :n], NEG_INF)  # [G, Q, N]
    return _select(masked, k)


def cosine_topk_dense_multi(
    queries: torch.Tensor,
    corpus_t: torch.Tensor,
    k: int,
    row_masks: torch.Tensor,  # [G, N] bool, one mask per filter tier
    n_valid: Optional[int] = None,
    precision: str = "exact",
    score_mult: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All of a query group's filter tiers from one [Q, N] score matrix:
    ([G, Q, k] scores, [G, Q, k] ids)."""
    _check_precision(precision)
    scores = _score_mask(_matmul_scores(queries, corpus_t), n_valid, None, score_mult)
    return _per_tier(scores, k, row_masks)


def cosine_topk_dense_multi_int8(
    queries: torch.Tensor,
    corpus_i8: torch.Tensor,
    scales: torch.Tensor,
    k: int,
    row_masks: torch.Tensor,
    n_valid: Optional[int] = None,
    score_mult: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Int8 variant of :func:`cosine_topk_dense_multi`."""
    scores = _int8_dense_scores(queries, corpus_i8, scales)
    return _per_tier(_score_mask(scores, n_valid, None, score_mult), k, row_masks)


def cosine_topk_blocked(
    queries: torch.Tensor,
    corpus_t: torch.Tensor,
    k: int,
    block: int = 131072,
    n_valid: Optional[int] = None,
    precision: str = "exact",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Memory-bounded exact top-k: column blocks with a running merge."""
    _check_precision(precision)
    q = queries.shape[0]
    n = corpus_t.shape[1]
    limit = n if n_valid is None else min(int(n_valid), n)
    run_s = torch.full((q, k), NEG_INF, device=queries.device)
    run_i = torch.full((q, k), INT32_MAX, dtype=torch.int32, device=queries.device)
    for start in range(0, n, block):
        scores = _matmul_scores(queries, corpus_t[:, start : start + block])
        scores = _score_mask(scores, limit - start)
        s, i = _select(scores, k)
        cat_s = torch.cat([run_s, s], dim=1)
        cat_i = torch.cat([run_i, i + start], dim=1)
        # Running entries precede the block's and carry lower ids, so a
        # stable sort keeps the lowest id first on ties.
        run_s, sel = _select(cat_s, k)
        run_i = torch.gather(cat_i, 1, sel.long())
    return run_s, run_i


def tile_corpus_t(corpus_t: torch.Tensor, block_n: int = 2048) -> torch.Tensor:
    """``corpus_t [D, N]`` -> tile-major ``[n_tiles, D, block_n]``, zero-padded
    (callers pass ``n_valid`` as for the flat layout)."""
    d, n = corpus_t.shape
    pad = -n % block_n
    if pad:
        corpus_t = torch.nn.functional.pad(corpus_t, (0, pad))
    n_tiles = corpus_t.shape[1] // block_n
    return corpus_t.reshape(d, n_tiles, block_n).permute(1, 0, 2).contiguous()


def tile_scales(scales: torch.Tensor, block_n: int = 2048) -> torch.Tensor:
    """Int8 per-column ``scales [1, N]`` -> ``[n_tiles, 1, block_n]``."""
    return tile_corpus_t(scales, block_n)


def _untile(corpus_t: torch.Tensor) -> torch.Tensor:
    """Tile-major [n_tiles, D, bn] -> flat [D, n_tiles * bn]."""
    if corpus_t.dim() == 2:
        return corpus_t
    n_tiles, d, bn = corpus_t.shape
    return corpus_t.permute(1, 0, 2).reshape(d, n_tiles * bn)


def _check_precision(precision: str) -> None:
    if precision not in ("exact", "fast"):
        raise ValueError(f"unknown precision: {precision}")


def _geometry(corpus_t: torch.Tensor, n_valid: Optional[int]) -> tuple[int, int]:
    """(physical column count, valid column limit) of a flat or tile-major corpus."""
    if corpus_t.dim() == 3:
        if n_valid is None:
            # The true N is unrecoverable from the tiled shape: the layout's
            # zero-pad columns would score 0.0 and outrank negative-score hits.
            raise ValueError("a tile-major [n_tiles, D, block_n] corpus requires n_valid")
        n = corpus_t.shape[0] * corpus_t.shape[2]
    elif corpus_t.dim() == 2:
        n = corpus_t.shape[1]
    else:
        raise ValueError(f"corpus must be [D, N] or [n_tiles, D, block_n], got {tuple(corpus_t.shape)}")
    limit = n if n_valid is None else min(int(n_valid), n)
    return n, limit


def _fused_select(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused kernels' selection: like :func:`_select`, but a -inf score
    never enters the top-k, so empty slots are (-inf, INT32_MAX)."""
    q, n = scores.shape
    s, i = _select(scores, min(k, n))
    if k > n:
        s = torch.cat([s, torch.full((q, k - n), NEG_INF, device=s.device)], dim=1)
        i = torch.cat([i, torch.full((q, k - n), INT32_MAX, dtype=torch.int32, device=i.device)], dim=1)
    return s, torch.where(s == NEG_INF, torch.full_like(i, INT32_MAX), i)


def _fused_queries(queries: torch.Tensor, corpus_dtype: torch.dtype, precision: str) -> torch.Tensor:
    q = queries.float()
    if precision == "fast" and corpus_dtype == torch.bfloat16:
        # Single bf16 product with f32 accumulation: the queries are rounded
        # to bf16, as the JAX fast tier casts them.
        q = q.to(torch.bfloat16).float()
    return q


def fused_topk_plain(queries, corpus_t, k, n_valid=None, precision="exact"):
    """Plain PyTorch version of the fused f32/bf16 kernel (same contract)."""
    _check_precision(precision)
    _, limit = _geometry(corpus_t, n_valid)
    q = _fused_queries(queries, corpus_t.dtype, precision)
    scores = _score_mask(_matmul_scores(q, _untile(corpus_t)), limit)
    return _fused_select(scores, k)


def fused_topk_int8_plain(queries, corpus_i8, scales, k, n_valid=None):
    """Plain PyTorch version of the fused int8 kernel, in its order of
    operations: exact int dot, times the column scale, select, then the row
    scale with -inf kept."""
    _, limit = _geometry(corpus_i8, n_valid)
    q8, qscale = quantize_queries(queries)
    scores = _int_scores(q8, _untile(corpus_i8)) * _untile(scales).reshape(1, -1)
    s, i = _fused_select(_score_mask(scores, limit), k)
    return torch.where(s == NEG_INF, s, s * qscale), i


# Shared memory of one pass-1 block (csrc/fused_pass1.cuh pass1_smem, which
# this mirrors): queries [TQ, Dp + pad] (f32, or int8 over an int8 corpus), a
# ring of 16 KB corpus slices (rows padded to 136 columns, int8 to 144; three
# slices at TQ = 64, else four), for int8 two k-packed [128, 36]-word
# buffers, ceiling sums, and for the selection two candidate-queue buffers of
# _QCAP (score, column) pairs a row with their counts, each row's k-th score
# and four control words (the lists themselves live in the drainer warps'
# registers); for the ceiling stages two buffers of per-warp row maxima and
# their columns.
_SMEM_LIMIT = 232448  # dynamic shared memory one block may use on an H100
_QCAP = 64  # csrc/fused_pass1.cuh kQCap
# Per corpus itemsize: slice depth, query row padding, corpus row stride.
_SLICE = {
    4: (32, 4, _KERNEL_TILE_N + 8),
    2: (64, 8, _KERNEL_TILE_N + 8),
    1: (128, 16, _KERNEL_TILE_N + 16),
}


def _pass1_smem(tq: int, d: int, itemsize: int, select: bool = True) -> int:
    dk, pad, cs = _SLICE[itemsize]
    dp = -(-d // dk) * dk
    wc = 8 if tq == 8 else 4
    stages = 3 if tq == 64 else 4
    q_item = 1 if itemsize == 1 else 4
    size = q_item * tq * (dp + pad) + itemsize * stages * dk * cs + tq * 12
    if itemsize == 1:
        size += 2 * _KERNEL_TILE_N * (dk // 4 + 4) * 4
    if select:
        size += tq * (2 * _QCAP * 8 + 12) + 16
    else:
        size += 2 * tq * wc * 8
    return size


def _pass1_tile(nq: int, d: int, itemsize: int, select: bool = True, allowed=(8, 32, 64)) -> int:
    """Query rows per block of pass 1 over a corpus of ``itemsize`` 4, 2 or 1
    bytes: the widest tile that ``nq`` fills (64 reads the corpus once at
    Q = 64) and whose shared memory fits."""
    want = 64 if nq > 32 else 32 if nq > 8 else 8
    for tq in sorted(allowed, reverse=True):
        if tq <= want and _pass1_smem(tq, d, itemsize, select) <= _SMEM_LIMIT:
            return tq
    raise ValueError(f"D={d}: a pass-1 block's shared memory exceeds {_SMEM_LIMIT} bytes")


def _tile(nq: int, d: int, itemsize: int, select: bool = True) -> int:
    """Query rows per block of pass 1 for a corpus of this itemsize: the
    fused wrappers' rule, which the ceiling probe follows. Every corpus type
    takes 64 rows from Q = 33: 64-row blocks read the corpus once, and the
    queued selection no longer bounds the int8 pass 1 there (it took 32 rows
    below Q = 256 while the walk of one candidate at a time did;
    chip_smoke.py --sweep times 32 and 64 at Q = 64, 128 and 1024)."""
    return _pass1_tile(nq, d, itemsize, select)


def _device_index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """Streaming multiprocessors of card ``index``, read once: the property
    call would otherwise be host work on every wrapper call."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _pass1_plan(q: int, n: int, tq: int, device: torch.device) -> tuple[int, int]:
    """(tiles per chunk, chunk count) of pass 1: one wave of blocks over all
    query tiles (a block of 512 threads holds its SM alone,
    csrc/fused_pass1.cuh __launch_bounds__), so pass 2 merges few lists, and
    at least two column tiles per chunk."""
    n_tiles = -(-n // _KERNEL_TILE_N)
    q_tiles = -(-q // tq)
    sms = _sm_count(_device_index(device))
    chunks = max(1, sms // q_tiles)
    per_chunk = max(2, -(-n_tiles // chunks))
    return per_chunk, -(-n_tiles // per_chunk)


def _check_cuda_inputs(queries, corpus, k, dtypes):
    if not corpus.is_cuda or queries.device != corpus.device:
        raise ValueError("queries and corpus must lie on the same CUDA device")
    if corpus.dtype not in dtypes:
        raise TypeError(f"corpus dtype {corpus.dtype} is not one of {dtypes}")
    if queries.dim() != 2 or queries.shape[1] != corpus.shape[-2]:
        raise ValueError(f"queries {tuple(queries.shape)} do not match corpus {tuple(corpus.shape)}")
    if not 1 <= k <= FUSED_MAX_K:
        raise ValueError(f"the CUDA fused kernels take 1 <= k <= {FUSED_MAX_K}, got k={k}")
    if corpus.dim() == 3 and corpus.shape[2] % _KERNEL_TILE_N:
        raise ValueError(f"tile-major block_n must be a multiple of {_KERNEL_TILE_N}")
    if corpus.numel() and corpus.shape[-1] * (corpus.shape[0] if corpus.dim() == 3 else 1) >= 2**31:
        raise ValueError("the CUDA fused kernels take at most 2^31 - 1 columns")


def _layout_args(corpus: torch.Tensor, n: int) -> tuple[int, int, int]:
    """(ld, tile_stride, bn) for csrc tile_base(): flat or tile-major."""
    if corpus.dim() == 3:
        bn = corpus.shape[2]
        return bn, corpus.shape[1] * bn, bn
    return n, 0, 2**31 - 1


def _empty_result(q: int, k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (
        torch.full((q, k), NEG_INF, device=device),
        torch.full((q, k), INT32_MAX, dtype=torch.int32, device=device),
    )


def cosine_topk_fused(
    queries: torch.Tensor,
    corpus_t: torch.Tensor,
    k: int,
    n_valid: Optional[int] = None,
    precision: str = "exact",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused matmul + k-select over an f32 or bf16 corpus (flat ``[D, N]`` or
    tile-major ``[n_tiles, D, block_n]``). CUDA tensors run
    ``csrc/fused_topk.cu``; CPU tensors its plain version."""
    _check_precision(precision)
    n, limit = _geometry(corpus_t, n_valid)
    if not corpus_t.is_cuda:
        return fused_topk_plain(queries, corpus_t, k, n_valid, precision)
    from . import _cuda

    _check_cuda_inputs(queries, corpus_t, k, (torch.float32, torch.bfloat16))
    if not corpus_t.is_contiguous():
        raise ValueError("corpus must be contiguous")
    # The fast tier's rounding of the queries to bf16 happens as the kernel
    # stages them (round_q), not in two more launches here.
    q = queries.float().contiguous()
    round_q = precision == "fast" and corpus_t.dtype == torch.bfloat16
    nq, d = q.shape
    if nq == 0 or n == 0:
        return _empty_result(nq, k, q.device)
    fn = _cuda.kernel("fused_topk")
    tq = _tile(nq, d, corpus_t.element_size())
    per_chunk, chunks = _pass1_plan(nq, n, tq, q.device)
    part_s = torch.empty((chunks, nq, k), dtype=torch.float32, device=q.device)
    part_i = torch.empty((chunks, nq, k), dtype=torch.int32, device=q.device)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    ld, tile_stride, bn = _layout_args(corpus_t, n)
    with torch.cuda.device(q.device):  # launch on the corpus's card
        err = fn(
            q.data_ptr(), nq, d, corpus_t.data_ptr(), int(corpus_t.dtype == torch.bfloat16),
            int(round_q), ld, tile_stride, bn, n, limit, k, tq, per_chunk, chunks,
            part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _cuda.check(err, "fused_topk")
    cosine_topk_fused.launches += 1
    return out_s, out_i


cosine_topk_fused.launches = 0


def cosine_topk_fused_int8(
    queries: torch.Tensor,
    corpus_i8: torch.Tensor,
    scales: torch.Tensor,
    k: int,
    n_valid: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused top-k over an int8 corpus ``[D, N]`` with per-column ``scales
    [1, N]`` (or the tile-major pair from :func:`tile_corpus_t` /
    :func:`tile_scales`). Queries are f32 and quantized per row. CUDA tensors
    run ``csrc/fused_topk_int8.cu``; CPU tensors its plain version."""
    n, limit = _geometry(corpus_i8, n_valid)
    if not corpus_i8.is_cuda:
        return fused_topk_int8_plain(queries, corpus_i8, scales, k, n_valid)
    from . import _cuda

    _check_cuda_inputs(queries, corpus_i8, k, (torch.int8,))
    if queries.shape[1] % 4:
        raise ValueError("the int8 kernel needs D to be a multiple of 4")
    if not (corpus_i8.is_contiguous() and scales.is_contiguous()) or scales.numel() != n:
        raise ValueError("corpus and scales must be contiguous, one scale per column")
    if scales.dtype != torch.float32 or scales.device != corpus_i8.device:
        raise TypeError("scales must be f32 on the corpus's device")
    q8, qscale = quantize_queries(queries)
    q8, qscale = q8.contiguous(), qscale.contiguous()
    nq, d = q8.shape
    if nq == 0 or n == 0:
        return _empty_result(nq, k, q8.device)
    fn = _cuda.kernel("fused_topk_int8")
    tq = _tile(nq, d, 1)
    per_chunk, chunks = _pass1_plan(nq, n, tq, q8.device)
    part_s = torch.empty((chunks, nq, k), dtype=torch.float32, device=q8.device)
    part_i = torch.empty((chunks, nq, k), dtype=torch.int32, device=q8.device)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=q8.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=q8.device)
    ld, tile_stride, bn = _layout_args(corpus_i8, n)
    with torch.cuda.device(q8.device):  # launch on the corpus's card
        err = fn(
            q8.data_ptr(), qscale.data_ptr(), nq, d, corpus_i8.data_ptr(), scales.data_ptr(),
            ld, tile_stride, bn, n, limit, k, tq, per_chunk, chunks,
            part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(q8.device).cuda_stream,
        )
    _cuda.check(err, "fused_topk_int8")
    cosine_topk_fused_int8.launches += 1
    return out_s, out_i


cosine_topk_fused_int8.launches = 0


def cosine_topk(
    queries: torch.Tensor,
    corpus_t: torch.Tensor,
    k: int,
    n_valid: Optional[int] = None,
    method: str = "auto",
    precision: str = "exact",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatching entry point used by the vector index: ``auto`` takes the
    fused CUDA kernel for a CUDA corpus of at least ``FUSED_MIN_N`` columns,
    the dense tier otherwise."""
    if method == "auto":
        big = corpus_t.shape[-1] >= FUSED_MIN_N
        method = "fused" if (corpus_t.is_cuda and big) else "dense"
    if method == "dense":
        return cosine_topk_dense(queries, corpus_t, k, n_valid, precision)
    if method == "blocked":
        return cosine_topk_blocked(queries, corpus_t, k, n_valid=n_valid, precision=precision)
    if method == "fused":
        return cosine_topk_fused(queries, corpus_t, k, n_valid=n_valid, precision=precision)
    raise ValueError(f"unknown top-k method: {method}")
