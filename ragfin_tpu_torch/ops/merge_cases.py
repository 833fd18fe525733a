"""The primitives of the in-tile selection, one case at a time.

Counterpart of ``scripts/mosaic_bisect.py``: nine small kernels, each run on
one ``[64, 256]`` f32 tile (two sub-blocks of 128 columns) and writing a
``[64, 128]`` f32 result. On the TPU they were compile-only bisects of the
operations ``_merge_tile_twolevel`` (``ragfin_tpu/ops/topk.py``) needs. Here
the nine are the card's unit tests of ``csrc/twolevel.cuh``, and four more
(``NEW_CASES``) of ``csrc/queue_select.cuh``, the primitives that pass 1 and
pass 2 of the fused and pruned top-k kernels select with:

=========================== ==================================================
``submax``                  row maximum over the maxima of the two sub-blocks
``anyaxis0``                how many of the first two columns exceed 0.5 in
                            any row
``scalarmin_i32``           the lowest of those columns (``INT32_MAX`` if none),
                            one min over all rows and columns
``lanemin_then_scalar``     the same, as a per-row min and then a min over rows
``bufload``                 sub-block ``min(1, int(x[0, 0]))`` (clamped into
                            range, as a dynamic slice clamps) read back from a
                            staged buffer
``retire``                  row max of the first two columns with column
                            ``int(x[0, 0])`` retired to ``-inf``
``whileloop_m``             the block walk: count the steps that retire the
                            lowest column still above 0.5 in some row
``nested_insert``           the walk with one sorted insertion per row and
                            block (k = 10), then ``score + id`` of each row's
                            best entry
``nested_while``            the whole two-level merge: each improving block is
                            walked by successor in (score desc, id asc) order
``queue_push``              pass 1's push: every column above 0.5 queued once,
                            through 16-entry queues that overflow and are
                            pushed again; ``[r, c]`` counts column ``c`` plus
                            twice column ``c + 128``
``bitonic_sort``            each row's 256 entries sorted (score desc, id asc):
                            the best 64 ids (as f32), then their scores
``bitonic_merge``           the best 64 of the first half, sorted, merged with
                            the sorted second half: the same output
``bound_filter``            pass 2 over the row's four 64-column quarters as
                            chunks of 16: the best 16 ids, their scores, the
                            bound (the largest chunk 16th score) and the count
                            of entries at or above it
=========================== ==================================================

Float to int conversion truncates and saturates (``-inf`` is ``INT32_MIN``),
as XLA converts. The walk's gate is the first two COLUMNS of the tile, as in
the JAX cases, not the real sub-block maxima.

:func:`merge_case` launches ``csrc/merge_cases.cu`` for a CUDA tensor and
takes :func:`merge_case_plain` only for a CPU tensor; the two are equal bit
for bit (every step is a comparison, a max or an insertion, and the one sum
is a single f32 addition).
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = float("-inf")
INT32_MAX = 0x7FFFFFFF
TQ, TN, SUB = 64, 256, 128
NB = TN // SUB
K = 10  # list length of the two insert cases
PALLAS_CASES = (
    "submax", "anyaxis0", "scalarmin_i32", "lanemin_then_scalar", "bufload", "retire",
    "whileloop_m", "nested_insert", "nested_while",
)
NEW_CASES = ("queue_push", "bitonic_sort", "bitonic_merge", "bound_filter")
CASES = PALLAS_CASES + NEW_CASES
PUSH_ABOVE = 0.5  # the queue push case's threshold
CHUNKS, PART_K = 4, 16  # the bound filter case's chunks and their list length


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 toward zero, saturating (NaN -> 0), as XLA converts."""
    v = v.double().nan_to_num(0.0).clamp(-(2**31), 2**31 - 1)
    return v.trunc().to(torch.int32)


def _argmax(x: torch.Tensor) -> torch.Tensor:
    """First index of the row maximum (0 for a row of -inf), int32."""
    mx = x.max(dim=-1, keepdim=True).values
    idx = torch.arange(x.shape[-1], device=x.device, dtype=torch.int32).expand_as(x)
    return torch.where(x == mx, idx, torch.full_like(idx, INT32_MAX)).min(dim=-1).values


def _sorted_insert(acc_s, acc_i, s, ids, k: int):
    """Insert one (score, id) per row into the sorted running top-k (an equal
    score with a lower id stays ahead; position k drops the candidate)."""
    better = (acc_s > s[:, None]) | ((acc_s == s[:, None]) & (acc_i < ids[:, None]))
    pos = better.to(torch.int32).sum(dim=-1, keepdim=True)
    slot = torch.arange(k, device=acc_s.device, dtype=torch.int32)[None, :]
    shift_s = torch.cat([acc_s[:, :1], acc_s[:, :-1]], dim=1)
    shift_i = torch.cat([acc_i[:, :1], acc_i[:, :-1]], dim=1)
    new_s = torch.where(slot == pos, s[:, None], torch.where(slot < pos, acc_s, shift_s))
    new_i = torch.where(slot == pos, ids[:, None], torch.where(slot < pos, acc_i, shift_i))
    return new_s, new_i


def _stream_merge(scores, col0: int, acc_s, acc_i, k: int):
    """Merge a score tile into the running top-k one candidate per row per
    step, while any row can still improve: each step inserts the successor
    of the last candidate in (score desc, id asc) order."""
    iota = torch.arange(scores.shape[1], device=scores.device, dtype=torch.int32)[None, :]
    cur_s = scores.max(dim=-1).values
    cur_i = _argmax(scores)
    while bool((cur_s > acc_s[:, k - 1]).any()):
        acc_s, acc_i = _sorted_insert(acc_s, acc_i, cur_s, cur_i + col0, k)
        later = (scores < cur_s[:, None]) | ((scores == cur_s[:, None]) & (iota > cur_i[:, None]))
        masked = torch.where(later, scores, torch.full_like(scores, NEG_INF))
        cur_s, cur_i = masked.max(dim=-1).values, _argmax(masked)
    return acc_s, acc_i


def _lowest_hit(m: torch.Tensor, kth: torch.Tensor) -> int:
    """Lowest block index whose gate value exceeds some row's kth, or INT32_MAX."""
    iota_b = torch.arange(m.shape[1], device=m.device, dtype=torch.int64)[None, :]
    return int(torch.where(m > kth[:, None], iota_b, INT32_MAX).min())


def _walk(x: torch.Tensor, per_block) -> torch.Tensor:
    """The outer block walk of the two insert cases; ``per_block(buf_b, b,
    a_s, a_i)`` merges block b into the lists."""
    buf = [x[:, b * SUB : (b + 1) * SUB] for b in range(NB)]
    m = x[:, :NB].clone()
    a_s = torch.full((TQ, K), NEG_INF, device=x.device)
    a_i = torch.full((TQ, K), INT32_MAX, dtype=torch.int32, device=x.device)
    while bool((m > a_s[:, K - 1 : K]).any()):
        b = _lowest_hit(m, a_s[:, K - 1])
        a_s, a_i = per_block(buf[b], b, a_s, a_i)
        m[:, b] = NEG_INF
    return a_s[:, :1] + a_i[:, :1].to(torch.float32)


def _best(scores: torch.Tensor, k: int, first_id: int = 0):
    """Each row's best ``k`` in (score desc, id asc) order: scores, int64 ids."""
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k], i[:, :k] + first_id


def _bound_filter(x: torch.Tensor) -> torch.Tensor:
    w = TN // CHUNKS
    parts = [_best(x[:, c * w : (c + 1) * w], PART_K, c * w) for c in range(CHUNKS)]
    ps = torch.cat([s for s, _ in parts], 1)
    pi = torch.cat([i for _, i in parts], 1)
    bound = torch.stack([s[:, PART_K - 1] for s, _ in parts], 1).max(dim=1).values
    keep = (ps > NEG_INF) & (ps >= bound[:, None])
    ks = torch.where(keep, ps, torch.full_like(ps, NEG_INF))
    order = torch.from_numpy(np.lexsort((pi.cpu().numpy(), -ks.cpu().double().numpy()), axis=1))
    ks = torch.gather(ks, 1, order[:, :PART_K].to(x.device))
    ki = torch.gather(torch.where(keep, pi, INT32_MAX), 1, order[:, :PART_K].to(x.device))
    out = torch.zeros((TQ, 128), device=x.device)
    out[:, :PART_K] = ki.to(torch.float32)
    out[:, PART_K : 2 * PART_K] = ks
    out[:, 2 * PART_K] = bound
    out[:, 2 * PART_K + 1] = keep.sum(dim=1).to(torch.float32)
    return out


def merge_case_plain(name: str, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of one case: ``x [64, 256]`` f32 -> ``[64, 128]`` f32."""
    _check(name, x)
    x = x.float()
    full = lambda v: torch.full((TQ, 128), float(v), device=x.device)
    if name == "queue_push":
        return ((x[:, :SUB] > PUSH_ABOVE).float() + 2 * (x[:, SUB:] > PUSH_ABOVE).float())
    if name in ("bitonic_sort", "bitonic_merge"):
        s, i = _best(x, 64)
        return torch.cat([i.to(torch.float32), s], 1)
    if name == "bound_filter":
        return _bound_filter(x)
    if name == "submax":
        m = torch.stack([x[:, b * SUB : (b + 1) * SUB].max(dim=1).values for b in range(NB)], 1)
        return m.max(dim=1, keepdim=True).values.expand(TQ, 128).contiguous()
    if name == "anyaxis0":
        return full(int((x[:, :NB] > 0.5).any(dim=0).sum()))
    if name in ("scalarmin_i32", "lanemin_then_scalar"):
        return full(_lowest_hit(x[:, :NB], torch.full((TQ,), 0.5, device=x.device)))
    b = int(_to_int32(x[0, 0]))
    if name == "bufload":
        b = min(max(min(1, b), 0), NB - 1)
        return x[:, b * SUB : (b + 1) * SUB].contiguous()
    if name == "retire":
        m = x[:, :NB].clone()
        if 0 <= b < NB:
            m[:, b] = NEG_INF
        return m.max(dim=1, keepdim=True).values.expand(TQ, 128).contiguous()
    if name == "whileloop_m":
        m, steps = x[:, :NB].clone(), 0
        while bool((m > 0.5).any()):
            m[:, _lowest_hit(m, torch.full((TQ,), 0.5, device=x.device))] = NEG_INF
            steps += 1
        return full(steps)
    if name == "nested_insert":
        def insert_max(sl, b, a_s, a_i):
            return _sorted_insert(a_s, a_i, sl.max(dim=1).values, _argmax(sl) + b * SUB, K)
        return _walk(x, insert_max).expand(TQ, 128).contiguous()
    def merge(sl, b, a_s, a_i):
        return _stream_merge(sl, b * SUB, a_s, a_i, K)
    return _walk(x, merge).expand(TQ, 128).contiguous()


def queue_topk_plain(scores: torch.Tensor, k: int, cap: int = 64, tile: int = 128,
                     limit=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain model of pass 1's selection (csrc/fused_pass1.cuh) over one
    block's walk of ``scores [R, N]`` in ascending column order: per tile of
    ``tile`` columns (columns at or past ``limit`` masked to -inf), each
    score is gated against the row's k-th score as the last drain left it
    (strict >, so -inf never passes) and queued; a queue holds ``cap``
    entries, and a full one is drained (sorted in (score desc, id asc)
    order and merged into the row's list of k) before the next candidate is
    queued; the chunk's end drains the rest. The threshold is refreshed only
    by drains, so it is stale in between, as the kernel's register copy is.
    Returns ``(scores [R, k], ids [R, k] int32)``; empty slots are (-inf,
    INT32_MAX)."""
    rows, n = scores.shape
    limit = n if limit is None else min(int(limit), n)
    out_s = torch.full((rows, k), NEG_INF)
    out_i = torch.full((rows, k), INT32_MAX, dtype=torch.int32)
    vals = scores.detach().cpu().float().tolist()
    for r in range(rows):
        lst, queue = [], []  # lst: sorted (-score, id), at most k

        def drain():
            lst.extend(queue)
            lst.sort()
            del lst[k:], queue[:]

        kth = NEG_INF
        for c0 in range(0, n, tile):
            for c in range(c0, min(c0 + tile, n)):
                v = vals[r][c] if c < limit else NEG_INF
                if not v > kth:
                    continue
                if len(queue) == cap:
                    drain()
                    kth = -lst[-1][0] if len(lst) == k else NEG_INF
                queue.append((-v, c))
        drain()
        for j, (v, c) in enumerate(lst):
            out_s[r, j], out_i[r, j] = -v, c
    return out_s, out_i


def _check(name: str, x: torch.Tensor) -> None:
    if name not in CASES:
        raise ValueError(f"unknown merge case: {name}")
    if tuple(x.shape) != (TQ, TN) or x.dtype != torch.float32:
        raise ValueError(f"a merge case takes one [{TQ}, {TN}] f32 tile, got {tuple(x.shape)} {x.dtype}")


def merge_case(name: str, x: torch.Tensor) -> torch.Tensor:
    """One case on ``x [64, 256]`` f32: ``csrc/merge_cases.cu`` for a CUDA
    tensor, the plain version for a CPU tensor, an error on any other device.
    Kernel launches are counted in ``.launches``."""
    _check(name, x)
    if x.device.type == "cpu":
        return merge_case_plain(name, x)
    if not x.is_cuda:
        raise ValueError(f"merge cases run on a CUDA card or the CPU, not on {x.device}")
    from . import _cuda

    x = x.contiguous()
    out = torch.empty((TQ, 128), dtype=torch.float32, device=x.device)
    err = _cuda.kernel("merge_cases")(
        x.data_ptr(), out.data_ptr(), CASES.index(name),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _cuda.check(err, "merge_cases")
    merge_case.launches += 1
    return out


merge_case.launches = 0
