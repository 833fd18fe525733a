"""IVF-style cluster-pruned approximate top-k (IVF_FLAT on the card).

Counterpart of ``ragfin_tpu/ops/ivf.py``. The reference indexes with Milvus
``IVF_FLAT`` (``nlist=128``, COSINE): vectors are clustered, a query scores
the cluster centroids and scans only the best ``nprobe`` clusters. As in the
JAX package:

- **Cells are corpus tiles.** The corpus is permuted cluster-major and packed
  into the tile-major layout ``[n_cells, D, cell]``, so one cluster is one
  contiguous block of device memory.
- **Probing is data-dependent block selection.** A small torch stage scores
  the query batch against the cell centroids and emits a probe list
  ``[q_tiles, nprobe]`` per tile of ``block_q`` queries; the pruned kernel
  reads only the probed cells, so compute and memory traffic scale with
  ``nprobe / n_cells``.
- **Selection is exact within the probed subset**: scores descending, the
  lower permuted id first on ties.

Approximation error therefore comes only from cluster pruning (a true
neighbour living in an unprobed cell); ``nprobe == n_cells`` equals the exact
kernel. Cells are balanced (every cell holds exactly ``cell`` vectors): build
runs Lloyd iterations with device matmuls and a host greedy capacity
assignment. Pad columns are permuted to the tail cells so the ``n_valid``
mask works on permuted positions.

:func:`pruned_topk` is the kernel's wrapper: on CUDA tensors it launches
``csrc/ivf_topk.cu``, on CPU tensors :func:`pruned_topk_plain`. The probe
pre-stage and the id post-stage around it are plain torch, as they are
plain XLA around the Pallas kernel in JAX, with JAX's tie rules (stable
sorts: the lowest index wins).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from .quantize import quantize_corpus_t, quantize_queries
from .topk import (
    FUSED_MAX_K,
    INT32_MAX,
    NEG_INF,
    _check_precision,
    _device_index,
    _fused_select,
    _int_scores,
    _pass1_tile,
    _select,
    _sm_count,
)

_KERNEL_TILE_N = 128  # csrc kTN: a cell must be a multiple
_MAX_GRID_Y = 65535


class IVFIndex(NamedTuple):
    """Device-resident IVF structure.

    cells:       [n_cells, D, cell]  corpus tiles, cluster-major (bf16/f32,
                 or int8 with ``scales`` set)
    scales:      [n_cells, 1, cell]  int8 per-column scales, or None
    centroids:   [n_cells, D] f32    cell centroids (unnormalized means)
    orig_ids:    [n_cells * cell] int32  permuted position -> original id
                 (INT32_MAX for pad columns)
    n_valid:     int                  number of real (non-pad) vectors
    """

    cells: torch.Tensor
    scales: Optional[torch.Tensor]
    centroids: torch.Tensor
    orig_ids: torch.Tensor
    n_valid: int

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def cell(self) -> int:
        return self.cells.shape[2]


def ivf_from_numpy(
    cells: np.ndarray,
    scales: Optional[np.ndarray],
    centroids: np.ndarray,
    orig_ids: np.ndarray,
    n_valid: int,
    device: DeviceLike = None,
) -> IVFIndex:
    """An :class:`IVFIndex` from host arrays, such as the JAX package's index
    or a saved ``ivf.npz`` holds. bf16 cells come as their ``uint16`` bit
    view (numpy has no bf16)."""
    dev = resolve_device(device)
    def host(a, dtype=None):
        # C-contiguous and writable (an .npz member or a JAX export is
        # read-only, which torch.from_numpy does not take).
        return np.require(a, dtype=dtype, requirements=["C", "W"])

    cells = host(cells)
    if cells.dtype == np.uint16:
        cells_t = torch.from_numpy(cells.view(np.int16)).view(torch.bfloat16)
    elif cells.dtype in (np.float32, np.int8):
        cells_t = torch.from_numpy(cells)
    else:
        raise TypeError(f"cells must be float32, int8 or a uint16 view of bf16, got {cells.dtype}")
    if (cells_t.dtype == torch.int8) != (scales is not None):
        raise ValueError("int8 cells need scales, and only int8 cells take them")
    return IVFIndex(
        cells=cells_t.to(dev),
        scales=None if scales is None
        else torch.from_numpy(host(scales, np.float32)).to(dev),
        centroids=torch.from_numpy(host(centroids, np.float32)).to(dev),
        orig_ids=torch.from_numpy(host(orig_ids, np.int32)).to(dev),
        n_valid=int(n_valid),
    )


def _balanced_assign(scores_top: np.ndarray, cand: np.ndarray, capacity: np.ndarray) -> np.ndarray:
    """Capacity-constrained assignment (host, build-time), fully vectorized.

    ``cand [N, c]`` are each point's best-scoring candidate cells (descending),
    ``scores_top [N, c]`` the matching scores, ``capacity [n_cells]`` the free
    slots per cell (sum must be >= N). Candidate ranks are processed left to
    right; within a rank, points claim their cell's free slots in descending
    best-score priority. Overflow past the candidate list fills remaining
    slots arbitrarily (boundary points: the recall cost ``nprobe`` absorbs)."""
    n, c = cand.shape
    n_cells = capacity.shape[0]
    capacity = capacity.copy()
    assign = np.full(n, -1, np.int64)
    # Priority = descending best score; stable sorts keep it within groups.
    order = np.argsort(-scores_top[:, 0], kind="stable")
    for r in range(c):
        un = order[assign[order] < 0]
        if un.size == 0:
            break
        cells = cand[un, r].astype(np.int64)
        by_cell = np.argsort(cells, kind="stable")
        sorted_cells = cells[by_cell]
        # Rank of each point within its cell's claimants (priority order).
        group_start = np.searchsorted(sorted_cells, sorted_cells, side="left")
        rank_in_group = np.arange(sorted_cells.size) - group_start
        ok = rank_in_group < capacity[sorted_cells]
        chosen = un[by_cell[ok]]
        assign[chosen] = sorted_cells[ok]
        capacity -= np.bincount(sorted_cells[ok], minlength=n_cells)
    unplaced = np.flatnonzero(assign < 0)
    if unplaced.size:
        free = np.repeat(np.arange(n_cells), capacity)
        assign[unplaced] = free[: unplaced.size]
    return assign


def _candidate_cells(corpus_t: torch.Tensor, centroids: torch.Tensor, topc: int, block_cols: int):
    """Per-point top-``topc`` candidate cells, streamed over column blocks of
    the [D, N] corpus so the [N, C] score matrix never materializes."""
    d, n = corpus_t.shape
    cent = centroids.to(corpus_t.dtype)
    ts, ti = [], []
    for start in range(0, n, block_cols):
        s = torch.matmul(cent, corpus_t[:, start : start + block_cols]).float()  # [C, B]
        bs, bi = _select(s.T, topc)
        ts.append(bs)
        ti.append(bi)
    return torch.cat(ts), torch.cat(ti)


def _cell_means(corpus_t: torch.Tensor, assign: torch.Tensor, n_cells: int, block_cols: int):
    """Cell means, streamed over column blocks. Segment id ``n_cells`` is a
    dump slot for pad columns, so zero pads never dilute a real cell.

    Each block's columns are sorted by cell (stably) and summed per cell in
    column order by ``segment_reduce``: no atomics, so a build on the card
    gives the same index every time (``index_add_`` there sums in the order
    its atomics land)."""
    d, n = corpus_t.shape
    sums = torch.zeros((n_cells + 1, d), dtype=torch.float32, device=corpus_t.device)
    counts = torch.zeros((n_cells + 1,), dtype=torch.int64, device=corpus_t.device)
    for start in range(0, n, block_cols):
        seg = assign[start : start + block_cols]
        order = torch.sort(seg, stable=True)[1]
        lengths = torch.bincount(seg, minlength=n_cells + 1)
        rows = corpus_t[:, start : start + block_cols].T.float()[order]
        sums += torch.segment_reduce(rows, "sum", lengths=lengths, axis=0)
        counts += lengths
    return (sums / counts.clamp(min=1).float()[:, None])[:n_cells]


def build_ivf(
    corpus_t: torch.Tensor,
    cell: int = 2048,
    iters: int = 4,
    candidates: int = 16,
    seed: int = 0,
    quantize: bool = False,
    free_source: bool = False,
) -> IVFIndex:
    """Cluster the corpus into balanced ``cell``-sized tiles.

    ``corpus_t`` is the flat ``[D, N]`` layout (any float dtype) on the
    device the index is to live on. Lloyd iterations score on the device
    (blocked matmuls); the balanced assignment is a host pass. With
    ``quantize`` the cells are stored int8.

    ``free_source`` drops this function's reference to the source matrix
    before the final layout is made: before the int8 gather, or, for float
    cells, between the gather and the transposing copy (which would
    otherwise hold three corpus-sized tensors at once). The caller's own
    reference keeps it alive, except when the corpus was padded here: then
    the reference dropped is the padded copy. The index is the same either
    way.

    ``candidates`` bounds how far a point can fall from its best cell under
    capacity pressure: when a natural cluster is larger than ``cell``, its
    overflow points take their next-best candidate with free slots; past
    the candidate list they are placed arbitrarily."""
    d, n = corpus_t.shape
    dev = corpus_t.device
    pad = -n % cell
    if pad:
        corpus_t = torch.nn.functional.pad(corpus_t, (0, pad))
    n_pad = n + pad
    n_cells = n_pad // cell

    # Reserve the TAIL cells' final slots for pad columns: the kernel masks
    # invalid columns by permuted position (< n_valid), so every pad must end
    # up in the last `pad` permuted positions.
    capacity = np.full(n_cells, cell, np.int64)
    rem, ci = pad, n_cells - 1
    while rem > 0:
        take = min(rem, int(capacity[ci]))
        capacity[ci] -= take
        rem -= take
        ci -= 1

    def with_pads(assign_real: np.ndarray) -> np.ndarray:
        free = np.full(n_cells, cell, np.int64) - np.bincount(assign_real, minlength=n_cells)
        return np.concatenate([assign_real, np.repeat(np.arange(n_cells), free)])

    def means_segments(assign_np: np.ndarray) -> torch.Tensor:
        # For centroid means, pad columns go to the dump slot: their
        # tail-cell assignment is only for the permutation.
        seg = assign_np.copy()
        seg[n:] = n_cells
        return torch.from_numpy(seg).to(dev)

    # The scan block is a whole number of cells that divides n_pad.
    div = max(k for k in range(1, min(32, n_cells) + 1) if n_cells % k == 0)
    block_cols = div * cell

    # Init from random real points (the JAX package's picks: same generator).
    rng = np.random.default_rng(seed)
    picks = torch.from_numpy(rng.choice(n, size=n_cells, replace=False)).to(dev)
    centroids = corpus_t[:, picks].T.float()

    topc = min(candidates, n_cells)
    assign_np = None
    for it in range(max(iters, 1)):
        if it:
            centroids = _cell_means(corpus_t, means_segments(assign_np), n_cells, block_cols)
        ts, ti = _candidate_cells(corpus_t, centroids, topc, block_cols)
        assign_real = _balanced_assign(ts[:n].cpu().numpy(), ti[:n].cpu().numpy(), capacity)
        assign_np = with_pads(assign_real)

    # Permutation: cluster-major order, stable within a cell (pads were
    # appended after all real points, so they sort last within their cell
    # and, via the tail-cell reservation, occupy the global tail).
    perm = np.argsort(assign_np, kind="stable")  # [N_pad] permuted pos -> input pos
    orig_ids = np.where(perm < n, perm, INT32_MAX).astype(np.int32)
    assert pad == 0 or bool(np.all(perm[n_pad - pad:] >= n)), "pads must sort last"

    centroids = _cell_means(corpus_t, means_segments(assign_np), n_cells, block_cols)

    # Quantize BEFORE the permutation gather so the gather moves int8.
    perm_dev = torch.from_numpy(perm).to(dev)
    scales = None
    if quantize:
        c8, sc = quantize_corpus_t(corpus_t)
        if free_source:
            del corpus_t
        c8 = c8[:, perm_dev]
        sc = sc[:, perm_dev]
        cells = c8.reshape(d, n_cells, cell).permute(1, 0, 2).contiguous()
        scales = sc.reshape(1, n_cells, cell).permute(1, 0, 2).contiguous()
    else:
        corpus_perm = corpus_t[:, perm_dev]
        if free_source:
            del corpus_t
        cells = corpus_perm.reshape(d, n_cells, cell).permute(1, 0, 2).contiguous()

    return IVFIndex(
        cells=cells,
        scales=scales,
        centroids=centroids,
        orig_ids=torch.from_numpy(orig_ids).to(dev),
        n_valid=n,
    )


def _probe_stage(queries: torch.Tensor, centroids: torch.Tensor, block_q: int, nprobe: int):
    """Per-query-tile probe lists. Returns ``(qf [Qp, D] f32 sorted by best
    cell and zero-padded to a multiple of block_q, order [Qp], inv_order [Q],
    probe [q_tiles, nprobe] int32 ascending per row)``."""
    q = queries.shape[0]
    n_cells = centroids.shape[0]
    dev = queries.device
    pad_q = -q % block_q
    qf = queries.float()
    if pad_q:
        qf = torch.nn.functional.pad(qf, (0, 0, 0, pad_q))
    qp = qf.shape[0]
    q_tiles = qp // block_q
    cscores = torch.matmul(qf, centroids.T)  # [qp, C]
    real = torch.arange(qp, device=dev) < q
    if pad_q:
        # Zero-pad query rows score 0.0 against every centroid and would
        # distort the tile's probe ranking; mask them out of the tile max.
        cscores = cscores.masked_fill(~real[:, None], NEG_INF)

    # A tile's probe set serves ALL its queries: sort the batch by each
    # query's best cell (pads forced last) so a tile's probe union stays small.
    # Lowest index holding the row maximum (jnp.argmax's tie rule).
    cell_ids = torch.arange(n_cells, device=dev)
    is_max = cscores == cscores.amax(dim=-1, keepdim=True)
    top1 = torch.where(is_max, cell_ids, torch.full_like(cell_ids, n_cells)).amin(dim=-1)
    if pad_q:
        top1 = torch.where(real, top1, torch.full_like(top1, n_cells))
    order = torch.sort(top1, stable=True)[1]
    inv_order = torch.sort(order, stable=True)[1][:q]
    qf = qf[order]
    cscores = cscores[order]

    # Rank cells by the best affinity any query in the tile has to them.
    tile_scores = cscores.reshape(q_tiles, block_q, n_cells).amax(dim=1)
    probe = _select(tile_scores, nprobe)[1]  # [q_tiles, nprobe]
    probe = torch.sort(probe, dim=-1)[0].to(torch.int32).contiguous()  # ascending ids: exact ties
    return qf, order, inv_order, probe


def stage_queries(queries: torch.Tensor, index: IVFIndex, nprobe: int, block_q: int, precision: str):
    """The pruned kernel's inputs for a query batch: ``(qin [Qp, D], qscale
    [Qp, 1] or None, probe [q_tiles, nprobe], inv_order [Q])``. Rows are
    sorted by best cell and padded to whole tiles; ``inv_order`` undoes it."""
    qf, order, inv_order, probe = _probe_stage(queries, index.centroids, block_q, nprobe)
    if index.scales is not None:
        q8, qscale = quantize_queries(queries)
        pad_q = qf.shape[0] - queries.shape[0]
        if pad_q:
            q8 = torch.nn.functional.pad(q8, (0, 0, 0, pad_q))
            qscale = torch.nn.functional.pad(qscale, (0, 0, 0, pad_q))
        return q8[order], qscale[order], probe, inv_order
    if precision == "fast" and index.cells.dtype == torch.bfloat16:
        # One bf16 product with f32 accumulation: the queries are rounded to
        # bf16, as the JAX fast tier casts them to the cells' dtype.
        qf = qf.to(torch.bfloat16).float()
    return qf, None, probe, inv_order


def pruned_topk_plain(
    qin: torch.Tensor,
    qscale: Optional[torch.Tensor],
    cells: torch.Tensor,
    scales: Optional[torch.Tensor],
    probe: torch.Tensor,
    n_valid: int,
    k: int,
    block_q: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the pruned kernel (same contract as
    :func:`pruned_topk`): per query tile, gather the probed cells, score,
    mask permuted positions at or past ``n_valid``, select."""
    n_cells, d, cell = cells.shape
    qp = qin.shape[0]
    q_tiles, nprobe = probe.shape
    out_s = torch.empty((qp, k), dtype=torch.float32, device=qin.device)
    out_i = torch.empty((qp, k), dtype=torch.int32, device=qin.device)
    col = torch.arange(cell, device=qin.device)
    for i in range(q_tiles):
        rows = slice(i * block_q, (i + 1) * block_q)
        pr = probe[i].long()
        ids = (pr[:, None] * cell + col[None, :]).reshape(-1)  # ascending permuted ids
        ct = cells[pr].permute(1, 0, 2).reshape(d, nprobe * cell)
        if scales is not None:
            cs = scales[pr].reshape(1, -1)
            scores = _int_scores(qin[rows], ct) * qscale[rows] * cs
        else:
            scores = torch.matmul(qin[rows].float(), ct.float())
        scores = scores.masked_fill(ids[None, :] >= n_valid, NEG_INF)
        s, pos = _fused_select(scores, k)
        found = pos != INT32_MAX
        gathered = ids[pos.long().clamp(max=ids.shape[0] - 1)].to(torch.int32)
        out_s[rows] = s
        out_i[rows] = torch.where(found, gathered, torch.full_like(gathered, INT32_MAX))
    return out_s, out_i


def _splits(q_blocks: int, nprobe: int, tiles_per_cell: int, device: torch.device) -> int:
    """How many blocks share one probed cell: the largest divisor of its
    tile count that keeps the grid within about two waves of pass 1's
    512-thread blocks, one per SM (and its second dimension within CUDA's
    limit), so a single query tile still fills the card and a large batch
    does not multiply its partial lists. (chip_smoke.py --sweep times the
    rule against fixed splits.)"""
    sms = _sm_count(_device_index(device))
    best = 1
    for s in range(1, tiles_per_cell + 1):
        if tiles_per_cell % s:
            continue
        if nprobe * s > _MAX_GRID_Y or q_blocks * nprobe * s > 2 * sms:
            break
        best = s
    return best


def pruned_topk(
    qin: torch.Tensor,
    qscale: Optional[torch.Tensor],
    cells: torch.Tensor,
    scales: Optional[torch.Tensor],
    probe: torch.Tensor,
    n_valid: int,
    k: int,
    block_q: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the probed cells only.

    ``qin [Qp, D]`` (Qp a multiple of ``block_q``) is f32 for float cells
    (already rounded to bf16 values for the fast tier) or int8 with
    ``qscale [Qp, 1]`` for int8 cells with ``scales [n_cells, 1, cell]``;
    ``probe [Qp / block_q, nprobe]`` int32 ascending per row. Returns
    ``(scores [Qp, k] f32, permuted ids [Qp, k] int32)``, empty slots
    ``(-inf, INT32_MAX)``. CUDA tensors run ``csrc/ivf_topk.cu``; CPU
    tensors the plain version. Launches are counted in ``.launches``."""
    int8 = scales is not None
    if (cells.dtype == torch.int8) != int8 or (qin.dtype == torch.int8) != int8:
        raise TypeError("int8 cells take int8 queries with qscale and scales; float cells f32 queries")
    if qin.shape[0] % block_q or probe.shape[0] != qin.shape[0] // block_q:
        raise ValueError("queries must fill whole tiles of block_q rows, one probe row per tile")
    if not cells.is_cuda:
        return pruned_topk_plain(qin, qscale, cells, scales, probe, n_valid, k, block_q)
    from . import _cuda

    n_cells, d, cell = cells.shape
    qp = qin.shape[0]
    nprobe = probe.shape[1]
    if any(t is not None and t.device != cells.device for t in (qin, qscale, scales, probe)):
        raise ValueError("queries, cells, scales and probe must lie on the same CUDA device")
    if cells.dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise TypeError(f"cells dtype {cells.dtype} is not f32, bf16 or int8")
    if not int8 and qin.dtype != torch.float32:
        raise TypeError("float cells take f32 queries")
    if qin.dim() != 2 or qin.shape[1] != d:
        raise ValueError(f"queries {tuple(qin.shape)} do not match cells {tuple(cells.shape)}")
    if not 1 <= k <= FUSED_MAX_K:
        raise ValueError(f"the CUDA pruned kernel takes 1 <= k <= {FUSED_MAX_K}, got k={k}")
    if cell % _KERNEL_TILE_N:
        raise ValueError(f"the CUDA pruned kernel needs cell to be a multiple of {_KERNEL_TILE_N}")
    if block_q % 8:
        raise ValueError("the CUDA pruned kernel needs block_q to be a multiple of 8")
    if int8 and d % 4:
        raise ValueError("the int8 kernel needs D to be a multiple of 4")
    if nprobe > min(n_cells, _MAX_GRID_Y) or n_cells * cell >= 2**31:
        raise ValueError("nprobe must be at most n_cells and 65535; n_cells * cell under 2^31")
    if probe.dtype != torch.int32:
        raise TypeError("probe must be int32")
    if not cells.is_contiguous() or (int8 and not scales.is_contiguous()):
        raise ValueError("cells and scales must be contiguous")
    qin, probe = qin.contiguous(), probe.contiguous()
    if int8:
        if scales.dtype != torch.float32 or scales.numel() != n_cells * cell:
            raise TypeError("scales must be f32, one per column")
        qscale = qscale.float().contiguous()
        if qscale.numel() != qp:
            raise ValueError("qscale must hold one scale per query row")
    # 8 or 32 rows a block: the probed walk's 64-row block spilled registers.
    fits = [t for t in (8, 32) if block_q % t == 0]
    tq = _pass1_tile(block_q, d, cells.element_size(), allowed=fits)
    splits = _splits(qp // tq, nprobe, cell // _KERNEL_TILE_N, cells.device)
    part_s = torch.empty((nprobe * splits, qp, k), dtype=torch.float32, device=cells.device)
    part_i = torch.empty((nprobe * splits, qp, k), dtype=torch.int32, device=cells.device)
    out_s = torch.empty((qp, k), dtype=torch.float32, device=cells.device)
    out_i = torch.empty((qp, k), dtype=torch.int32, device=cells.device)
    dtype_code = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[cells.dtype]
    with torch.cuda.device(cells.device):  # launch on the cells' card
        err = _cuda.kernel("ivf_topk")(
            qin.data_ptr(), qscale.data_ptr() if int8 else None, qp, d,
            cells.data_ptr(), scales.data_ptr() if int8 else None, dtype_code, n_cells, cell,
            min(int(n_valid), n_cells * cell), k, tq, block_q, probe.data_ptr(), nprobe, splits,
            part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(cells.device).cuda_stream,
        )
    _cuda.check(err, "ivf_topk")
    pruned_topk.launches += 1
    return out_s, out_i


pruned_topk.launches = 0


def ivf_topk(
    queries: torch.Tensor,
    index: IVFIndex,
    k: int,
    nprobe: int = 32,
    block_q: int = 128,
    precision: str = "fast",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate cosine top-k over an :class:`IVFIndex`.

    ``nprobe`` of the index's cells are scanned per query tile (ranked by
    centroid affinity). ``nprobe == index.n_cells`` is exhaustive and matches
    the exact kernel. Returns ids in ORIGINAL corpus order."""
    _check_precision(precision)
    cells, scales = index.cells, index.scales
    n_cells = index.n_cells
    nprobe = min(nprobe, n_cells)
    queries = queries.to(cells.device)
    q = queries.shape[0]
    if q == 0:
        return (
            torch.empty((0, k), dtype=torch.float32, device=cells.device),
            torch.empty((0, k), dtype=torch.int32, device=cells.device),
        )
    qin, qscale, probe, inv_order = stage_queries(queries, index, nprobe, block_q, precision)
    out_s, out_i = pruned_topk(qin, qscale, cells, scales, probe, index.n_valid, k, block_q)
    # Undo the query sort, then map permuted corpus positions back to
    # original ids (pads -> INT32_MAX).
    out_s, out_i = out_s[inv_order], out_i[inv_order]
    safe = out_i.long().clamp(max=index.orig_ids.shape[0] - 1)
    ids = torch.where(out_i == INT32_MAX, torch.full_like(out_i, INT32_MAX), index.orig_ids[safe])
    return out_s, ids
