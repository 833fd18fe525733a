"""Multi-device IVF: cluster cells sharded over a mesh, probe routing.

Counterpart of ``ragfin_tpu/parallel/sharded_ivf.py``. The balanced cell
array ``[C, D, cell]`` of :mod:`ragfin_tpu_torch.ops.ivf` is split by cells
over a 1-D mesh, each shard owning ``C/P`` consecutive cells. A query
tile's ``nprobe`` probed cells are scored only by their owners, and the
per-shard candidate top-k lists merge on the mesh's first device, as in
the exact sharded path (:mod:`.sharded`); cells partition the corpus, so
the merge needs no dedup.

Routing is masked ownership, as in JAX: every shard walks the whole probe
list of a tile and scores the probed cells it owns. Scoring is plain torch
(a gather of the owned cells, one product, a stable selection), as JAX
scores in plain XLA: no kernel. JAX keeps a running top-k over the probes
in probe order; one stable selection over the owned cells in probe order
gives the same list (earlier probes first on ties).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.ivf import IVFIndex, _probe_stage
from ..ops.topk import INT32_MAX, NEG_INF, _fused_select
from .mesh import Mesh, all_gather, gather_processes, on_device, process_span, shard
from .sharded import merge_topk


def pad_cells_for_mesh(ivf: IVFIndex, n_dev: int):
    """Pad the cell axis to a multiple of the shard count with empty cells
    (zero vectors, INT32_MAX ids: they score -inf through the id mask).
    Returns ``(cells, scales, ids [C, cell], padded cell count)``."""
    c, _, cell = ivf.cells.shape
    pad = -c % n_dev
    cells, scales = ivf.cells, ivf.scales
    ids = ivf.orig_ids.reshape(c, cell)
    if pad:
        cells = torch.cat([cells, cells.new_zeros((pad,) + cells.shape[1:])])
        if scales is not None:
            scales = torch.cat([scales, scales.new_zeros((pad,) + scales.shape[1:])])
        ids = torch.cat([ids, ids.new_full((pad, cell), INT32_MAX)])
    return cells, scales, ids, c + pad


class ShardedIVFArrays(tuple):
    """(cells, scales, ids, centroids, n_cells_real): a named tuple-alike,
    so 4-way unpacking fails loudly rather than dropping the pad count."""

    __slots__ = ()


def shard_ivf_arrays(mesh: Mesh, axis: str, ivf: IVFIndex) -> ShardedIVFArrays:
    """Place an IVFIndex's arrays for :func:`sharded_ivf_topk`: this
    process's shards of the cells, scales and ids, the centroids (padded
    with zero rows, which probe selection masks by index) on the mesh's
    first device, and the count of real cells."""
    n_shards = mesh.shape[axis] * process_span()[1]
    n_real = ivf.cells.shape[0]
    cells, scales, ids, c_total = pad_cells_for_mesh(ivf, n_shards)
    centroids = ivf.centroids
    if c_total > n_real:
        centroids = torch.cat([centroids, centroids.new_zeros((c_total - n_real, centroids.shape[1]))])
    return ShardedIVFArrays((
        shard(mesh, axis, cells, 0),
        None if scales is None else shard(mesh, axis, scales, 0),
        shard(mesh, axis, ids, 0),
        centroids.to(mesh.axis_devices(axis)[0]),
        n_real,
    ))


def _scan_tile(q_tile, probe, base, cells_l, scales_l, ids_l, k):
    """One shard's top-k for one query tile over the probed cells it owns,
    in probe order: ``([block_q, k] scores, [block_q, k] original ids)``."""
    local = probe.long() - base
    local = local[(local >= 0) & (local < cells_l.shape[0])]
    blocks = cells_l[local].float()  # [m, D, cell]
    scores = torch.matmul(q_tile, blocks)  # [m, block_q, cell]
    if scales_l is not None:
        scores = scores * scales_l[local]
    ids = ids_l[local].reshape(-1)
    scores = scores.permute(1, 0, 2).reshape(q_tile.shape[0], -1)
    scores = scores.masked_fill((ids == INT32_MAX)[None, :], NEG_INF)
    s, pos = _fused_select(scores, k)
    if not ids.numel():  # the shard owns none of the tile's probes
        return s, pos
    return s, torch.where(pos == INT32_MAX, pos, ids[pos.long().clamp(max=ids.shape[0] - 1)])


def sharded_ivf_topk(
    mesh: Mesh,
    axis: str,
    queries: torch.Tensor,
    cells_sharded,
    scales_sharded,
    ids_sharded,
    centroids: torch.Tensor,
    k: int,
    nprobe: int = 32,
    block_q: int = 8,
    n_cells_real: Optional[int] = None,
):
    """Cluster-pruned top-k over mesh-sharded cells.

    ``cells_sharded`` / ``ids_sharded`` (and ``scales_sharded`` for int8)
    are this process's shards from :func:`shard_ivf_arrays`, ``centroids
    [C, D]`` all of them. ``n_cells_real`` is the count of REAL cells: pad
    cells are excluded from probe selection by index (a constant pad
    centroid would score value * sum(q), hugely positive for a query with a
    negative coordinate sum, and steal every probe slot). Probes and the
    query order (each tile's queries share their best cell) are those of the
    single-device tier. Returns ``([Q, k] scores, [Q, k] ORIGINAL ids)`` on
    the mesh's first device."""
    devices = mesh.axis_devices(axis)
    rank, world = process_span()
    c_local = cells_sharded[0].shape[0]
    c_total = c_local * len(devices) * world
    if n_cells_real is None:
        n_cells_real = c_total
    qf, _, inv_order, probes = _probe_stage(
        queries.to(devices[0], torch.float32), centroids[:n_cells_real].to(devices[0]),
        block_q, min(nprobe, n_cells_real),
    )
    tiles = qf.reshape(-1, block_q, qf.shape[1])
    cand_s, cand_i = [], []
    for j, dev in enumerate(devices):
        base = (rank * len(devices) + j) * c_local
        scales_l = None if scales_sharded is None else scales_sharded[j]
        with on_device(dev):
            tile_s, tile_i = zip(*(
                _scan_tile(t.to(dev), p.to(dev), base, cells_sharded[j], scales_l, ids_sharded[j], k)
                for t, p in zip(tiles, probes)
            ))
        cand_s.append(torch.cat(tile_s))
        cand_i.append(torch.cat(tile_i))
    top_s, top_i = merge_topk(all_gather(cand_s, devices[0], 1), all_gather(cand_i, devices[0], 1), k)
    if world > 1:
        top_s, top_i = merge_topk(gather_processes(top_s, 1), gather_processes(top_i, 1), k)
    return top_s[inv_order], top_i[inv_order]
