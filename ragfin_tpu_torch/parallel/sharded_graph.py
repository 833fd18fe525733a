"""Row-sharded graph match: the graph store's fact table over a 1-D mesh.

Counterpart of ``ragfin_tpu/parallel/sharded_graph.py``. The fact table's
id columns (quarter, entity, type, company, validity) are split by rows,
one partition per shard; the small vocabulary masks are replicated. Each
shard evaluates the masked predicate over its rows, selects its first
``limit`` hit rows by global CSR rank, and the per-shard candidates, at
most ``limit`` rows each, merge on the mesh's first device into the first
``limit`` rows overall, exactly the :mod:`.sharded` vector-search pattern
applied to the graph store.

The local selection is the single-device store's: from ``FIRST_K_MIN_ROWS``
rows a shard the first-k kernel (:func:`~ragfin_tpu_torch.index.graph_index.
masked_first_k`, ``csrc/first_k.cu`` on a card), below it a top-k over the
rank key ``-row`` (what JAX's shard computes at every size). The table is
sorted, so the first hits are the highest-ranked.

Parity contract: the same rows in the same CSR order as the single-device
:meth:`GraphIndex.match` for any mask combination, and the total hit count.
Unlike JAX's, the default mesh works here (every CUDA device).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..index.graph_index import _INT_MAX, _RANK_MISS, FIRST_K_MIN_ROWS, _predicate, masked_first_k
from .mesh import Mesh, all_gather, gather_processes, make_mesh, on_device, process_span, psum, shard


def _first_rows(hit: torch.Tensor, k: int, base: int) -> torch.Tensor:
    """Global ids (int64) of the first ``k`` set rows of one shard's hit
    vector, ``_INT_MAX`` past the hits."""
    if hit.shape[0] >= FIRST_K_MIN_ROWS:
        rows, _ = masked_first_k(hit, k)
    else:
        row_idx = torch.arange(hit.shape[0], dtype=torch.int32, device=hit.device)
        key = torch.where(hit, -row_idx, torch.full_like(row_idx, _RANK_MISS))
        top, rows = torch.topk(key, k)
        rows = rows.masked_fill(top == _RANK_MISS, _INT_MAX)
    rows = rows.to(torch.int64)
    return torch.where(rows == _INT_MAX, rows, rows + base)


def _merge_rows(cand: torch.Tensor, k: int) -> torch.Tensor:
    return torch.sort(cand)[0][: min(k, cand.shape[0])]


class ShardedGraphIndex:
    """Mesh-sharded read view over a built :class:`GraphIndex`.

    Mirrors ``GraphIndex.match`` semantics (quarters/names/types/companies
    masks, limit, CSR result order, reference Cypher result-dict shapes)
    with the fact table partitioned across devices. The host-side vocab,
    metadata sidecar, and result materialization stay on the wrapped graph.
    """

    def __init__(self, graph, mesh: Optional[Mesh] = None, axis: str = "shards"):
        self.graph = graph
        self.mesh = mesh if mesh is not None else make_mesh((axis,))
        self.axis = axis
        packed = graph._pack()
        n_shards = self.mesh.shape[axis] * process_span()[1]
        total = int(packed["quarter_ids"].shape[0])
        self.n_rows = int(packed["n"])
        # Re-pad so rows split evenly across shards (the store's 128-row
        # padding need not divide by the shard count).
        self.total = -(-total // n_shards) * n_shards
        self.shard_rows = self.total // n_shards
        pad = self.total - total

        def place(col, default):
            if pad:
                col = torch.cat([col, col.new_full((pad,), default)])
            return shard(self.mesh, axis, col, 0)

        self.quarter_ids = place(packed["quarter_ids"], 0)
        self.entity_ids = place(packed["entity_ids"], 0)
        self.type_ids = place(packed["type_ids"], 0)
        self.company_ids = place(packed["company_ids"], 0)
        self.row_valid = place(packed["row_valid"], False)

    def _company_mask(self, companies: Optional[Sequence[str]]) -> torch.Tensor:
        cm = np.zeros((max(len(self.graph._companies), 1),), bool)
        if not companies:
            cm[:] = True
        else:
            for c in companies:
                ci = self.graph._company_id_of.get(c)
                if ci is not None:
                    cm[ci] = True
        return torch.from_numpy(cm)

    def match_rows(
        self,
        quarters: Optional[Sequence[str]] = None,
        names: Optional[Sequence[str]] = None,
        types: Optional[Sequence[int]] = None,
        limit: int = 30,
        companies: Optional[Sequence[str]] = None,
    ):
        """(rows [kk] int32 in CSR order, valid [kk] bool, total hit count)
        on the mesh's first device, ``kk = min(limit, shards * min(limit,
        shard rows))``; invalid slots hold ``INT32_MAX``."""
        masks = (*self.graph._masks(quarters, names, types), self._company_mask(companies))
        devices = self.mesh.axis_devices(self.axis)
        rank, world = process_span()
        local_k = min(limit, self.shard_rows)
        cand, counts = [], []
        for j, dev in enumerate(devices):
            base = (rank * len(devices) + j) * self.shard_rows
            with on_device(dev):
                qm, em, tm, cm = (m.to(dev) for m in masks)
                hit = _predicate(
                    self.quarter_ids[j], self.entity_ids[j], self.type_ids[j],
                    self.row_valid[j] & cm[self.company_ids[j]], qm, em, tm,
                )
                cand.append(_first_rows(hit, local_k, base))
                counts.append(hit.sum())
        rows = _merge_rows(all_gather(cand, devices[0]), limit)
        count = psum(counts, devices[0])
        if world > 1:
            rows = _merge_rows(gather_processes(rows, 0), limit)
            count = gather_processes(count.reshape(1), 0).sum()
        return rows.to(torch.int32), rows != _INT_MAX, count

    def match(
        self,
        quarters: Optional[Sequence[str]] = None,
        names: Optional[Sequence[str]] = None,
        types: Optional[Sequence[int]] = None,
        limit: int = 30,
        companies: Optional[Sequence[str]] = None,
    ) -> list[dict]:
        packed = self.graph._pack()
        if packed["n"] == 0:
            return []
        top_rows, valid, _count = self.match_rows(
            quarters, names, types, limit=limit, companies=companies
        )
        rows = top_rows.cpu().numpy()
        ok = valid.cpu().numpy() & (rows < self.n_rows)
        return self.graph._rows_to_dicts(packed, rows, ok)
