"""IVF vector index: the cluster-pruned approximate tier as a first-class
index (the reference's production index type, Milvus IVF_FLAT, with its
nlist/nprobe semantics).

Counterpart of ``ragfin_tpu/index/ivf_index.py``: wraps
:mod:`ragfin_tpu_torch.ops.ivf` with the DeviceVectorIndex search surface
(records sidecar, SearchHit results, text queries through the index's
embedder) and persistence in the JAX package's format (``ivf.json`` +
``ivf.npz``; an index saved by either package loads in the other).
Metadata-filtered search is NOT offered here: filters need per-row masks
which defeat cluster pruning; filtered queries belong on the exact index.
Hashed queries are expanded with financial synonyms, as on the flat index,
and encoded by the embedder or by the featurizer + encoder pair.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.models import IndexedChunk
from ..models.bag_encoder import BagEncoder
from ..models.featurizer import HashedFeaturizer
from ..ops.ivf import IVFIndex, build_ivf, ivf_from_numpy, ivf_topk
from ..ops.topk import INT32_MAX as _INT_MAX
from ..utils.device import DeviceLike, resolve_device
from .vector_index import SearchHit, _exact_rerank_host, _host, _repair_width

def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


# Per-group cap on stored duplicate ids: a boundary tie group contributes at
# most top_k members to an exact result, so the expansion never needs more
# than the group's k lowest ids; 64 covers every production k.
_DUP_CAP = 64


def _dup_groups_from_rows(rows: np.ndarray, cap: int = _DUP_CAP):
    """Duplicate-row groups of a host embedding matrix, for exact tie repair.

    Template near-duplicates embed BITWISE identically under the trained
    encoder (collapse_numbers maps figure-perturbed chunks to the same token
    multiset), producing exact-tie groups of hundreds of members at 1M
    distractors (measured: up to 417 rows sharing one cosine score across
    the rank-10 boundary). The IVF kernel tie-breaks by PERMUTED position,
    so its shortlist holds an arbitrary subset of such a group while the
    exact oracle returns the group's lowest ORIGINAL ids — no shortlist
    width can close that (the group exceeds any fixed width).

    Grouping is by a 64-bit hash of the row bytes — a SUPERSET of the true
    duplicate groups (hash collisions can only merge distinct rows, never
    split identical ones), which is safe because the repair re-scores every
    expanded candidate exactly: a falsely-merged candidate just sorts to its
    true rank.

    Returns ``None`` when no duplicates exist, else
    ``(member_ids, member_group, group_offsets, group_ids)``:
    ``member_ids`` sorted ascending for searchsorted lookup, ``member_group``
    the group index per member, ``group_ids`` the concatenated per-group
    lowest-``cap`` ids (ascending) sliced by ``group_offsets``.
    """
    n = rows.shape[0]
    if n == 0:
        return None
    w = np.ascontiguousarray(rows).view(np.uint8).reshape(n, -1)
    pad = -w.shape[1] % 8
    if pad:
        w = np.pad(w, ((0, 0), (0, pad)))
    w = w.view(np.uint64)
    rng = np.random.default_rng(0xD1CE)
    mult = (rng.integers(0, 2**62, size=w.shape[1], dtype=np.uint64) << np.uint64(1)) | np.uint64(1)
    h = np.empty(n, np.uint64)
    step = 1_000_000  # bound the [step, words] uint64 transient (~1.5 GB)
    with np.errstate(over="ignore"):
        for s in range(0, n, step):
            h[s : s + step] = (w[s : s + step] * mult).sum(axis=1, dtype=np.uint64)
    order = np.argsort(h, kind="stable")  # equal hashes keep ascending id
    hs = h[order]
    bound = np.flatnonzero(np.r_[True, hs[1:] != hs[:-1]])
    lens = np.diff(np.r_[bound, n])
    dup_run = lens > 1
    if not dup_run.any():
        return None
    run_of = np.repeat(np.arange(lens.size), lens)
    keep = dup_run[run_of]
    members = order[keep].astype(np.int64)  # run-major, ascending id in run
    member_group = (np.cumsum(dup_run) - 1)[run_of][keep].astype(np.int32)
    # Lowest `cap` ids per group: position within the run < cap.
    pos_in_run = np.arange(n) - np.repeat(bound, lens)
    low = keep & (pos_in_run < cap)
    group_ids = order[low].astype(np.int64)
    glens = np.minimum(lens[dup_run], cap)
    group_offsets = np.r_[0, np.cumsum(glens)].astype(np.int64)
    by_id = np.argsort(members, kind="stable")
    return members[by_id], member_group[by_id], group_offsets, group_ids


class IVFVectorIndex:
    """Approximate (cluster-pruned) search over a chunk corpus.

    ``nprobe`` trades recall for throughput exactly like Milvus IVF_FLAT's
    query param; ``nprobe == n_cells`` is exhaustive (exact scores).
    """

    def __init__(
        self,
        ivf: IVFIndex,
        records: Sequence[IndexedChunk],
        nprobe: int = 32,
        name: str = "fin_chunks_ivf",
        exact_rows=None,
    ):
        self.ivf = ivf
        self.device = ivf.cells.device
        self.records = list(records)
        self._by_id = {r.id: i for i, r in enumerate(self.records)}
        self.nprobe = min(nprobe, ivf.n_cells)
        self.name = name
        self.n = ivf.n_valid
        self.dim = ivf.cells.shape[1]
        self.embedder = None
        self.featurizer = None
        self.encoder = None
        # Exact-repair shadow: pre-quantization f32/f16 rows in ORIGINAL id
        # order, kept on the HOST. The kernel scores its cells at fast/int8
        # precision and breaks ties by permuted position; the device returns
        # a widened shortlist, the host re-scores it exactly and applies the
        # oracle tie-break. Full probe + repair == exact search.
        if exact_rows is not None:
            exact_rows = np.asarray(exact_rows)
            if exact_rows.shape[0] != self.n:
                raise ValueError(
                    f"exact_rows rows ({exact_rows.shape[0]}) != n_valid ({self.n})"
                )
        self._exact_rows = exact_rows
        self._dup_cache = False  # lazily replaced by _dup_groups_from_rows(...)

    supports_filters = False  # filters defeat cluster pruning (see module doc)

    @property
    def quantized(self) -> bool:
        return self.ivf.scales is not None

    @property
    def dtype(self) -> torch.dtype:
        return self.ivf.cells.dtype

    # --- build -----------------------------------------------------------
    @classmethod
    def from_dense(
        cls,
        index,
        cell: int = 2048,
        nprobe: int = 32,
        iters: int = 4,
        quantize: Optional[bool] = None,
        seed: int = 0,
        exact_shadow: bool = True,
        **kwargs,
    ) -> "IVFVectorIndex":
        """Cluster an existing DeviceVectorIndex (keeps its embedder, device
        and quantization tier unless ``quantize`` overrides).

        ``exact_shadow`` keeps host f32 rows for the exact shortlist repair
        (default on, mirroring the dense int8 tier); the dense index's own
        shadow is reused when present, else one device-to-host transfer."""
        if quantize is None:
            quantize = bool(getattr(index, "quantized", False))
        if getattr(index, "quantized", False):
            dense = (index.matrix_t.float() * index.scales)[:, : index.n]
        else:
            dense = index.matrix_t[:, : index.n].float()
        rows = None
        if exact_shadow:
            rows = getattr(index, "_exact_rows", None)
            if rows is None:
                rows = dense.T.contiguous().cpu().numpy()
        ivf = build_ivf(dense, cell=cell, iters=iters, seed=seed, quantize=quantize)
        out = cls(ivf, index.records, nprobe=nprobe, exact_rows=rows, **kwargs)
        # The hashed backend may encode queries with the featurizer +
        # encoder pair instead of an embedder object: carry all three.
        out.embedder = getattr(index, "embedder", None)
        out.featurizer = getattr(index, "featurizer", None)
        out.encoder = getattr(index, "encoder", None)
        return out

    @classmethod
    def build(
        cls,
        embeddings,
        records: Sequence[IndexedChunk],
        cell: int = 2048,
        nprobe: int = 32,
        iters: int = 4,
        quantize: bool = False,
        normalize: bool = True,
        seed: int = 0,
        exact_shadow: bool = True,
        device: DeviceLike = None,
        **kwargs,
    ) -> "IVFVectorIndex":
        dev = resolve_device(device)
        if not isinstance(embeddings, torch.Tensor):
            embeddings = torch.from_numpy(np.asarray(embeddings, np.float32))
        embeddings = embeddings.to(dev, torch.float32)
        if normalize and embeddings.numel():
            embeddings = l2_normalize(embeddings)
        ivf = build_ivf(
            embeddings.T.contiguous(), cell=cell, iters=iters, seed=seed, quantize=quantize
        )
        rows = embeddings.cpu().numpy() if exact_shadow else None
        return cls(ivf, records, nprobe=nprobe, exact_rows=rows, **kwargs)

    # --- search ----------------------------------------------------------
    def search_embeddings(
        self,
        query_embeddings,
        top_k: int = 3,
        nprobe: Optional[int] = None,
        block_q: int = 8,
        exact_repair: Optional[bool] = None,
    ):
        """Cluster-pruned search.

        ``block_q`` controls probe-list granularity: a probe set is shared
        by each tile of ``block_q`` queries (ranked by the best centroid
        affinity ANY tile member has), so the default stays 8 at every batch
        size: a mixed batch at block_q=128 collapses recall because 128
        diverse queries dilute each other's probes. The probe stage sorts
        the batch by best cell first, so same-region queries still coalesce
        into shared tiles.

        ``exact_repair`` (default: on whenever the exact-rows shadow exists)
        widens the device shortlist and exactly re-scores it on the host:
        residual error is then PURELY cluster pruning, and full probe equals
        exact search. f32 cells score at full f32 precision; bf16 cells run
        the fast tier; int8 cells keep their integer path (their
        quantization epsilon is what the repair exists for).

        Returns ``(scores, ids)``: tensors on the index's device without the
        repair, host arrays with it."""
        if isinstance(query_embeddings, torch.Tensor):
            q = query_embeddings.to(self.device, torch.float32)
        else:
            q = torch.from_numpy(np.asarray(query_embeddings, np.float32)).to(self.device)
        k = min(top_k, max(self.n, 1))
        precision = "exact" if self.ivf.cells.dtype == torch.float32 else "fast"
        repair = (
            self._exact_rows is not None and self.n > 0
            if exact_repair is None
            else exact_repair and self._exact_rows is not None and self.n > 0
        )
        if not repair:
            return ivf_topk(
                q, self.ivf, k, nprobe=nprobe or self.nprobe, block_q=block_q,
                precision=precision,
            )
        # A shortlist of at least 64: trained embedding spaces pack more
        # than 16 near-ties around the rank-10 boundary.
        kr = min(max(_repair_width(k), 64), max(self.n, 1))
        _, ids = ivf_topk(
            q, self.ivf, kr, nprobe=nprobe or self.nprobe, block_q=block_q,
            precision=precision,
        )
        ids = self._expand_ties(_host(ids), k)
        return _exact_rerank_host(_host(q), ids, self._exact_rows, k)

    def _expand_ties(self, ids: np.ndarray, k: int) -> np.ndarray:
        """Widen a device shortlist with each member's duplicate-group
        lowest ids (see :func:`_dup_groups_from_rows`). The kernel tie-breaks
        exact-score groups by permuted position; every group member scores
        bitwise identically, so whichever member survives the shortlist
        stands in for the group — the expansion swaps it for the group's
        ``k`` LOWEST original ids, and the exact host rerank's oracle
        tie-break then reproduces exact search even when the tie group is
        hundreds of members wide (measured 417 at 1M trained distractors)."""
        if self._dup_cache is False:
            self._dup_cache = (
                _dup_groups_from_rows(self._exact_rows)
                if self._exact_rows is not None
                else None
            )
        dg = self._dup_cache
        if dg is None:
            return ids
        member_ids, member_group, offs, gids = dg
        qn, kr = ids.shape
        pos = np.searchsorted(member_ids, ids)
        posc = np.clip(pos, 0, max(len(member_ids) - 1, 0))
        hit = member_ids[posc] == ids
        if not hit.any():
            return ids
        rows, width = [], kr
        for r in range(qn):
            row = ids[r]
            groups = np.unique(member_group[posc[r][hit[r]]])
            if groups.size:
                extra = [gids[offs[g] : offs[g] + min(offs[g + 1] - offs[g], k)] for g in groups]
                row = np.unique(np.concatenate([row.astype(np.int64), *extra]))
            rows.append(row)
            width = max(width, len(row))
        out = np.full((qn, width), _INT_MAX, np.int64)
        for r, row in enumerate(rows):
            out[r, : len(row)] = row
        return out

    def search_texts(
        self,
        queries: Sequence[str],
        top_k: int = 3,
        nprobe: Optional[int] = None,
        method: str = "ivf",  # accepted for search-surface interchangeability
        query_expansion: bool = True,
    ):
        queries = list(queries)
        if query_expansion and getattr(self.embedder, "backend", "hashed") == "hashed":
            from ..models.synonyms import expand_queries

            queries = expand_queries(queries)
        if self.embedder is not None:
            q = self.embedder.encode_texts(queries)
        elif self.featurizer is not None and self.encoder is not None:
            ids, wts = self.featurizer.encode_batch(queries)
            q = self.encoder.encode(ids, wts)
        else:
            raise ValueError("no embedder attached; use search_embeddings")
        scores, ids = self.search_embeddings(q, top_k=top_k, nprobe=nprobe)
        scores, ids = _host(scores), _host(ids)
        out = []
        for row_s, row_i in zip(scores, ids):
            hits = []
            for rank, (s, i) in enumerate(zip(row_s, row_i)):
                if i == _INT_MAX or i < 0 or i >= len(self.records):
                    continue
                hits.append(SearchHit(float(s), self.records[int(i)], rank))
            out.append(hits)
        return out

    # --- introspection ----------------------------------------------------
    def get_by_ids(self, chunk_ids: Sequence[str]):
        return [self.records[self._by_id[c]] for c in chunk_ids if c in self._by_id]

    def __contains__(self, chunk_id: str) -> bool:
        return chunk_id in self._by_id

    def __len__(self) -> int:
        return self.n

    def stats(self) -> dict:
        return {
            "collection": self.name,
            "entities": self.n,
            "dim": self.dim,
            "index_type": "IVF_BALANCED",
            "metric": "COSINE",
            "n_cells": self.ivf.n_cells,
            "cell_size": self.ivf.cell,
            "nprobe": self.nprobe,
            "quantized": self.ivf.scales is not None,
            "exact_repair": self._exact_rows is not None,
        }

    # --- persistence -------------------------------------------------------
    def save(self, directory: str) -> None:
        """``ivf.npz`` + ``ivf.json`` in the JAX package's format, with the
        hashed embedder, featurizer and encoder states and a tuned
        projection table (``encoder_table.npy``; a stale one is removed)."""
        os.makedirs(directory, exist_ok=True)
        cells = self.ivf.cells.cpu()
        arrays = {
            "centroids": _host(self.ivf.centroids),
            "orig_ids": _host(self.ivf.orig_ids),
        }
        if self._exact_rows is not None:
            # f16 halves the disk cost; the repair product upcasts to f32.
            arrays["exact_rows_f16"] = np.asarray(self._exact_rows, np.float16)
        if cells.dtype == torch.int8:
            arrays["cells_i8"] = cells.numpy()
            arrays["scales"] = _host(self.ivf.scales)
        elif cells.dtype == torch.bfloat16:
            # bf16 round-trips as a uint16 bit view (npz has no bf16 dtype).
            arrays["cells_bf16"] = cells.view(torch.int16).numpy().view(np.uint16)
        else:
            arrays["cells_f32"] = cells.float().numpy()
        np.savez(os.path.join(directory, "ivf.npz"), **arrays)
        meta = {
            "name": self.name,
            "n_valid": self.ivf.n_valid,
            "nprobe": self.nprobe,
            "records": [r.model_dump() for r in self.records],
        }
        embedder = self.embedder
        if getattr(embedder, "backend", None) == "hashed":
            meta["hashed_embedder"] = embedder.state_dict()
        if self.featurizer is not None:
            meta["featurizer"] = self.featurizer.state_dict()
        if self.encoder is not None:
            meta["encoder"] = self.encoder.state_dict()
        # At most one distinct tuned table: the standalone encoder's or the
        # hashed embedder's.
        table_path = os.path.join(directory, "encoder_table.npy")
        tuned = [enc for enc in (self.encoder, getattr(embedder, "encoder", None))
                 if enc is not None and enc.tuned]
        if tuned:
            np.save(table_path, tuned[0].table.float().cpu().numpy())
        elif os.path.exists(table_path):
            # An earlier save of a tuned index must not leave its table behind.
            os.remove(table_path)
        with open(os.path.join(directory, "ivf.json"), "w") as f:
            # One C-encoded string: json.dump's streaming encoder is pure
            # Python, seconds per 100k records. The bytes are the same.
            f.write(json.dumps(meta, ensure_ascii=False))

    @classmethod
    def load(cls, directory: str, device: DeviceLike = None) -> "IVFVectorIndex":
        with open(os.path.join(directory, "ivf.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(directory, "ivf.npz")) as data:
            scales = None
            if "cells_i8" in data:
                cells, scales = data["cells_i8"], data["scales"]
            elif "cells_bf16" in data:
                cells = data["cells_bf16"]
            else:
                cells = data["cells_f32"]
            ivf = ivf_from_numpy(
                cells, scales, data["centroids"], data["orig_ids"],
                int(meta["n_valid"]), device=device,
            )
            rows = data["exact_rows_f16"] if "exact_rows_f16" in data else None
        records = [IndexedChunk(**r) for r in meta["records"]]
        out = cls(
            ivf, records, nprobe=int(meta["nprobe"]),
            name=meta.get("name", "fin_chunks_ivf"), exact_rows=rows,
        )
        # The table is attached only when the saved state says tuned: a
        # stale file must not override a seed-reconstructible encoder.
        tpath = os.path.join(directory, "encoder_table.npy")
        tuned = bool(
            meta.get("encoder", {}).get("tuned")
            or meta.get("hashed_embedder", {}).get("encoder", {}).get("tuned")
        )
        table = np.load(tpath) if tuned and os.path.exists(tpath) else None
        if "hashed_embedder" in meta:
            from ..models.embedder import HashedEmbedder

            out.embedder = HashedEmbedder.from_state_dict(
                meta["hashed_embedder"], encoder_table=table, device=out.device
            )
        if "featurizer" in meta:
            out.featurizer = HashedFeaturizer.from_state_dict(meta["featurizer"])
        if "encoder" in meta:
            out.encoder = BagEncoder.from_state_dict(meta["encoder"], table=table, device=out.device)
        return out
