"""Corpus-sharded exact top-k: one column partition per shard, one merge.

Counterpart of ``ragfin_tpu/parallel/sharded.py``. The corpus ``[D, N]`` is
split by columns over a 1-D mesh; each shard runs the exact top-k of
:mod:`ragfin_tpu_torch.ops.topk` over its partition (the fused CUDA kernels
on a card, their plain versions on the CPU), and the per-shard (score,
global id) candidates, ``k`` pairs a shard, are gathered on the mesh's
first device and merged by a final stable selection. With a process group
the merged candidates of each process are gathered across ranks and merged
once more.

The merge keeps the port's top-k contract: scores descending, the lowest
global id first on a tie (the shards are in id order and the selection is
stable, as ``lax.top_k`` over JAX's gathered candidates), empty slots
``(-inf, INT32_MAX)``. Global ids are formed in int64, so a shard's
sentinel never wraps into a valid id.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..data.models import IndexedChunk
from ..index.vector_index import SearchHit, _torch_dtype
from ..models.bag_encoder import l2_normalize
from ..models.synonyms import expand_queries
from ..ops import topk as topk_ops
from ..ops.quantize import quantize_corpus_t
from .mesh import Mesh, all_gather, gather_processes, make_mesh, on_device, process_span, shard


def _as_f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.from_numpy(np.array(x, np.float32))


def _global_ids(s: torch.Tensor, i: torch.Tensor, base: int, n_valid: int):
    """A shard's local ids as global ids; candidates past ``n_valid`` or
    already empty become ``(-inf, INT32_MAX)``."""
    gids = i.to(torch.int64) + base
    ok = (gids < n_valid) & (s > topk_ops.NEG_INF)
    return s.masked_fill(~ok, topk_ops.NEG_INF), gids.masked_fill(~ok, topk_ops.INT32_MAX)


def merge_topk(cand_s: torch.Tensor, cand_i: torch.Tensor, k: int):
    """Top ``k`` of [Q, C] candidates gathered in id order: a stable
    selection (the lowest id first on a tie; empty slots must already be
    ``(-inf, INT32_MAX)``)."""
    top_s, sel = topk_ops._select(cand_s, min(k, cand_s.shape[1]))
    return top_s, torch.gather(cand_i, 1, sel.long())


def sharded_cosine_topk(
    mesh: Mesh,
    axis: str,
    queries: torch.Tensor,
    corpus_t_sharded: Sequence[torch.Tensor],
    k: int,
    n_valid: int,
    method: str = "auto",
    precision: str = "exact",
    scales: Optional[Sequence[torch.Tensor]] = None,
):
    """Local exact top-k per shard + the candidate merge.

    ``corpus_t_sharded`` is this process's shards of the ``[D, N_padded]``
    corpus (:func:`~.mesh.shard` along dim 1), ``scales`` the matching
    shards of an int8 corpus's ``[1, N_padded]`` scales. Returns ``([Q, k]
    scores, [Q, k] int32 ids)`` on the mesh's first device."""
    devices = mesh.axis_devices(axis)
    parts = list(corpus_t_sharded)
    if len(parts) != len(devices):
        raise ValueError(f"{len(parts)} shards for the {len(devices)} devices of axis {axis!r}")
    shard_cols = parts[0].shape[1]
    if method == "auto":
        # ops.topk.cosine_topk's dispatch, per LOCAL shard size: the fused
        # kernel on a card for large partitions, the dense tier otherwise;
        # quantized shards always take the int8 kernel (or its plain
        # version on the CPU), as in JAX.
        big = parts[0].is_cuda and shard_cols >= topk_ops.FUSED_MIN_N
        method = ("fused" if big else "dense") if scales is None else "int8"
    if method == "int8" and scales is None:
        raise ValueError("method='int8' requires scales")
    if method not in ("int8", "fused", "blocked", "dense"):
        raise ValueError(f"unknown top-k method: {method}")
    rank, _ = process_span()
    local_k = min(k, shard_cols)
    cand_s, cand_i = [], []
    for j, (dev, ct) in enumerate(zip(devices, parts)):
        base = (rank * len(parts) + j) * shard_cols
        # Mask pad columns BEFORE the local k-select: zero pads score 0.0
        # and would displace valid negative-cosine candidates otherwise.
        lv = int(np.clip(n_valid - base, 0, shard_cols))
        q = queries.to(dev, torch.float32)
        with on_device(dev):
            if method == "int8":
                s, i = topk_ops.cosine_topk_fused_int8(q, ct, scales[j], local_k, n_valid=lv)
            elif method == "fused":
                s, i = topk_ops.cosine_topk_fused(q, ct, local_k, n_valid=lv, precision=precision)
            elif method == "blocked":
                s, i = topk_ops.cosine_topk_blocked(q, ct, local_k, n_valid=lv, precision=precision)
            else:
                s, i = topk_ops.cosine_topk_dense(q, ct, local_k, n_valid=lv, precision=precision)
            s, i = _global_ids(s, i, base, n_valid)
        cand_s.append(s)
        cand_i.append(i)
    top_s, top_i = merge_topk(all_gather(cand_s, devices[0], 1), all_gather(cand_i, devices[0], 1), k)
    if process_span()[1] > 1:
        top_s, top_i = merge_topk(gather_processes(top_s, 1), gather_processes(top_i, 1), k)
    return top_s, top_i.to(torch.int32)


class ShardedVectorIndex:
    """Drop-in DeviceVectorIndex with the corpus sharded across a mesh.

    Mirrors :class:`ragfin_tpu_torch.index.vector_index.DeviceVectorIndex`'s
    search API; metadata stays on the host, each column partition of the
    embedding matrix lives on its shard's device."""

    def __init__(
        self,
        embeddings,
        records: Sequence[IndexedChunk],
        mesh: Optional[Mesh] = None,
        axis: Optional[str] = None,
        pad_multiple: int = 128,
        dtype=torch.float32,
        normalize: bool = True,
    ):
        self.mesh = mesh if mesh is not None else make_mesh(("data",))
        self.axis = axis or self.mesh.axis_names[0]
        n_shards = self.mesh.shape[self.axis] * process_span()[1]
        emb = _as_f32(embeddings).to(self.mesh.axis_devices(self.axis)[0])
        if normalize and emb.numel():
            emb = l2_normalize(emb)
        self.n, self.dim = emb.shape
        chunk = pad_multiple * n_shards
        pad = -self.n % chunk if self.n else chunk
        if pad:
            emb = torch.nn.functional.pad(emb, (0, 0, 0, pad))
        dtype = _torch_dtype(dtype)
        self.quantized = dtype == torch.int8
        if self.quantized:
            # dtype int8 means QUANTIZE, as DeviceVectorIndex does: a raw cast
            # of unit-norm f32 would truncate every value to 0.
            c8, sc = quantize_corpus_t(emb.T)
            self.matrix_t = shard(self.mesh, self.axis, c8, 1)
            self.scales = shard(self.mesh, self.axis, sc, 1)
        else:
            self.matrix_t = shard(self.mesh, self.axis, emb.T.to(dtype), 1)
            self.scales = None
        self.records = list(records)
        self._by_id = {r.id: i for i, r in enumerate(self.records)}
        # Query-encoding backends; populated by from_dense() or assignable.
        self.embedder = None
        self.encoder = None
        self.featurizer = None

    @classmethod
    def from_dense(cls, index, mesh: Optional[Mesh] = None, **kwargs) -> "ShardedVectorIndex":
        """Re-shard an existing DeviceVectorIndex across a mesh (an int8
        index is dequantized, then quantized again per shard column)."""
        if getattr(index, "quantized", False):
            dense = (index.matrix_t.float() * index.scales)[:, : index.n].T
        else:
            dense = index.matrix_t[:, : index.n].T
        out = cls(dense, index.records, mesh=mesh, normalize=False, **kwargs)
        out.embedder = getattr(index, "embedder", None)
        out.encoder = getattr(index, "encoder", None)
        out.featurizer = getattr(index, "featurizer", None)
        return out

    def search_embeddings(self, query_embeddings, top_k: int = 3, method: str = "auto"):
        q = _as_f32(query_embeddings)
        k = min(top_k, max(self.n, 1))
        return sharded_cosine_topk(
            self.mesh, self.axis, q, self.matrix_t, k, n_valid=self.n,
            method=method, scales=self.scales,
        )

    def search_texts(self, queries, top_k: int = 3, method: str = "auto", query_expansion: bool = True):
        # Mirror DeviceVectorIndex.search_texts: prefer the semantic embedder
        # when the source index carried one (featurizer/encoder are None then).
        embedder = self.embedder
        queries = list(queries)
        if query_expansion and getattr(embedder, "backend", "hashed") == "hashed":
            queries = expand_queries(queries)
        if embedder is not None:
            q = embedder.encode_texts(queries)
        elif self.featurizer is not None and self.encoder is not None:
            ids, wts = self.featurizer.encode_batch(queries)
            q = self.encoder.encode(ids, wts)
        else:
            raise ValueError(
                "ShardedVectorIndex has no embedder or featurizer/encoder; "
                "construct via from_dense() or assign one before search_texts"
            )
        scores, rows = self.search_embeddings(q, top_k=top_k, method=method)
        scores, rows = scores.cpu().numpy(), rows.cpu().numpy()
        out = []
        for qi in range(len(queries)):
            hits = []
            for rank in range(scores.shape[1]):
                row = int(rows[qi, rank])
                if row < self.n and np.isfinite(scores[qi, rank]):
                    hits.append(SearchHit(float(scores[qi, rank]), self.records[row], rank))
            out.append(hits)
        return out

    def __len__(self) -> int:
        return self.n
