"""Device-resident packed vector index with exact cosine top-k search.

Counterpart of ``ragfin_tpu/index/vector_index.py:DeviceVectorIndex``: the
L2-normalised embedding matrix lives transposed, ``[D, N_padded]``, on the
device (f32 by default, bf16, or int8 with per-column scales); the metadata
records stay on the host. Unfiltered searches go through
:func:`ragfin_tpu_torch.ops.topk.cosine_topk` (the fused CUDA kernel at
65,536 columns and up) or, for int8, the fused int8 kernel plus an exact f32
re-score of its shortlist on the host. Filtered searches and tier groups
run the dense tiers with device-cached row masks.

``save``/``load`` use the JAX package's on-disk format (``index.json`` plus
``matrix.rgfi`` or ``matrix.npz``), so an index saved by either package loads
in the other.

Integrity-weighted retrieval (``consistency_weight > 0``) scales positive
similarities by each chunk's figure-consistency multiplier on the device,
before selection, through the dense tiers' ``score_mult``.

Not ported yet (they raise ``NotImplementedError``): the hashed-featurizer
paths (exact sparse re-rank, exact-bucket search, the refitting insert,
saving or loading an index that carries a featurizer, a bag encoder or the
``minilm`` backend; ROADMAP Queue A item 6).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..config.constants import DEFAULT_COLLECTION, EMBED_DIM
from ..data.models import IndexedChunk
from ..ops.topk import (
    cosine_topk,
    cosine_topk_dense,
    cosine_topk_dense_int8,
    cosine_topk_dense_multi,
    cosine_topk_dense_multi_int8,
    cosine_topk_fused_int8,
)
from ..ops.quantize import quantize_corpus_t
from ..utils.device import DeviceLike, resolve_device

_NOT_PORTED_HASHED = "hashed-featurizer paths are not ported yet (ROADMAP Queue A item 6)"


def _q_bucket(n: int) -> int:
    """Bucket a query count to {1, 8, 64, k*64} device batch shapes (one
    compiled program per shape in the JAX package; kept so both packages
    search the same padded batches)."""
    if n <= 1:
        return 1
    if n <= 8:
        return 8
    if n <= 64:
        return 64
    return -(-n // 64) * 64


def _pad_queries(q) -> np.ndarray:
    """Zero-pad [Q, D] query embeddings up to the Q bucket."""
    q = np.asarray(q, np.float32)
    b = _q_bucket(q.shape[0])
    if b == q.shape[0]:
        return q
    return np.concatenate([q, np.zeros((b - q.shape[0], q.shape[1]), np.float32)])


def _repair_width(k: int) -> int:
    """Device shortlist width for the int8 exact repair: max(k + 6, 16)."""
    return max(k + 6, 16)


def _oracle_truncate(exact, ids, k: int):
    """Top ``k`` of exact scores with the oracle tie-break (stable
    score-descending, lowest global id wins)."""
    by_id = np.argsort(ids, axis=1, kind="stable")
    ids_s = np.take_along_axis(ids, by_id, axis=1)
    ex_s = np.take_along_axis(exact, by_id, axis=1)
    order = np.argsort(-ex_s, axis=1, kind="stable")[:, :k]
    return (
        np.take_along_axis(ex_s, order, axis=1),
        np.take_along_axis(ids_s, order, axis=1),
    )


def _exact_rerank_host(q, ids, rows_f32, k: int):
    """Exact f32 re-score of an int8 shortlist against host corpus rows;
    sentinel ids (>= the row count) score -inf."""
    ids = np.asarray(ids)
    qn, kr = ids.shape
    q = np.asarray(q, np.float32)
    n_rows = rows_f32.shape[0]
    safe = np.clip(ids, 0, max(n_rows - 1, 0))
    cand = rows_f32[safe.reshape(-1)].reshape(qn, kr, -1)
    exact = np.einsum("qd,qkd->qk", q, cand)
    exact = np.where(ids < n_rows, exact, -np.inf)
    return _oracle_truncate(exact, ids, k)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("torch.", "").replace("jnp.", "")
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
    if name not in table:
        raise ValueError(f"unsupported index dtype: {dtype}")
    return table[name]


class SearchHit:
    """One search result row (Milvus hit parity: score + entity fields)."""

    __slots__ = ("score", "record", "rank", "conflict")

    def __init__(self, score: float, record: IndexedChunk, rank: int):
        self.score = score
        self.record = record
        self.rank = rank
        # Set by conflict detection (retrieval/conflict.py); None = not analyzed.
        self.conflict = None

    @property
    def id(self) -> str:
        return self.record.id

    def to_dict(self, include_text: bool = True) -> dict:
        out = {
            "id": self.record.id,
            "score": self.score,
            "period": self.record.period,
            "chunk_type": self.record.chunk_type,
            "statement_type": self.record.statement_type,
            "primary_value": self.record.primary_value,
        }
        if include_text:
            out["text"] = self.record.text
        if self.conflict is not None:
            out["conflict"] = self.conflict
        return out


class DeviceVectorIndex:
    """Packed [D, N] unit-norm embedding matrix on the device + host records."""

    # Accepts metadata-filter kwargs in search_texts (FilteredSearch needs it).
    supports_filters = True

    @property
    def dtype(self) -> torch.dtype:
        return self.matrix_t.dtype

    def __init__(
        self,
        embeddings,
        records: Sequence[IndexedChunk],
        name: str = DEFAULT_COLLECTION,
        pad_multiple: int = 2048,
        dtype="float32",
        normalize: bool = True,
        int8_shadow: bool = True,
        host_quantize: Optional[bool] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        tdtype = _torch_dtype(dtype)
        self.quantized = tdtype == torch.int8
        # Large int8 builds quantize on the host and move only the int8
        # matrix + scales (the device path would stage the full f32 matrix).
        if host_quantize is None:
            host_quantize = (
                self.quantized
                and isinstance(embeddings, np.ndarray)
                and embeddings.nbytes > (4 << 30)
            )
        if host_quantize and self.quantized and isinstance(embeddings, np.ndarray):
            self._init_host_quantized(embeddings, records, pad_multiple, normalize, int8_shadow)
        else:
            self._init_device(embeddings, records, pad_multiple, normalize, int8_shadow, tdtype)
        self.records: list[IndexedChunk] = list(records)
        self._by_id = {r.id: i for i, r in enumerate(self.records)}
        self.name = name
        # Query encoder; set by build() or assigned.
        self.embedder = None

    def _init_device(self, embeddings, records, pad_multiple, normalize, int8_shadow, tdtype):
        if not isinstance(embeddings, torch.Tensor):
            embeddings = torch.from_numpy(np.asarray(embeddings, np.float32))
        emb = embeddings.to(self.device, torch.float32)
        if emb.dim() != 2:
            raise ValueError("embeddings must be [N, D]")
        if emb.shape[0] != len(records):
            raise ValueError("embeddings/records length mismatch")
        if normalize:
            norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
            emb = emb / torch.clamp(norm, min=1e-12)
        self.n, self.dim = emb.shape
        pad = -self.n % pad_multiple if self.n else pad_multiple
        if pad:
            emb = torch.nn.functional.pad(emb, (0, 0, 0, pad))
        if self.quantized:
            q, scales = quantize_corpus_t(emb.T)
            self.matrix_t, self.scales = q.contiguous(), scales.contiguous()
            # Exact f32 rows on the host for the int8 shortlist repair.
            self._exact_rows = emb[: self.n].cpu().numpy() if int8_shadow else None
        else:
            self.matrix_t = emb.T.contiguous().to(tdtype)
            self.scales = None
            self._exact_rows = None

    def _init_host_quantized(self, embeddings, records, pad_multiple, normalize, int8_shadow):
        """Host normalize + pad + int8 quantize in numpy (f32 throughout,
        half-to-even rounding), then one transfer of the int8 matrix."""
        if embeddings.ndim != 2:
            raise ValueError("embeddings must be [N, D]")
        if embeddings.shape[0] != len(records):
            raise ValueError("embeddings/records length mismatch")
        x = np.asarray(embeddings, np.float32)
        if normalize:
            nrm = np.sqrt(np.einsum("nd,nd->n", x, x, dtype=np.float32))
            x = x / np.maximum(nrm, np.float32(1e-12))[:, None]
        self.n, self.dim = x.shape
        pad = -self.n % pad_multiple if self.n else pad_multiple
        if pad:
            x = np.pad(x, ((0, pad), (0, 0)))
        absmax = np.max(np.abs(x), axis=1) if x.size else np.zeros(x.shape[0], np.float32)
        scale = np.maximum(absmax, np.float32(1e-12)) / np.float32(127.0)
        q = np.clip(np.rint(x / scale[:, None]), -127, 127).astype(np.int8)
        self.matrix_t = torch.from_numpy(np.ascontiguousarray(q.T)).to(self.device)
        self.scales = torch.from_numpy(scale.reshape(1, -1).astype(np.float32)).to(self.device)
        self._exact_rows = x[: self.n] if int8_shadow else None

    # --- build -----------------------------------------------------------
    @classmethod
    def build(
        cls,
        chunks: Sequence[IndexedChunk],
        embedder=None,
        batch_size: int = 1024,
        **kwargs,
    ) -> "DeviceVectorIndex":
        """Embed chunk texts with ``embedder`` and pack the matrix."""
        if embedder is None:
            raise NotImplementedError(_NOT_PORTED_HASHED + ": pass a TrainedEmbedder")
        texts = [c.text for c in chunks]
        embedder.fit(texts)
        embs = [
            embedder.encode_texts(texts[start : start + batch_size])
            for start in range(0, len(texts), batch_size)
        ]
        matrix = np.concatenate(embs, axis=0) if embs else np.zeros((0, EMBED_DIM), np.float32)
        index = cls(matrix, chunks, **kwargs)
        index.embedder = embedder
        return index

    # --- search ----------------------------------------------------------
    def _queries_tensor(self, q) -> torch.Tensor:
        return torch.as_tensor(np.asarray(q, np.float32)).to(self.device)

    def search_embeddings(self, query_embeddings, top_k: int = 3, method: str = "auto"):
        """Raw device search: [Q, D] unit queries -> (scores, row ids)."""
        k = min(top_k, max(self.n, 1))
        q = (
            query_embeddings.to(self.device, torch.float32)
            if isinstance(query_embeddings, torch.Tensor)
            else self._queries_tensor(query_embeddings)
        )
        if self.quantized:
            if self._exact_rows is None or self.n == 0:
                return cosine_topk_fused_int8(q, self.matrix_t, self.scales, k, n_valid=self.n)
            # int8 scan for the shortlist, exact host f32 re-score for the order.
            kr = min(_repair_width(k), max(self.n, 1))
            _, ids = cosine_topk_fused_int8(q, self.matrix_t, self.scales, kr, n_valid=self.n)
            return _exact_rerank_host(_host(q), _host(ids), self._exact_rows, k)
        return cosine_topk(q, self.matrix_t, k, n_valid=self.n, method=method)

    def _meta_arrays(self):
        """Vectorized metadata columns (cached): (int32 codes, vocab) each."""
        cached = getattr(self, "_meta", None)
        if cached is None or cached[0] != len(self.records):
            def encode(values):
                vocab: dict = {}
                codes = np.empty(len(values), np.int32)
                for i, v in enumerate(values):
                    c = vocab.get(v)
                    if c is None:
                        c = vocab[v] = len(vocab)
                    codes[i] = c
                return codes, vocab

            periods = encode([r.period for r in self.records])
            ctypes = encode([r.chunk_type for r in self.records])
            companies = encode([getattr(r, "company", "ICICI Bank") for r in self.records])
            cached = (len(self.records), periods, ctypes, companies)
            self._meta = cached
        return cached[1], cached[2], cached[3]

    def _filter_mask(
        self,
        period: Optional[str] = None,
        chunk_type: Optional[str] = None,
        predicate=None,
        periods: Optional[Sequence[str]] = None,
        company: Optional[str] = None,
    ) -> Optional[np.ndarray]:
        """Metadata filter -> host row mask over the padded width; all
        conditions AND together. Stable filters are cached."""
        if (
            period is None and chunk_type is None and predicate is None
            and not periods and company is None
        ):
            return None
        want = list(periods) if periods else ([period] if period else None)
        cache_key = None
        if predicate is None:
            cache_key = (
                tuple(sorted(want)) if want else None, chunk_type, company,
                len(self.records),
            )
            cache = getattr(self, "_host_mask_cache", None)
            if cache is None:
                cache = self._host_mask_cache = {}
            hit = cache.get(cache_key)
            if hit is not None:
                return hit
        n_pad = int(self.matrix_t.shape[1])
        (pcodes, pvocab), (ccodes, cvocab), (ocodes, ovocab) = self._meta_arrays()
        mask = np.ones((len(self.records),), bool)
        if want is not None:
            codes = [pvocab[p] for p in want if p in pvocab]
            if len(codes) == 1:
                mask &= pcodes == codes[0]
            else:
                mask &= np.isin(pcodes, np.asarray(codes, np.int32))
        if chunk_type is not None:
            code = cvocab.get(chunk_type)
            mask &= (ccodes == code) if code is not None else False
        if company is not None:
            code = ovocab.get(company)
            mask &= (ocodes == code) if code is not None else False
        if predicate is not None:
            for i in np.nonzero(mask)[0]:
                if not predicate(self.records[int(i)]):
                    mask[i] = False
        out = np.zeros((n_pad,), bool)
        out[: len(self.records)] = mask
        if cache_key is not None:
            if len(self._host_mask_cache) > 64:
                self._host_mask_cache.clear()
            self._host_mask_cache[cache_key] = out
        return out

    def integrity_column(self) -> np.ndarray:
        """Per-chunk figure-consistency multipliers (weight 1: passed /
        checks, 1.0 where nothing is checkable), padded to the matrix width
        with ones. Computed once per corpus on the host (the engine's warmup
        does it), again only if the width changes."""
        cached = getattr(self, "_integrity_col", None)
        width = self.matrix_t.shape[1]
        if cached is None or len(cached) != width:
            from ..retrieval.consistency import consistency_checks

            vals = np.ones(width, np.float32)
            for i, r in enumerate(self.records):
                p, c = consistency_checks(r.text)
                if c:
                    vals[i] = p / c
            self._integrity_col = vals
            cached = vals
        return cached

    def search_texts(
        self,
        queries: Sequence[str],
        top_k: int = 3,
        method: str = "auto",
        period: Optional[str] = None,
        chunk_type: Optional[str] = None,
        predicate=None,
        periods: Optional[Sequence[str]] = None,
        company: Optional[str] = None,
        rerank: int = 0,
        consistency_weight: float = 0.0,
        consistency_strict: bool = True,
    ) -> list[list[SearchHit]]:
        """Encode query texts and search, optionally metadata-filtered
        (Milvus filter expressions). ``rerank=R`` widens the device fetch to
        R; the exact sparse re-rank it feeds exists only for the hashed
        backend (not ported), so here the shortlist is cut back to
        ``top_k``. Filtered searches on an int8 index fetch
        ``max(k + 6, 16)`` and repair the order exactly on the host.
        ``consistency_weight > 0`` scales positive similarities by the
        integrity multiplier before selection: strict (any failed check
        costs the whole weight) or smooth (by the fraction failed)."""
        queries = list(queries)
        fetch_k = max(top_k, rerank)
        mask = self._filter_mask(period, chunk_type, predicate, periods=periods, company=company)
        q = _pad_queries(self._encode_queries(queries))
        score_mult = (
            self._integrity_mult(consistency_weight, consistency_strict)
            if consistency_weight > 0
            else None
        )
        if mask is not None or score_mult is not None:
            row_mask = None
            if mask is not None:
                if predicate is None:
                    mkey = (tuple(sorted(periods)) if periods else period, chunk_type, company)
                    row_mask = self._device_row_mask(mkey, mask)
                else:
                    row_mask = torch.from_numpy(mask).to(self.device)
            qt = self._queries_tensor(q)
            if self.quantized:
                repair = self._repairable(consistency_weight)
                dev_k = min(_repair_width(fetch_k) if repair else fetch_k, max(self.n, 1))
                scores, rows = cosine_topk_dense_int8(
                    qt, self.matrix_t, self.scales, dev_k,
                    n_valid=self.n, row_mask=row_mask, score_mult=score_mult,
                )
                if repair:
                    scores, rows = self._exact_repair(q, scores, rows, min(fetch_k, dev_k))
            else:
                scores, rows = cosine_topk_dense(
                    qt, self.matrix_t, min(fetch_k, max(self.n, 1)),
                    n_valid=self.n, row_mask=row_mask, score_mult=score_mult,
                )
        else:
            scores, rows = self.search_embeddings(q, top_k=fetch_k, method=method)
        return self._postprocess_device_hits(queries, scores, rows, top_k)

    def _exact_repair(self, q, scores, rows, keep: int):
        """Exact host re-score of a FILTERED int8 device shortlist; only
        entries the device scored finite are re-scored (a masked-out row
        must never re-enter on its raw cosine)."""
        scores = _host(scores)
        rows = _host(rows)
        q = np.asarray(q, np.float32)[: rows.shape[0]]
        safe = np.clip(rows, 0, max(self.n - 1, 0))
        cand = self._exact_rows[safe.reshape(-1)].reshape(rows.shape + (self.dim,))
        exact = np.einsum("qd,qkd->qk", q, cand)
        valid = np.isfinite(scores) & (rows < self.n)
        exact = np.where(valid, exact, -np.inf)
        return _oracle_truncate(exact, rows, keep)

    def _repairable(self, consistency_weight: float) -> bool:
        """Whether the filtered int8 paths widen the fetch and repair on the
        host (not in integrity mode, not on an empty index)."""
        return (
            self.quantized
            and self.n > 0
            and self._exact_rows is not None
            and self._exact_rows.size > 0
            and consistency_weight <= 0
        )

    def _postprocess_device_hits(self, queries, scores, rows, top_k):
        """Device shortlist -> SearchHit lists: drop sentinel and -inf slots,
        keep ``top_k``."""
        scores = _host(scores)
        rows = _host(rows)
        out = []
        for qi in range(len(queries)):
            hits = []
            for rank in range(scores.shape[1]):
                row = int(rows[qi, rank])
                if row >= self.n or not np.isfinite(scores[qi, rank]):
                    continue
                hits.append(SearchHit(float(scores[qi, rank]), self.records[row], rank))
            out.append(hits[:top_k])
        return out

    def _encode_queries(self, queries):
        embedder = getattr(self, "embedder", None)
        if embedder is None:
            raise ValueError(
                "no embedder attached to this index; use search_embeddings "
                "or construct via DeviceVectorIndex.build"
            )
        return embedder.encode_texts(queries)

    def _integrity_mult(self, consistency_weight: float, consistency_strict: bool) -> torch.Tensor:
        """The [N] multiplier column on the index's device, cached per
        (weight, strict, width), so no search uploads it again."""
        cache = getattr(self, "_integrity_mult_cache", None)
        if cache is None:
            cache = self._integrity_mult_cache = {}
        key = (round(consistency_weight, 6), consistency_strict, self.matrix_t.shape[1])
        hit = cache.get(key)
        if hit is not None:
            return hit
        from ..retrieval.consistency import smooth, strictify

        col = self.integrity_column()
        scale = strictify if consistency_strict else smooth
        mult = torch.from_numpy(scale(col, consistency_weight).astype(np.float32)).to(self.device)
        cache[key] = mult
        return mult

    def _device_cached_mask(self, key, build) -> torch.Tensor:
        """Get-or-upload a device mask under ``key`` (bounded cache): filter
        vocabularies are small, so each mask crosses to the device once."""
        cache = getattr(self, "_device_mask_cache", None)
        if cache is None:
            cache = self._device_mask_cache = {}
        full_key = (*key, self.matrix_t.shape[1])
        hit = cache.get(full_key)
        if hit is not None:
            return hit
        dev = build()
        if len(cache) > 32:
            cache.clear()
        cache[full_key] = dev
        return dev

    def _device_tier_masks(self, group_key, device_tiers) -> torch.Tensor:
        """Device-resident [G, N] tier-mask stack, cached per tier-group key."""
        return self._device_cached_mask(
            ("group", group_key),
            lambda: torch.from_numpy(np.stack([m for _, m in device_tiers])).to(self.device),
        )

    def _device_row_mask(self, key, mask: np.ndarray) -> torch.Tensor:
        """Single [N] device row mask, cached per filter key."""
        return self._device_cached_mask(
            ("single", key), lambda: torch.from_numpy(mask).to(self.device)
        )

    def search_texts_tiers(
        self,
        queries: Sequence[str],
        tier_filters: Sequence[dict],
        top_k: int = 3,
        method: str = "auto",
        rerank: int = 0,
        consistency_weight: float = 0.0,
        consistency_strict: bool = True,
    ) -> list[list[list[SearchHit]]]:
        """All filter tiers of a query group from one [Q, N] score matrix;
        equivalent to ``[search_texts(queries, **f) for f in tier_filters]``."""
        if any(f.get("predicate") is not None for f in tier_filters):
            return [
                self.search_texts(
                    queries, top_k=top_k, method=method, rerank=rerank,
                    consistency_weight=consistency_weight,
                    consistency_strict=consistency_strict, **f,
                )
                for f in tier_filters
            ]
        queries = list(queries)
        width = self.matrix_t.shape[1]
        device_tiers: list[tuple[int, np.ndarray]] = []
        tier_keys: list = []
        for ti, flt in enumerate(tier_filters):
            mask = self._filter_mask(
                flt.get("period"), flt.get("chunk_type"), None,
                periods=flt.get("periods"), company=flt.get("company"),
            )
            if mask is None:
                mask = np.ones(width, bool)
            device_tiers.append((ti, mask))
            periods_f = flt.get("periods")
            tier_keys.append((
                tuple(sorted(periods_f)) if periods_f else flt.get("period"),
                flt.get("chunk_type"), flt.get("company"),
            ))
        if not device_tiers:
            return []
        q = _pad_queries(self._encode_queries(queries))
        qt = self._queries_tensor(q)
        score_mult = (
            self._integrity_mult(consistency_weight, consistency_strict)
            if consistency_weight > 0
            else None
        )
        fetch_k = min(max(top_k, rerank), max(self.n, 1))
        masks = self._device_tier_masks(tuple(tier_keys), device_tiers)
        if self.quantized:
            repair = self._repairable(consistency_weight)
            dev_k = min(_repair_width(fetch_k) if repair else fetch_k, max(self.n, 1))
            s_all, r_all = cosine_topk_dense_multi_int8(
                qt, self.matrix_t, self.scales, dev_k, masks,
                n_valid=self.n, score_mult=score_mult,
            )
            if repair:
                keep = min(fetch_k, dev_k)
                pairs = [
                    self._exact_repair(q, s_all[gi], r_all[gi], keep)
                    for gi in range(len(device_tiers))
                ]
                s_all = np.stack([p[0] for p in pairs])
                r_all = np.stack([p[1] for p in pairs])
        else:
            s_all, r_all = cosine_topk_dense_multi(
                qt, self.matrix_t, fetch_k, masks, n_valid=self.n, score_mult=score_mult,
            )
        s_all = _host(s_all)
        r_all = _host(r_all)
        return [
            self._postprocess_device_hits(queries, s_all[gi], r_all[gi], top_k)
            for gi in range(len(device_tiers))
        ]

    # --- incremental insert (Milvus `collection.insert` parity) -----------
    def _dense_rows(self) -> np.ndarray:
        """The [n, D] f32 rows this index stands for. An int8 index gives
        its pre-quantization shadow rows: the dequantized matrix would bake
        one int8 rounding into whatever is rebuilt from them."""
        if self.quantized and self._exact_rows is not None:
            return np.asarray(self._exact_rows, np.float32)
        if self.quantized:
            dense = self.matrix_t.to(torch.float32) * self.scales
        else:
            dense = self.matrix_t.to(torch.float32)
        return np.ascontiguousarray(dense[:, : self.n].T.cpu().numpy())

    def extended_with(
        self, new_chunks: Sequence[IndexedChunk], refit: bool = True
    ) -> "DeviceVectorIndex":
        """New index with ``new_chunks`` appended under the frozen embedder
        (the trained encoder depends on no corpus statistics, so ``refit``
        changes nothing for it). A corpus-dependent hashed embedder, which
        ``refit=True`` would refit, is not ported."""
        embedder = getattr(self, "embedder", None)
        if embedder is None:
            raise ValueError("index has no embedder; rebuild instead")
        if refit and getattr(embedder, "featurizer", None) is not None:
            raise NotImplementedError("the refitting insert: " + _NOT_PORTED_HASHED)
        all_records = list(self.records) + list(new_chunks)
        new = embedder.encode_texts([c.text for c in new_chunks])
        out = DeviceVectorIndex(
            np.concatenate([self._dense_rows(), new], axis=0),
            all_records,
            name=self.name,
            dtype="int8" if self.quantized else self.matrix_t.dtype,
            normalize=False,
            device=self.device,
        )
        out.embedder = embedder
        return out

    # --- persistence ------------------------------------------------------
    def save(self, directory: str) -> None:
        """Write ``index.json`` and the f32 matrix (the shadow rows for an
        int8 index) in the JAX package's format."""
        embedder = getattr(self, "embedder", None)
        backend = getattr(embedder, "backend", "hashed") if embedder is not None else None
        if (
            backend in ("hashed", "minilm")
            or getattr(self, "featurizer", None) is not None
            or getattr(self, "encoder", None) is not None
        ):
            raise NotImplementedError("saving this index: " + _NOT_PORTED_HASHED)
        from ..utils import indexio

        os.makedirs(directory, exist_ok=True)
        dense = self._dense_rows()
        if indexio.available():
            # Native RGFI format: uncompressed + CRC32, the fast path for
            # multi-GB matrices where npz compression takes minutes.
            indexio.write_array(os.path.join(directory, "matrix.rgfi"), dense)
        else:
            np.savez_compressed(os.path.join(directory, "matrix.npz"), matrix=dense)
        meta = {
            "name": self.name,
            "n": self.n,
            "dim": self.dim,
            # The matrix is persisted as f32; the serving dtype is recorded
            # so that load() rebuilds the same tier.
            "dtype": "int8" if self.quantized else str(self.matrix_t.dtype).replace("torch.", ""),
            "records": [r.model_dump() for r in self.records],
        }
        if embedder is not None:
            meta["embedder"] = embedder.state_dict()
        with open(os.path.join(directory, "index.json"), "w") as f:
            json.dump(meta, f, ensure_ascii=False)

    @classmethod
    def load(cls, directory: str, device: DeviceLike = None, **kwargs) -> "DeviceVectorIndex":
        with open(os.path.join(directory, "index.json")) as f:
            meta = json.load(f)
        backend = meta.get("embedder", {}).get("backend")
        if "featurizer" in meta or "encoder" in meta or backend == "minilm":
            # Never load an index without the embedder its matrix was built by.
            raise NotImplementedError("loading this index: " + _NOT_PORTED_HASHED)
        rgfi = os.path.join(directory, "matrix.rgfi")
        if os.path.exists(rgfi) or os.path.exists(rgfi + ".npy"):
            from ..utils import indexio

            matrix = indexio.read_array(rgfi)
        else:
            with np.load(os.path.join(directory, "matrix.npz")) as data:
                matrix = data["matrix"]
        records = [IndexedChunk(**r) for r in meta["records"]]
        if "dtype" not in kwargs and "dtype" in meta:
            kwargs["dtype"] = meta["dtype"]
        index = cls(
            matrix, records, name=meta.get("name", DEFAULT_COLLECTION), device=device, **kwargs
        )
        if backend == "trained":
            from ..models.embedder import TrainedEmbedder

            ckpt = meta["embedder"].get("checkpoint")
            if ckpt and not os.path.exists(os.path.join(ckpt, "config.json")):
                ckpt = None  # saved under a moved/renamed tree: packaged default
            index.embedder = TrainedEmbedder(checkpoint=ckpt, device=index.device)
        return index

    # --- point lookups (Milvus `query(expr="id in [...]")` parity) -------
    def get_by_ids(self, chunk_ids: Sequence[str]) -> list[IndexedChunk]:
        return [self.records[self._by_id[c]] for c in chunk_ids if c in self._by_id]

    def __contains__(self, chunk_id: str) -> bool:
        return chunk_id in self._by_id

    def __len__(self) -> int:
        return self.n

    def stats(self) -> dict:
        """Collection stats (vector_rag_mcp/main.py:157-169 parity)."""
        return {
            "collection": self.name,
            "num_entities": self.n,
            "dim": self.dim,
            "padded_rows": int(self.matrix_t.shape[1]),
            "dtype": str(self.matrix_t.dtype).replace("torch.", ""),
            "periods": sorted({r.period for r in self.records}),
            "chunk_types": sorted({r.chunk_type for r in self.records}),
            "index_type": "FLAT_EXACT",
            "metric_type": "COSINE",
            "device": str(self.device),
        }
