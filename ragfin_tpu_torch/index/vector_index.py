"""Device-resident packed vector index with exact cosine top-k search.

Counterpart of ``ragfin_tpu/index/vector_index.py:DeviceVectorIndex``: the
L2-normalised embedding matrix lives transposed, ``[D, N_padded]``, on the
device (f32 by default, bf16, or int8 with per-column scales); the metadata
records stay on the host. Unfiltered searches go through
:func:`ragfin_tpu_torch.ops.topk.cosine_topk` (the fused CUDA kernel at
65,536 columns and up) or, for int8, the fused int8 kernel plus an exact f32
re-score of its shortlist on the host. Filtered searches and tier groups
run the dense tiers: on the columns of their scope alone, gathered, where
the scope holds few rows, else over every column with device-cached row
masks.

``save``/``load`` use the JAX package's on-disk format (``index.json`` plus
``matrix.rgfi`` or ``matrix.npz``), so an index saved by either package loads
in the other.

Integrity-weighted retrieval (``consistency_weight > 0``) scales positive
similarities by each chunk's figure-consistency multiplier on the device,
before selection, through the dense tiers' ``score_mult``.

The hashed backend (the default of :meth:`DeviceVectorIndex.build`) adds
host paths that are the JAX package's, line for line: query-side synonym
expansion, the exact sparse TF-IDF re-rank of a ``rerank`` shortlist, then
the consistency re-rank; the exact-bucket search of a small scoped bucket in
integrity mode (no device work); the refitting insert; and persistence of
the featurizer, the encoder and a tuned ``encoder_table.npy``.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..config.constants import DEFAULT_COLLECTION, EMBED_DIM
from ..data.models import IndexedChunk
from ..models.bag_encoder import BagEncoder
from ..models.featurizer import HashedFeaturizer
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
from ..utils.profiling import METRICS

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


def _filter_key(period, periods, chunk_type, company) -> tuple:
    """A stable filter's cache key, as the masks and buckets are cached."""
    return (tuple(sorted(periods)) if periods else period, chunk_type, company)


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
        # Query-encoding backends; set by build()/load() or assigned.
        self.embedder = None
        self.featurizer = None
        self.encoder = None

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
        encoder: Optional[BagEncoder] = None,
        featurizer: Optional[HashedFeaturizer] = None,
        embedder=None,
        batch_size: int = 1024,
        **kwargs,
    ) -> "DeviceVectorIndex":
        """Embed chunk texts and pack the matrix. ``embedder`` selects the
        backend; without one the hashed backend is built from the
        ``encoder``/``featurizer`` pair (each made with its defaults when not
        given). A featurizer that has not been fitted is fitted on the
        chunks."""
        from ..models.embedder import HashedEmbedder

        texts = [c.text for c in chunks]
        if embedder is None:
            encoder = encoder or BagEncoder(device=kwargs.get("device"))
            featurizer = featurizer or HashedFeaturizer(vocab_size=encoder.vocab_size)
            embedder = HashedEmbedder(featurizer=featurizer, encoder=encoder)
        if not getattr(getattr(embedder, "featurizer", None), "n_docs", 0):
            embedder.fit(texts)
        embs = [
            embedder.encode_texts(texts[start : start + batch_size])
            for start in range(0, len(texts), batch_size)
        ]
        matrix = np.concatenate(embs, axis=0) if embs else np.zeros((0, EMBED_DIM), np.float32)
        index = cls(matrix, chunks, **kwargs)
        index._attach(embedder)
        return index

    def _attach(self, embedder) -> None:
        self.embedder = embedder
        self.encoder = getattr(embedder, "encoder", None)
        self.featurizer = getattr(embedder, "featurizer", None)

    # --- search ----------------------------------------------------------
    @METRICS.spanned("index.upload")
    def _queries_tensor(self, q) -> torch.Tensor:
        METRICS.count("index.query_upload")
        return torch.as_tensor(np.asarray(q, np.float32)).to(self.device)

    @METRICS.spanned("index.search", nested=False)
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
                with METRICS.span("index.topk"):
                    return cosine_topk_fused_int8(q, self.matrix_t, self.scales, k, n_valid=self.n)
            # int8 scan for the shortlist, exact host f32 re-score for the order.
            kr = min(_repair_width(k), max(self.n, 1))
            with METRICS.span("index.topk"):
                _, ids = cosine_topk_fused_int8(q, self.matrix_t, self.scales, kr, n_valid=self.n)
            with METRICS.span("index.readback"):
                q, ids = _host(q), _host(ids)
            with METRICS.span("index.repair"):
                return _exact_rerank_host(q, ids, self._exact_rows, k)
        with METRICS.span("index.topk"):
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

    @METRICS.spanned("index.mask")
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
            METRICS.count("index.mask_build")
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

    # Largest share of the padded width a masked search's scope may hold
    # and still be scored on its own columns, gathered, instead of masking
    # the product over every column (PERF.md §6: the card's crossover).
    scope_gather_max_share = 1 / 16

    # Largest filtered candidate set served by the exact-sparse host path;
    # bigger buckets go through the device projection as usual.
    exact_bucket_max = 65536

    def _bucket_postings(self, rows: np.ndarray, key):
        """Inverted postings over one filter bucket's exact TF-IDF vectors
        (cached per filter key: buckets repeat across queries and tiers)."""
        cache = getattr(self, "_bucket_cache", None)
        if cache is None:
            cache = self._bucket_cache = {}
        entry = cache.get(key)
        if entry is not None:
            return entry
        texts = [self.records[int(r)].text for r in rows]
        ids, wts = self.featurizer.encode_batch(texts)
        norms = np.linalg.norm(wts, axis=1, keepdims=True)
        wts = (wts / np.maximum(norms, 1e-12)).astype(np.float32)
        doc_idx = np.repeat(np.arange(len(rows), dtype=np.int32), ids.shape[1])
        flat_ids = ids.ravel()
        flat_w = wts.ravel()
        nz = flat_w != 0
        flat_ids, flat_w, doc_idx = flat_ids[nz], flat_w[nz], doc_idx[nz]
        order = np.argsort(flat_ids, kind="stable")
        flat_ids, flat_w, doc_idx = flat_ids[order], flat_w[order], doc_idx[order]
        uniq, starts = np.unique(flat_ids, return_index=True)
        bounds = np.append(starts, flat_ids.size)
        lookup = {int(f): (int(s), int(e)) for f, s, e in zip(uniq, bounds[:-1], bounds[1:])}
        entry = (rows, lookup, flat_w, doc_idx)
        if len(cache) > 64:  # bound memory across many distinct plans
            cache.clear()
        cache[key] = entry
        return entry

    @METRICS.spanned("index.hits")
    def _exact_bucket_search(
        self, queries, rows, key, top_k, consistency_weight, consistency_strict
    ):
        """Exact sparse TF-IDF cosine over a (small) filtered bucket, on the
        host. Inside a scoped bucket of near-duplicates the projection's
        noise (~1/sqrt(384)) exceeds the true score gaps, so a device
        shortlist of any practical width can miss the gold document; the
        bucket scored in the true TF-IDF space is exact and cheap. Integrity
        gating applies multiplicatively as on the device path."""
        from ..retrieval.consistency import smooth, strictify

        rows_arr, lookup, flat_w, doc_idx = self._bucket_postings(rows, key)
        mult = None
        if consistency_weight > 0:
            col = self.integrity_column()[rows_arr]
            scale = strictify if consistency_strict else smooth
            mult = scale(col, consistency_weight).astype(np.float32)
        qids, qwts = self.featurizer.encode_batch(list(queries))
        qnorm = np.linalg.norm(qwts, axis=1, keepdims=True)
        qwts = qwts / np.maximum(qnorm, 1e-12)
        out = []
        for qi in range(len(queries)):
            scores = np.zeros(len(rows_arr), np.float32)
            for fid, w in zip(qids[qi], qwts[qi]):
                if not w:
                    continue
                se = lookup.get(int(fid))
                if se is None:
                    continue
                s, e = se
                np.add.at(scores, doc_idx[s:e], flat_w[s:e] * np.float32(w))
            if mult is not None:
                scores = np.where(scores > 0, scores * mult, scores)
            k = min(top_k, scores.size)
            # A full (score desc, row asc) sort, not argpartition: among
            # exact ties (near-duplicates with identical retrieval features)
            # a partition picks an arbitrary k and can drop the lowest row.
            order = np.lexsort((rows_arr, -scores))[:k]
            out.append([
                SearchHit(float(scores[li]), self.records[int(rows_arr[li])], rank)
                for rank, li in enumerate(order)
            ])
        return out

    def _sparse_rerank(self, query: str, hits: list, top_k: int) -> list:
        """Exact sparse TF-IDF cosine re-rank of a device shortlist (hashed
        backend; a no-op cut to ``top_k`` without a featurizer). The device
        scores are a projection of TF-IDF cosine whose error exceeds the
        true gaps between near-duplicates at million-chunk scale; the host
        re-score removes it. Ties go to the lower chunk id."""
        featurizer = self.featurizer
        if featurizer is None or not hits:
            return hits[:top_k]
        texts = [query] + [h.record.text for h in hits]
        ids, wts = featurizer.encode_batch(texts)
        norms = np.linalg.norm(wts, axis=1, keepdims=True)
        wts = wts / np.maximum(norms, 1e-12)
        qv = dict(zip(ids[0].tolist(), wts[0].tolist()))
        rescored = []
        for row, h in enumerate(hits, start=1):
            s = 0.0
            for fid, w in zip(ids[row], wts[row]):
                if w:
                    s += w * qv.get(int(fid), 0.0)
            rescored.append((-s, h.record.id, h, s))
        rescored.sort(key=lambda t: (t[0], t[1]))
        out = []
        for rank, (_, _, h, s) in enumerate(rescored[:top_k]):
            h.score = float(s)
            h.rank = rank
            out.append(h)
        return out

    @METRICS.spanned("index.search", nested=False)
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
        query_expansion: bool = True,
    ) -> list[list[SearchHit]]:
        """Encode query texts and search, optionally metadata-filtered
        (Milvus filter expressions). ``rerank=R`` fetches a device shortlist
        of R and re-scores it exactly with sparse TF-IDF cosine on the host
        (hashed backend only). Filtered searches on an int8 index fetch
        ``max(k + 6, 16)`` and repair the order exactly on the host.
        ``consistency_weight > 0`` scales positive similarities by the
        integrity multiplier before selection, strict (any failed check
        costs the whole weight) or smooth (by the fraction failed), and, with
        a sparse re-rank, re-applies it afterwards; a small scoped bucket is
        then scored exactly on the host with no device work. Hashed queries
        are expanded with financial synonyms unless ``query_expansion`` is
        False."""
        queries = self._expand_for_search(queries, query_expansion)
        fetch_k = max(top_k, rerank)
        mask = self._filter_mask(period, chunk_type, predicate, periods=periods, company=company)
        if predicate is None:
            # Integrity mode + a small filter bucket: exact sparse scoring on
            # the host. Queries are encoded only after this gate, so that
            # path stays free of device work.
            plan = self._exact_bucket_plan(
                mask, consistency_weight, periods, period, chunk_type, company
            )
            if plan is not None:
                return self._exact_bucket_search(
                    queries, plan[0], plan[1], top_k, consistency_weight, consistency_strict,
                )
        q = _pad_queries(self._encode_queries(queries))
        if mask is not None or consistency_weight > 0:
            key = None if mask is None or predicate is not None else (
                (_filter_key(period, periods, chunk_type, company),)
            )
            s_all, r_all = self._masked_topk(
                q, [mask], key, fetch_k, consistency_weight, consistency_strict
            )
            scores, rows = s_all[0], r_all[0]
        else:
            scores, rows = self.search_embeddings(q, top_k=fetch_k, method=method)
        return self._postprocess_device_hits(
            queries, scores, rows, top_k, rerank, consistency_weight, consistency_strict
        )

    def _exact_repair(self, q, scores, rows, keep: int):
        """Exact host re-score of a FILTERED int8 device shortlist; only
        entries the device scored finite are re-scored (a masked-out row
        must never re-enter on its raw cosine)."""
        with METRICS.span("index.readback"):
            scores = _host(scores)
            rows = _host(rows)
        with METRICS.span("index.repair"):
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

    def _postprocess_device_hits(
        self, queries, scores, rows, top_k, rerank=0, consistency_weight=0.0,
        consistency_strict=True,
    ):
        """Device shortlist -> SearchHit lists: drop sentinel and -inf slots,
        then the optional exact sparse re-rank and consistency re-rank."""
        with METRICS.span("index.readback"):
            scores = _host(scores)
            rows = _host(rows)
        return self._host_hits(
            queries, scores, rows, top_k, rerank, consistency_weight, consistency_strict
        )

    @METRICS.spanned("index.hits")
    def _host_hits(
        self, queries, scores, rows, top_k, rerank, consistency_weight, consistency_strict
    ):
        """Host shortlists -> SearchHit lists (see _postprocess_device_hits)."""
        out = []
        for qi in range(len(queries)):
            hits = []
            for rank in range(scores.shape[1]):
                row = int(rows[qi, rank])
                if row >= self.n or not np.isfinite(scores[qi, rank]):
                    continue
                hits.append(SearchHit(float(scores[qi, rank]), self.records[row], rank))
            # With a consistency stage downstream the sparse re-rank hands
            # over the whole shortlist: the gold chunk can sit below dozens
            # of tampered near-duplicates on similarity alone.
            keep = top_k if consistency_weight <= 0 else len(hits)
            if rerank:
                hits = self._sparse_rerank(queries[qi], hits, keep)
            if consistency_weight > 0 and rerank and self.featurizer is not None:
                # The sparse re-rank replaced the weighted device scores with
                # raw cosines, so the multiplier is applied again. Without it
                # the device scores already carry the multiplier.
                from ..retrieval.consistency import consistency_rerank

                cache = getattr(self, "_consistency_cache", None)
                if cache is None:
                    cache = self._consistency_cache = {}
                hits = consistency_rerank(
                    hits, top_k, weight=consistency_weight, cache=cache,
                    strict=consistency_strict,
                )
            else:
                hits = hits[:top_k]
            out.append(hits)
        return out

    def _expand_for_search(self, queries, query_expansion: bool) -> list:
        """Query-side financial-idiom expansion (models/synonyms.py) for the
        hashed backend; documents are never expanded."""
        queries = list(queries)
        hashed = getattr(self.embedder, "backend", "hashed") == "hashed"
        if query_expansion and hashed and self.featurizer is not None:
            from ..models.synonyms import expand_queries

            queries = expand_queries(queries)
        return queries

    def _encode_queries(self, queries) -> np.ndarray:
        if self.embedder is not None:
            return self.embedder.encode_texts(queries)
        if self.featurizer is not None and self.encoder is not None:
            ids, wts = self.featurizer.encode_batch(queries)
            return _host(self.encoder.encode(ids, wts))
        raise ValueError(
            "no embedder attached to this index; use search_embeddings "
            "or construct via DeviceVectorIndex.build/load"
        )

    def _exact_bucket_plan(
        self, mask, consistency_weight, periods, period, chunk_type, company
    ):
        """(bucket_rows, cache_key) when the exact-sparse host path answers
        this filter (integrity mode + a scoped bucket of at most
        ``exact_bucket_max`` rows), else None. The one gate both
        ``search_texts`` and ``search_texts_tiers`` consult."""
        if not (consistency_weight > 0 and mask is not None and self.featurizer is not None):
            return None
        bucket_rows = np.nonzero(mask[: len(self.records)])[0]
        if not (0 < bucket_rows.size <= self.exact_bucket_max):
            return None
        return bucket_rows, _filter_key(period, periods, chunk_type, company)

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
        """Get-or-upload a device mask (or a scope's gathered pair) under
        ``key`` (bounded cache): filter vocabularies are small, so each
        crosses to the device once."""
        cache = getattr(self, "_device_mask_cache", None)
        if cache is None:
            cache = self._device_mask_cache = {}
        full_key = (*key, self.matrix_t.shape[1])
        hit = cache.get(full_key)
        if hit is not None:
            return hit
        METRICS.count("index.mask_build")
        dev = build()
        if len(cache) > 32:
            cache.clear()
        cache[full_key] = dev
        return dev

    @METRICS.spanned("index.mask")
    def _device_tier_masks(self, key, masks) -> torch.Tensor:
        """Device-resident [G, N] tier-mask stack, cached per tier-group key."""
        return self._device_cached_mask(
            ("group", key), lambda: torch.from_numpy(np.stack(masks)).to(self.device)
        )

    @METRICS.spanned("index.mask")
    def _device_row_mask(self, key, mask: np.ndarray) -> torch.Tensor:
        """Single [N] device row mask, cached per filter key."""
        return self._device_cached_mask(
            ("single", key), lambda: torch.from_numpy(mask).to(self.device)
        )

    @METRICS.spanned("index.mask")
    def _scope_columns(self, key, masks, k: int):
        """The scope of a masked search on the device, ``(rows, tier_masks)``,
        when the union of the tiers' host ``masks`` holds R rows with
        ``k <= R <= N * scope_gather_max_share`` (N the padded width), else
        None. ``rows`` are the union's [R] ids, ascending, below ``n``;
        ``tier_masks`` the [G, R] tier masks over them (None for one tier).
        R is counted once per tier key; the device pair is cached beside the
        dense masks, under the same key."""
        width = int(self.matrix_t.shape[1])
        sizes = getattr(self, "_scope_sizes", None)
        if sizes is None:
            sizes = self._scope_sizes = {}
        size = sizes.get((key, width))
        if size is None:
            if len(sizes) > 64:
                sizes.clear()
            size = sizes[(key, width)] = int(
                np.count_nonzero(np.logical_or.reduce(masks)[: self.n])
            )
        if not k <= size <= width * self.scope_gather_max_share:
            return None

        def build():
            rows = np.nonzero(np.logical_or.reduce(masks)[: self.n])[0]
            tier_masks = None
            if len(masks) > 1:
                tier_masks = torch.from_numpy(np.stack([m[rows] for m in masks])).to(self.device)
            return torch.from_numpy(rows).to(self.device), tier_masks

        return self._device_cached_mask(("gather", key), build)

    def _masked_topk(
        self, q, masks, key, fetch_k: int, consistency_weight: float, consistency_strict: bool
    ):
        """Top ``fetch_k`` of each filter tier for the padded queries ``q``:
        ([G, Q, k] scores, [G, Q, k] ids), device tensors, or host arrays
        after the filtered int8 repair. ``masks`` holds each tier's host row
        mask (a lone None: every row, for ``score_mult`` alone); ``key`` the
        tiers' filter keys, under which the device masks are cached (None:
        a predicate's mask, uploaded each time). A scope that
        :meth:`_scope_columns` admits is scored on its own columns; any other
        on every column, masked."""
        qt = self._queries_tensor(q)
        score_mult = (
            self._integrity_mult(consistency_weight, consistency_strict)
            if consistency_weight > 0
            else None
        )
        fetch_k = min(fetch_k, max(self.n, 1))
        repair = self._repairable(consistency_weight)
        dev_k = min(_repair_width(fetch_k) if repair else fetch_k, max(self.n, 1))
        scope = None if key is None else self._scope_columns(key, masks, dev_k)
        if scope is not None:
            rows, dev_masks = scope
        elif len(masks) > 1:
            dev_masks = self._device_tier_masks(key, masks)
        elif masks[0] is None:
            dev_masks = None
        elif key is None:
            dev_masks = torch.from_numpy(masks[0]).to(self.device)
        else:
            dev_masks = self._device_row_mask(key, masks[0])
        corpus, scales, n_valid = self.matrix_t, self.scales, self.n
        with METRICS.span("index.topk"):
            if scope is not None:
                # The scope's columns alone, ascending: the dense tiers'
                # arithmetic on each, and their stable selection's order.
                METRICS.count("index.scope_gather")
                corpus = corpus.index_select(1, rows)
                scales = None if scales is None else scales.index_select(1, rows)
                score_mult = None if score_mult is None else score_mult.index_select(0, rows)
                n_valid = None
            if dev_masks is not None and dev_masks.dim() == 2:
                if self.quantized:
                    s_all, r_all = cosine_topk_dense_multi_int8(
                        qt, corpus, scales, dev_k, dev_masks,
                        n_valid=n_valid, score_mult=score_mult,
                    )
                else:
                    s_all, r_all = cosine_topk_dense_multi(
                        qt, corpus, dev_k, dev_masks, n_valid=n_valid, score_mult=score_mult,
                    )
            else:
                if self.quantized:
                    s_all, r_all = cosine_topk_dense_int8(
                        qt, corpus, scales, dev_k,
                        n_valid=n_valid, row_mask=dev_masks, score_mult=score_mult,
                    )
                else:
                    s_all, r_all = cosine_topk_dense(
                        qt, corpus, dev_k,
                        n_valid=n_valid, row_mask=dev_masks, score_mult=score_mult,
                    )
                s_all, r_all = s_all[None], r_all[None]
            if scope is not None:
                r_all = rows[r_all.long()].to(torch.int32)
        if not repair:
            return s_all, r_all
        keep = min(fetch_k, dev_k)
        pairs = [self._exact_repair(q, s_all[gi], r_all[gi], keep) for gi in range(len(masks))]
        return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

    @METRICS.spanned("index.search", nested=False)
    def search_texts_tiers(
        self,
        queries: Sequence[str],
        tier_filters: Sequence[dict],
        top_k: int = 3,
        method: str = "auto",
        rerank: int = 0,
        consistency_weight: float = 0.0,
        consistency_strict: bool = True,
        query_expansion: bool = True,
    ) -> list[list[list[SearchHit]]]:
        """All filter tiers of a query group from one score matrix, over the
        columns of the tiers' scope or all N; equivalent to
        ``[search_texts(queries, **f) for f in tier_filters]``.
        Integrity-mode tiers with a small bucket take the exact host path,
        as in ``search_texts``."""
        if any(f.get("predicate") is not None for f in tier_filters):
            return [
                self.search_texts(
                    queries, top_k=top_k, method=method, rerank=rerank,
                    consistency_weight=consistency_weight,
                    consistency_strict=consistency_strict,
                    query_expansion=query_expansion, **f,
                )
                for f in tier_filters
            ]
        queries = self._expand_for_search(queries, query_expansion)
        width = self.matrix_t.shape[1]
        results: dict[int, list] = {}
        device_tiers: list[int] = []
        masks: list[np.ndarray] = []
        tier_keys: list = []
        for ti, flt in enumerate(tier_filters):
            mask = self._filter_mask(
                flt.get("period"), flt.get("chunk_type"), None,
                periods=flt.get("periods"), company=flt.get("company"),
            )
            plan = self._exact_bucket_plan(
                mask, consistency_weight, flt.get("periods"), flt.get("period"),
                flt.get("chunk_type"), flt.get("company"),
            )
            if plan is not None:
                results[ti] = self._exact_bucket_search(
                    queries, plan[0], plan[1], top_k, consistency_weight, consistency_strict,
                )
                continue
            device_tiers.append(ti)
            masks.append(np.ones(width, bool) if mask is None else mask)
            tier_keys.append(_filter_key(
                flt.get("period"), flt.get("periods"), flt.get("chunk_type"), flt.get("company"),
            ))
        if device_tiers:
            q = _pad_queries(self._encode_queries(queries))
            s_all, r_all = self._masked_topk(
                q, masks, tuple(tier_keys), max(top_k, rerank),
                consistency_weight, consistency_strict,
            )
            with METRICS.span("index.readback"):
                s_all = _host(s_all)
                r_all = _host(r_all)
            for gi, ti in enumerate(device_tiers):
                results[ti] = self._postprocess_device_hits(
                    queries, s_all[gi], r_all[gi], top_k, rerank,
                    consistency_weight, consistency_strict,
                )
        return [results[ti] for ti in range(len(tier_filters))]

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
        """New index with ``new_chunks`` appended. With the corpus-dependent
        hashed embedder, ``refit=True`` refits the TF-IDF statistics over the
        union and re-encodes everything (new terms would otherwise be out of
        vocabulary); otherwise the new chunks are encoded under the frozen
        embedder and appended."""
        embedder = getattr(self, "embedder", None)
        if embedder is None:
            raise ValueError("index has no embedder; rebuild instead")
        all_records = list(self.records) + list(new_chunks)
        if refit and getattr(embedder, "featurizer", None) is not None:
            from ..models.embedder import HashedEmbedder

            old = embedder.featurizer
            fresh = HashedFeaturizer(
                vocab_size=old.vocab_size, sublinear_tf=old.sublinear_tf,
                bigram_weight=old.bigram_weight, drop_oov=old.drop_oov,
            )
            embedder = HashedEmbedder(featurizer=fresh, encoder=embedder.encoder)
            embedder.fit([r.text for r in all_records])
            matrix = embedder.encode_texts([r.text for r in all_records])
        else:
            new = embedder.encode_texts([c.text for c in new_chunks])
            matrix = np.concatenate([self._dense_rows(), new], axis=0)
        out = DeviceVectorIndex(
            matrix,
            all_records,
            name=self.name,
            dtype="int8" if self.quantized else self.matrix_t.dtype,
            normalize=False,
            device=self.device,
        )
        out._attach(embedder)
        return out

    # --- persistence ------------------------------------------------------
    def save(self, directory: str) -> None:
        """Write ``index.json`` and the f32 matrix (the shadow rows for an
        int8 index) in the JAX package's format: the featurizer and encoder
        states, a tuned projection table as ``encoder_table.npy`` (a stale
        one is removed), and a non-hashed embedder's state."""
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
        if self.featurizer is not None:
            meta["featurizer"] = self.featurizer.state_dict()
        table_path = os.path.join(directory, "encoder_table.npy")
        if self.encoder is not None:
            meta["encoder"] = self.encoder.state_dict()
            if self.encoder.tuned:
                # A tuned table cannot be regenerated from the seed.
                np.save(table_path, self.encoder.table.float().cpu().numpy())
            elif os.path.exists(table_path):
                # An untuned save over a tuned directory: load() must not
                # attach a projection that does not match this matrix.
                os.remove(table_path)
        if self.embedder is not None and getattr(self.embedder, "backend", "hashed") != "hashed":
            meta["embedder"] = self.embedder.state_dict()
        with open(os.path.join(directory, "index.json"), "w") as f:
            # One C-encoded string: json.dump's streaming encoder is pure
            # Python, seconds per 100k records. The bytes are the same.
            f.write(json.dumps(meta, ensure_ascii=False))

    @classmethod
    def load(cls, directory: str, device: DeviceLike = None, **kwargs) -> "DeviceVectorIndex":
        with open(os.path.join(directory, "index.json")) as f:
            meta = json.load(f)
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
        if "featurizer" in meta:
            index.featurizer = HashedFeaturizer.from_state_dict(meta["featurizer"])
        if "encoder" in meta:
            tpath = os.path.join(directory, "encoder_table.npy")
            table = (
                np.load(tpath) if meta["encoder"].get("tuned") and os.path.exists(tpath) else None
            )
            index.encoder = BagEncoder.from_state_dict(
                meta["encoder"], table=table, device=index.device
            )
        backend = meta.get("embedder", {}).get("backend")
        if backend == "minilm":
            from ..models.embedder import MiniLMEmbedder

            index.embedder = MiniLMEmbedder(
                checkpoint=meta["embedder"].get("checkpoint"), device=index.device
            )
        elif backend == "trained":
            from ..models.embedder import TrainedEmbedder

            ckpt = meta["embedder"].get("checkpoint")
            if ckpt and not os.path.exists(os.path.join(ckpt, "config.json")):
                ckpt = None  # saved under a moved/renamed tree: packaged default
            index.embedder = TrainedEmbedder(checkpoint=ckpt, device=index.device)
        elif index.featurizer is not None and index.encoder is not None:
            from ..models.embedder import HashedEmbedder

            index.embedder = HashedEmbedder(featurizer=index.featurizer, encoder=index.encoder)
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
