"""Device-resident knowledge-graph store with masked query kernels.

Counterpart of ``ragfin_tpu/index/graph_index.py`` (the reference's Neo4j
graph: Organization-[:HAS_QUARTER]->Quarter-[:HAS_METRIC|
HAS_SEGMENT_PERFORMANCE|HAS_RATIO|HAS_BALANCE_SHEET_ITEM]->typed nodes).
Design, unchanged from the JAX package:

- Entity names and quarters map to a fixed integer vocabulary (seeded from
  ``config.constants.FINANCIAL_ENTITY_TYPES``; unseen names grow the vocab).
- Every (quarter -> entity) edge with its typed attributes is one row of a
  packed columnar **fact table**: int32 quarter/entity/type columns + float32
  attribute columns, padded to a multiple of 128 rows and sorted by
  (quarter, type) with stable insertion order within a group.
- A query = boolean masks over the quarter/entity/type vocabularies. Under
  2^18 padded rows the match ranks rows by the int32 key ``-row_idx`` and
  takes a top-k; at or above it a predicate pass gives a hit vector and
  :func:`masked_first_k` compacts its first ``limit`` positions (the table is
  sorted, so the first k hits are the top-k): on a CUDA tensor the
  hand-written kernel ``csrc/first_k.cu``, on a CPU tensor its plain version.
- k-hop expansion = rounds of mask propagation through the fact table.

Graph mutation happens host-side on columnar numpy buffers, exactly as in
the JAX package (same vocabularies, same ``np.lexsort`` order, same padding,
same on-disk format: a store saved by either package loads in the other);
the packed device tensors are re-materialized lazily on the first query
after a mutation, on the index's device.

Where the JAX module packs masks into words to avoid TPU gathers and
scatters (``_mask_lookup``, ``_scatter_any``), plain ``mask[ids]`` and an
index fill are right on this device and give equal outputs.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..config.constants import FINANCIAL_ENTITY_TYPES, SUPPORTED_QUARTERS
from ..data.models import ExtractedEntities
from ..ops import _cuda
from ..utils.device import DeviceLike, resolve_device

# Fact types (edge labels of the reference schema).
METRIC, SEGMENT, RATIO, BALANCE = 0, 1, 2, 3
TYPE_NAMES = {METRIC: "Metric", SEGMENT: "Segment", RATIO: "Ratio", BALANCE: "BalanceSheetItem"}
EDGE_NAMES = {
    METRIC: "HAS_METRIC",
    SEGMENT: "HAS_SEGMENT_PERFORMANCE",
    RATIO: "HAS_RATIO",
    BALANCE: "HAS_BALANCE_SHEET_ITEM",
}
_PAD = 128

_PERIOD_RE = re.compile(r"^Q([1-4])_FY(\d{4})$")


def _period_key(period: str):
    """Chronological sort key for ``Q#_FY####`` periods.

    Returns (0, fiscal_year, quarter) for conforming periods so FY2024 Q4
    precedes FY2025 Q1; non-conforming strings sort after, by raw string.
    """
    m = _PERIOD_RE.match(period or "")
    if m:
        return (0, int(m.group(2)), int(m.group(1)), "")
    return (1, 0, 0, period or "")


_RANK_MISS = -0x80000000  # sentinel strictly below any -row_idx
_INT_MAX = 0x7FFFFFFF
# Padded row count from which match() takes the first-k route.
FIRST_K_MIN_ROWS = 1 << 18
FIRST_K_SPAN = 32768  # hit bytes per block of csrc/first_k.cu (kFkSpan)
_FIRST_K_HEADER = 2  # int64 words of its scratch before the per-span status words
# The kernel's scratch, one per (device, stream), as (buffer, its address,
# its status words): it carries the kernel's state from one call to the next
# (csrc/first_k.cu), so no call allocates or clears it, and two streams
# never share one.
_first_k_scratch: dict[tuple[int, int], tuple[torch.Tensor, int, int]] = {}


def masked_first_k_plain(hit: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the first-k kernel (same contract)."""
    pos = torch.nonzero(hit.reshape(-1) != 0).reshape(-1)[:k].to(torch.int32)
    ids = torch.full((k,), _INT_MAX, dtype=torch.int32, device=hit.device)
    ids[: pos.shape[0]] = pos
    return ids, torch.tensor(pos.shape[0], dtype=torch.int32, device=hit.device)


def _scratch_for(device: int, stream: int, n_spans: int) -> tuple[torch.Tensor, int, int]:
    """The first-k scratch of (device, stream), grown to ``n_spans`` status
    words. A new one is zeroed once, on that stream, which is the state the
    kernel expects before its first call."""
    entry = _first_k_scratch.get((device, stream))
    if entry is None or entry[2] < n_spans:
        n_status = max(n_spans, 2 * entry[2]) if entry else n_spans
        buf = torch.zeros((_FIRST_K_HEADER + n_status,), dtype=torch.int64,
                          device=torch.device("cuda", device))
        entry = _first_k_scratch[(device, stream)] = (buf, buf.data_ptr(), n_status)
    return entry


def masked_first_k(hit: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """First ``k`` set positions of a ``[N]`` int8/bool hit vector in row
    order: ``(ids [k] int32 padded with INT32_MAX, count int32 = min(hits,
    k))``. A CUDA tensor runs ``csrc/first_k.cu`` (one launch); a CPU tensor
    its plain version. Launches are counted in ``masked_first_k.launches``."""
    if hit.dim() != 1:
        raise ValueError(f"hit must be a vector, got {tuple(hit.shape)}")
    if hit.dtype not in (torch.int8, torch.uint8, torch.bool):
        raise TypeError(f"hit must be int8, uint8 or bool, got {hit.dtype}")
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if not hit.is_cuda:
        return masked_first_k_plain(hit, k)
    n = hit.shape[0]
    if n >= 2**31:
        raise ValueError("the first-k kernel takes fewer than 2^31 rows")
    # The one allocation of a call: what the caller keeps, ids [k] and count.
    out = torch.empty((k + 1,), dtype=torch.int32, device=hit.device)
    if n == 0:
        return out[:k].fill_(_INT_MAX), out[k].zero_()
    hit = hit.contiguous()
    device = hit.get_device()
    stream = torch._C._cuda_getCurrentRawStream(device)
    _, scratch, n_status = _scratch_for(device, stream, -(-n // FIRST_K_SPAN))
    with torch.cuda.device(device):  # launch on the hit vector's card
        err = _cuda.kernel("first_k")(hit.data_ptr(), n, k, scratch, n_status, out.data_ptr(), stream)
    _cuda.check(err, "first_k")
    masked_first_k.launches += 1
    return out[:k], out[k]


masked_first_k.launches = 0


def _predicate(quarter_ids, entity_ids, type_ids, row_valid, quarter_mask, entity_mask, type_mask):
    """Masked fact predicate (the Cypher WHERE clause): the single source of
    truth shared by :func:`_hit_vector`, :func:`_match_kernel` and
    :func:`_aggregate_kernel`."""
    return quarter_mask[quarter_ids] & entity_mask[entity_ids] & type_mask[type_ids] & row_valid


def _hit_vector(quarter_ids, entity_ids, type_ids, row_valid, quarter_mask, entity_mask, type_mask):
    """Masked fact predicate, one vectorized pass."""
    return _predicate(
        quarter_ids, entity_ids, type_ids, row_valid, quarter_mask, entity_mask, type_mask
    )


def _match_kernel(
    quarter_ids, entity_ids, type_ids, row_valid,
    quarter_mask, entity_mask, type_mask, limit: int,
):
    """Masked fact selection: (top row ids, their valid flags, hit count).

    Ranking key is the int32 ``-row_idx`` (earlier rows rank higher), so row
    order is exact for any row count: a float32 key would collapse distinct
    rows past 2^24. Misses get the int32-min sentinel, and every hit's key
    is distinct, so the top-k has no ties among valid entries. Results come
    back in CSR order (quarter-major), matching the reference's
    ``ORDER BY q.name``.
    """
    rows = quarter_ids.shape[0]
    hit = _predicate(
        quarter_ids, entity_ids, type_ids, row_valid, quarter_mask, entity_mask, type_mask
    )
    row_idx = torch.arange(rows, dtype=torch.int32, device=hit.device)
    score = torch.where(hit, -row_idx, torch.full_like(row_idx, _RANK_MISS))
    k = min(limit, rows)
    top_scores, top_rows = torch.topk(score, k)
    return top_rows.to(torch.int32), top_scores != _RANK_MISS, hit.sum()


def _aggregate_kernel(values, quarter_ids, entity_ids, type_ids, row_valid,
                      quarter_mask, entity_mask, type_mask):
    """Masked aggregation over fact values: (argmax row, argmin row, mean,
    count); the first row wins a tie for the maximum or the minimum.

    Powers peak/trough questions ("which quarter did X peak") as one device
    reduction instead of host-side sorting of match results."""
    hit = _predicate(
        quarter_ids, entity_ids, type_ids, row_valid, quarter_mask, entity_mask, type_mask
    ) & torch.isfinite(values)
    pos = torch.where(hit, values, torch.full_like(values, float("-inf")))
    neg = torch.where(hit, values, torch.full_like(values, float("inf")))
    n_hit = hit.sum()
    mean = torch.where(hit, values, torch.zeros_like(values)).sum() / n_hit.clamp(min=1)
    return _first_argmax(pos), _first_argmax(-neg), mean, n_hit


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Lowest index holding the maximum (``jnp.argmax``'s tie rule, which
    ``torch.argmax`` documents but does not keep on every backend)."""
    idx = torch.arange(x.shape[0], device=x.device)
    return torch.where(x == x.max(), idx, torch.full_like(idx, x.shape[0])).min()


def _scatter_any(ids: torch.Tensor, hit: torch.Tensor, size: int) -> torch.Tensor:
    """``zeros(size).at[ids].max(hit)``: which vocabulary entries any hit row
    points at. Every row stores ``True`` at its id, or at an extra slot when
    it did not hit: plain stores of one value, so no row list is compacted
    first and colliding rows need no atomics (a histogram with that extra
    bin spends over a millisecond per 10M rows on its atomic adds)."""
    out = torch.zeros((size + 1,), dtype=torch.bool, device=ids.device)
    out[torch.where(hit, ids, torch.full_like(ids, size)).long()] = True
    return out[:size]


def _khop_kernel(
    quarter_ids, entity_ids, row_valid, seed_entity_mask,
    n_quarters: int, n_entities: int, hops: int,
):
    """k-hop frontier expansion by iterated mask propagation through the
    fact table. One hop = seed entities -> quarters touching them; each
    further hop adds the entities co-occurring in reached quarters and then
    their quarters."""
    e_mask = seed_entity_mask
    q_mask = torch.zeros((n_quarters,), dtype=torch.bool, device=quarter_ids.device)
    for _ in range(hops):
        q_mask = q_mask | _scatter_any(quarter_ids, e_mask[entity_ids] & row_valid, n_quarters)
        e_mask = e_mask | _scatter_any(entity_ids, q_mask[quarter_ids] & row_valid, n_entities)
    reached = q_mask[quarter_ids] & row_valid
    return q_mask, e_mask, reached


class GraphIndex:
    """Columnar fact store + vocabulary + device query kernels."""

    # Numeric fact columns (SoA). String attributes are interned into
    # per-column vocabularies so a 10M-fact store is ~9 int/float numpy
    # columns, not 10M python tuples.
    _NUM_COLS = ("quarter_ids", "entity_ids", "type_ids", "value", "growth", "aux")
    _STR_COLS = ("unit_ids", "chunk_ids", "dataset_ids", "company_ids")

    def __init__(self, company: str = "ICICI Bank", device: DeviceLike = None):
        self.company = company
        self.device = resolve_device(device)
        self.quarters: list[str] = list(SUPPORTED_QUARTERS)
        self._quarter_id: dict[str, int] = {q: i for i, q in enumerate(self.quarters)}
        self.entities: list[str] = []
        self._entity_id: dict[str, int] = {}
        for names in FINANCIAL_ENTITY_TYPES.values():
            for name in names:
                self._intern_entity(name)
        # String-attribute vocabularies (unit / source chunk / dataset).
        self._units: list[str] = [""]
        self._unit_id: dict[str, int] = {"": 0}
        self._chunks: list[str] = [""]
        self._chunk_id_of: dict[str, int] = {"": 0}
        self._datasets: list[str] = [""]
        self._dataset_id_of: dict[str, int] = {"": 0}
        # Company vocab (reference: quarters live under an Organization
        # node; without a per-fact company a multi-company graph conflates
        # banks at query time). Slot 0 = the default company.
        self._companies: list[str] = [company]
        self._company_id_of: dict[str, int] = {company: 0}
        # Consolidated columnar store + small append buffer.
        self._cols: dict[str, np.ndarray] = self._empty_cols()
        self._pending: list[tuple] = []
        self._packed: Optional[dict[str, Any]] = None
        self.organizations: dict[str, set[str]] = {}
        self.quarter_sources: dict[str, list[str]] = {}

    @classmethod
    def _empty_cols(cls) -> dict[str, np.ndarray]:
        return {
            "quarter_ids": np.zeros((0,), np.int32),
            "entity_ids": np.zeros((0,), np.int32),
            "type_ids": np.zeros((0,), np.int32),
            "value": np.zeros((0,), np.float32),
            "growth": np.zeros((0,), np.float32),
            "aux": np.zeros((0,), np.float32),
            "unit_ids": np.zeros((0,), np.int32),
            "chunk_ids": np.zeros((0,), np.int32),
            "dataset_ids": np.zeros((0,), np.int32),
            "company_ids": np.zeros((0,), np.int32),
        }

    # --- vocabulary ------------------------------------------------------
    def _intern_entity(self, name: str) -> int:
        if name not in self._entity_id:
            self._entity_id[name] = len(self.entities)
            self.entities.append(name)
        return self._entity_id[name]

    def _intern_quarter(self, period: str) -> int:
        if period not in self._quarter_id:
            self._quarter_id[period] = len(self.quarters)
            self.quarters.append(period)
        return self._quarter_id[period]

    @staticmethod
    def _intern(vocab: list, index: dict, value: str) -> int:
        if value not in index:
            index[value] = len(vocab)
            vocab.append(value)
        return index[value]

    def intern_entities(self, names: Sequence[str]) -> np.ndarray:
        return np.array([self._intern_entity(n) for n in names], np.int32)

    def intern_quarters(self, periods: Sequence[str]) -> np.ndarray:
        return np.array([self._intern_quarter(p) for p in periods], np.int32)

    @property
    def n_facts(self) -> int:
        return int(self._cols["quarter_ids"].shape[0]) + len(self._pending)

    def _consolidate(self) -> None:
        """Fold the append buffer into the numpy columns."""
        if not self._pending:
            return
        pend = list(zip(*self._pending))
        new = {
            "quarter_ids": np.asarray(pend[0], np.int32),
            "entity_ids": np.asarray(pend[1], np.int32),
            "type_ids": np.asarray(pend[2], np.int32),
            "value": np.asarray([np.nan if v is None else v for v in pend[3]], np.float32),
            "growth": np.asarray([np.nan if v is None else v for v in pend[4]], np.float32),
            "aux": np.asarray([np.nan if v is None else v for v in pend[5]], np.float32),
            "unit_ids": np.asarray(pend[6], np.int32),
            "chunk_ids": np.asarray(pend[7], np.int32),
            "dataset_ids": np.asarray(pend[8], np.int32),
            "company_ids": np.asarray(pend[9], np.int32),
        }
        self._cols = {k: np.concatenate([self._cols[k], new[k]]) for k in self._cols}
        self._pending = []

    # --- mutation (reference save_entities, neo4j_service.py:48-175) ------
    def save_entities(
        self,
        entities: ExtractedEntities,
        chunk_id: str,
        dataset_id: str = "icici_fy2024",
        company_name: Optional[str] = None,
    ) -> int:
        quarter = entities.quarter
        if not quarter:
            return 0
        company = company_name or self.company
        self.organizations.setdefault(company, set()).add(quarter)
        sources = self.quarter_sources.setdefault(quarter, [])
        if chunk_id not in sources:  # rebuilds must not duplicate sources
            sources.append(chunk_id)
        q = self._intern_quarter(quarter)
        added = 0

        cid = self._intern(self._chunks, self._chunk_id_of, chunk_id)
        did = self._intern(self._datasets, self._dataset_id_of, dataset_id)
        coid = self._intern(self._companies, self._company_id_of, company)

        def put(type_id, name, value, growth, aux, unit):
            nonlocal added
            e = self._intern_entity(name)
            uid = self._intern(self._units, self._unit_id, unit or "")
            self._pending.append((q, e, type_id, value, growth, aux, uid, cid, did, coid))
            added += 1

        for m in entities.financial_metrics:
            put(METRIC, m.name, m.value, m.growth_yoy, None, m.unit)
        for s in entities.business_segments:
            # Segments have no YoY-growth field, so the growth column carries
            # percentage_of_total (a float does not belong in the unit vocab).
            put(SEGMENT, s.name, s.revenue, s.percentage_of_total, s.margin, None)
        for r in entities.financial_ratios:
            put(RATIO, r.name, r.value, r.growth_yoy, None, r.unit)
        for b in entities.balance_sheet_items:
            put(BALANCE, b.name, b.value, None, b.percentage_of_total, b.unit)
        if added:
            self._packed = None
        return added

    def add_facts_bulk(
        self,
        quarter_ids: np.ndarray,
        entity_ids: np.ndarray,
        type_ids: np.ndarray,
        values: np.ndarray,
        growth: Optional[np.ndarray] = None,
        aux: Optional[np.ndarray] = None,
        unit: str = "crore",
        chunk_id: str = "bulk",
        dataset_id: str = "bulk",
        company: Optional[str] = None,
    ) -> int:
        """Columnar bulk ingestion (the 10M-fact scale path): numpy arrays of
        pre-interned vocab ids (see :meth:`intern_quarters` /
        :meth:`intern_entities`) appended as one concatenate — no per-fact
        Python loop."""
        self._consolidate()
        n = int(quarter_ids.shape[0])
        uid = self._intern(self._units, self._unit_id, unit)
        cid = self._intern(self._chunks, self._chunk_id_of, chunk_id)
        did = self._intern(self._datasets, self._dataset_id_of, dataset_id)
        nan = np.full((n,), np.nan, np.float32)
        new = {
            "quarter_ids": np.asarray(quarter_ids, np.int32),
            "entity_ids": np.asarray(entity_ids, np.int32),
            "type_ids": np.asarray(type_ids, np.int32),
            "value": np.asarray(values, np.float32),
            "growth": nan if growth is None else np.asarray(growth, np.float32),
            "aux": nan if aux is None else np.asarray(aux, np.float32),
            "unit_ids": np.full((n,), uid, np.int32),
            "chunk_ids": np.full((n,), cid, np.int32),
            "dataset_ids": np.full((n,), did, np.int32),
            "company_ids": np.full(
                (n,),
                self._intern(self._companies, self._company_id_of, company or self.company),
                np.int32,
            ),
        }
        self._cols = {k: np.concatenate([self._cols[k], new[k]]) for k in self._cols}
        self._packed = None
        return n

    def clear_data(self, dataset_id: Optional[str] = None) -> None:
        """Clear one dataset or everything (reference :234-251)."""
        if dataset_id is None:
            self._cols = self._empty_cols()
            self._pending = []
            self.organizations = {}
            self.quarter_sources = {}
        else:
            self._consolidate()
            did = self._dataset_id_of.get(dataset_id)
            if did is not None:
                keep = self._cols["dataset_ids"] != did
                self._cols = {k: v[keep] for k, v in self._cols.items()}
                # Reference clear semantics remove the org/quarter nodes
                # too — rebuild the host-side views from surviving rows so
                # stats() does not report cleared data.
                self.organizations = {}
                self.quarter_sources = {}
                for qi, ci, coi in zip(
                    self._cols["quarter_ids"], self._cols["chunk_ids"],
                    self._cols["company_ids"],
                ):
                    quarter = self.quarters[int(qi)]
                    self.organizations.setdefault(
                        self._companies[int(coi)], set()
                    ).add(quarter)
                    chunk = self._chunks[int(ci)]
                    sources = self.quarter_sources.setdefault(quarter, [])
                    if chunk and chunk not in sources:
                        sources.append(chunk)
        self._packed = None

    # --- packing ----------------------------------------------------------
    def _pack(self) -> dict[str, Any]:
        if self._packed is not None:
            return self._packed
        self._consolidate()
        cols = self._cols
        n = int(cols["quarter_ids"].shape[0])
        # CSR order: quarter-major in true chronological order (parsed
        # (fiscal_year, quarter) key — a lexicographic sort on the period
        # string would put Q1_FY2025 before Q4_FY2024), then type, then
        # insertion order. Matches the reference's ``ORDER BY q.period``
        # intent across fiscal years. Vectorized: np.lexsort over the
        # chronological quarter rank (sort is stable, preserving insertion
        # order within (quarter, type)).
        chrono = sorted(range(len(self.quarters)), key=lambda i: _period_key(self.quarters[i]))
        rank_of = np.zeros((len(self.quarters),), np.int64)
        for r, qi in enumerate(chrono):
            rank_of[qi] = r
        qrank = rank_of[cols["quarter_ids"]]
        order = np.lexsort((cols["type_ids"], qrank))  # stable; minor key first
        sorted_cols = {k: v[order] for k, v in cols.items()}

        pad = -n % _PAD or _PAD
        total = n + pad

        def padded(arr, default):
            out = np.full((total,), default, arr.dtype)
            out[:n] = arr
            return out

        def dev(arr):
            return torch.from_numpy(arr).to(self.device)

        self._packed = {
            "quarter_ids": dev(padded(sorted_cols["quarter_ids"], 0)),
            "entity_ids": dev(padded(sorted_cols["entity_ids"], 0)),
            "type_ids": dev(padded(sorted_cols["type_ids"], 0)),
            "value": dev(padded(sorted_cols["value"], np.nan)),
            "growth": dev(padded(sorted_cols["growth"], np.nan)),
            "aux": dev(padded(sorted_cols["aux"], np.nan)),
            "company_ids": dev(padded(sorted_cols["company_ids"], 0)),
            "row_valid": dev(np.arange(total) < n),
            # Host sidecar: sorted numpy columns for result materialization.
            "host": sorted_cols,
            "n": n,
        }
        return self._packed

    # --- queries ----------------------------------------------------------
    def _scoped_valid(self, packed, companies: Optional[Sequence[str]]):
        """row_valid ∧ company scope. The fact table carries a per-row
        company id (the reference scopes quarters under an Organization
        node); without this, a multi-company graph would conflate banks in
        match/aggregate results."""
        rv = packed["row_valid"]
        if not companies:
            return rv
        cm = np.zeros((len(self._companies),), bool)
        for c in companies:
            ci = self._company_id_of.get(c)
            if ci is not None:
                cm[ci] = True
        return rv & torch.from_numpy(cm).to(self.device)[packed["company_ids"]]

    def _masks(self, quarters: Optional[Sequence[str]], names: Optional[Sequence[str]], types: Optional[Sequence[int]]):
        nq, ne = len(self.quarters), len(self.entities)
        qm = np.zeros((nq,), bool)
        if quarters:
            for q in quarters:
                qid = self._quarter_id.get(q)
                if qid is not None and qid < nq:
                    qm[qid] = True
        else:
            qm[:] = True
        em = np.zeros((ne,), bool)
        if names:
            for name in names:
                if name in self._entity_id:
                    em[self._entity_id[name]] = True
        else:
            em[:] = True
        tm = np.zeros((4,), bool)
        if types:
            for t in types:
                tm[t] = True
        else:
            tm[:] = True
        return tuple(torch.from_numpy(m).to(self.device) for m in (qm, em, tm))

    def match(
        self,
        quarters: Optional[Sequence[str]] = None,
        names: Optional[Sequence[str]] = None,
        types: Optional[Sequence[int]] = None,
        limit: int = 30,
        companies: Optional[Sequence[str]] = None,
    ) -> list[dict]:
        """Masked fact selection → result rows in the reference's Cypher
        result-dict shapes (graph_cons.py:371-456)."""
        packed = self._pack()
        if packed["n"] == 0:
            return []
        qm, em, tm = self._masks(quarters, names, types)
        row_valid = self._scoped_valid(packed, companies)
        total = int(packed["quarter_ids"].shape[0])
        if total >= FIRST_K_MIN_ROWS:
            # Scale path: one vectorized predicate pass + the first-k kernel
            # (CSR order makes first-k == top-k): no sort of the table.
            hit = _hit_vector(
                packed["quarter_ids"], packed["entity_ids"], packed["type_ids"],
                row_valid, qm, em, tm,
            )
            ids, _cnt = masked_first_k(hit, min(limit, total))
            ids = ids.cpu().numpy()
            return self._rows_to_dicts(packed, ids, ids < packed["n"])
        top_rows, valid, _count = _match_kernel(
            packed["quarter_ids"], packed["entity_ids"], packed["type_ids"],
            row_valid, qm, em, tm, limit,
        )
        return self._rows_to_dicts(packed, top_rows.cpu().numpy(), valid.cpu().numpy())

    def aggregate(
        self,
        names: Optional[Sequence[str]] = None,
        quarters: Optional[Sequence[str]] = None,
        types: Optional[Sequence[int]] = None,
        field: str = "value",
        companies: Optional[Sequence[str]] = None,
    ) -> Optional[dict]:
        """Masked min/max/mean over a fact attribute ('value'|'growth'|'aux').

        Returns {"max": row-dict, "min": row-dict, "mean": float, "count"} or
        None when nothing matches — e.g. peak-margin-quarter questions use
        field="aux" over SEGMENT facts."""
        packed = self._pack()
        if packed["n"] == 0:
            return None
        qm, em, tm = self._masks(quarters, names, types)
        argmax, argmin, mean, count = _aggregate_kernel(
            packed[field], packed["quarter_ids"], packed["entity_ids"], packed["type_ids"],
            self._scoped_valid(packed, companies), qm, em, tm,
        )
        if int(count) == 0:
            return None
        rows = self._rows_to_dicts(
            packed, np.asarray([int(argmax), int(argmin)]), np.asarray([True, True])
        )
        return {"max": rows[0], "min": rows[1] if len(rows) > 1 else rows[0],
                "mean": float(mean), "count": int(count), "field": field}

    def expand(self, names: Sequence[str], limit: int = 30, hops: int = 1) -> list[dict]:
        """k-hop co-occurrence expansion from entity names (C20 traverse,
        ``mcp_graph_rag/graph_rag_tools.py:1538-1595``, generalized)."""
        packed = self._pack()
        if packed["n"] == 0:
            return []
        ne = len(self.entities)
        em = np.zeros((ne,), bool)
        for name in names:
            if name in self._entity_id:
                em[self._entity_id[name]] = True
        _q_mask, _e_mask, reached = _khop_kernel(
            packed["quarter_ids"], packed["entity_ids"], packed["row_valid"],
            torch.from_numpy(em).to(self.device), len(self.quarters), ne, int(hops),
        )
        if limit < 1:
            return []
        # The first `limit` reached rows, compacted on the device: the
        # reached mask (one byte a fact row) never travels to the host.
        total = int(packed["quarter_ids"].shape[0])
        rows = masked_first_k(reached, min(limit, total))[0].cpu().numpy()
        return self._rows_to_dicts(packed, rows, rows < packed["n"])

    def _rows_to_dicts(self, packed, row_ids, valid) -> list[dict]:
        out = []
        host = packed["host"]

        def _opt(x):
            return None if np.isnan(x) else float(x)

        for rid, ok in zip(row_ids, valid):
            if not ok or rid >= packed["n"]:
                continue
            r = int(rid)
            q = int(host["quarter_ids"][r])
            e = int(host["entity_ids"][r])
            t = int(host["type_ids"][r])
            company = self._companies[int(host["company_ids"][r])]
            value = _opt(host["value"][r])
            growth = _opt(host["growth"][r])
            aux = _opt(host["aux"][r])
            unit = self._units[int(host["unit_ids"][r])] or None
            chunk_id = self._chunks[int(host["chunk_ids"][r])]
            quarter = self.quarters[q]
            name = self.entities[e]
            if t == METRIC:
                out.append({"quarter": quarter, "company": company, "metric_name": name, "value": value,
                            "growth": growth, "unit": unit, "source_chunk": chunk_id})
            elif t == SEGMENT:
                out.append({"quarter": quarter, "company": company, "segment_name": name, "revenue": value,
                            "margin": aux, "percentage_of_total": growth,
                            "source_chunk": chunk_id})
            elif t == RATIO:
                out.append({"quarter": quarter, "company": company, "ratio_name": name, "value": value,
                            "growth": growth, "unit": unit, "source_chunk": chunk_id})
            else:
                out.append({"quarter": quarter, "company": company, "item_name": name, "value": value,
                            "percentage_of_total": aux, "unit": unit, "source_chunk": chunk_id})
        return out

    # --- stats (reference get_stats, neo4j_service.py:187-232) -------------
    def stats(self) -> dict:
        self._consolidate()
        q_ids = self._cols["quarter_ids"]
        t_ids = self._cols["type_ids"]
        nq = len(self.quarters)
        type_counts = np.bincount(t_ids, minlength=4)
        by_type = {TYPE_NAMES[t] + "_count": int(type_counts[t]) for t in range(4)}
        # Per-(quarter, type) detail via one bincount over a combined key.
        pair = np.bincount(q_ids.astype(np.int64) * 4 + t_ids, minlength=nq * 4).reshape(nq, 4)
        key = {METRIC: "metrics", SEGMENT: "segments", RATIO: "ratios", BALANCE: "balance_items"}
        detailed = {}
        quarters_present = []
        for qi in np.nonzero(pair.sum(axis=1))[0]:
            quarter = self.quarters[int(qi)]
            quarters_present.append(quarter)
            detailed[quarter] = {key[t]: int(pair[qi, t]) for t in range(4)}
        return {
            "Organization_count": len(self.organizations),
            "Quarter_count": len(quarters_present),
            **by_type,
            "quarters_available": sorted(quarters_present),
            "detailed_counts": dict(sorted(detailed.items())),
            "total_facts": int(q_ids.shape[0]),
        }

    def health_check(self) -> bool:
        return True

    # --- persistence ------------------------------------------------------
    def save(self, directory: str) -> None:
        """Columnar persistence: vocabularies in JSON, fact columns in one
        .npz (scales to 10M facts where a JSON row dump would not)."""
        os.makedirs(directory, exist_ok=True)
        self._consolidate()
        with open(os.path.join(directory, "graph.json"), "w") as f:
            json.dump(
                {
                    "format": 2,
                    "company": self.company,
                    "quarters": self.quarters,
                    "entities": self.entities,
                    "units": self._units,
                    "chunks": self._chunks,
                    "datasets": self._datasets,
                    "companies": self._companies,
                    "organizations": {k: sorted(v) for k, v in self.organizations.items()},
                    "quarter_sources": self.quarter_sources,
                },
                f,
                ensure_ascii=False,
            )
        np.savez_compressed(os.path.join(directory, "graph_facts.npz"), **self._cols)

    @classmethod
    def load(cls, directory: str, device: DeviceLike = None) -> "GraphIndex":
        with open(os.path.join(directory, "graph.json")) as f:
            data = json.load(f)
        g = cls(company=data.get("company", "ICICI Bank"), device=device)
        g.quarters = data["quarters"]
        g._quarter_id = {q: i for i, q in enumerate(g.quarters)}
        g.entities = data["entities"]
        g._entity_id = {name: i for i, name in enumerate(g.entities)}
        g.organizations = {k: set(v) for k, v in data.get("organizations", {}).items()}
        g.quarter_sources = data.get("quarter_sources", {})
        if data.get("format", 1) >= 2:
            for attr, key in (("_units", "units"), ("_chunks", "chunks"), ("_datasets", "datasets")):
                setattr(g, attr, data[key])
            g._unit_id = {u: i for i, u in enumerate(g._units)}
            g._chunk_id_of = {c: i for i, c in enumerate(g._chunks)}
            g._dataset_id_of = {d: i for i, d in enumerate(g._datasets)}
            if "companies" in data:
                g._companies = data["companies"]
                g._company_id_of = {c: i for i, c in enumerate(g._companies)}
            with np.load(os.path.join(directory, "graph_facts.npz")) as z:
                g._cols = {
                    k: (z[k] if k in z
                        else np.zeros(z["quarter_ids"].shape, np.int32))
                    for k in g._cols
                }
        else:
            # Format 1: JSON row tuples (q, e, t, value, growth, aux,
            # unit, chunk_id, dataset_id) — convert through the append path.
            for r in data.get("rows", []):
                q, e, t, value, growth, aux, unit, chunk_id, dataset_id = r
                uid = g._intern(g._units, g._unit_id, unit or "")
                cid = g._intern(g._chunks, g._chunk_id_of, chunk_id)
                did = g._intern(g._datasets, g._dataset_id_of, dataset_id)
                g._pending.append((q, e, t, value, growth, aux, uid, cid, did, 0))
            g._consolidate()
        return g
