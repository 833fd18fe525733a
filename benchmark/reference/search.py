"""Plain top-k search semantics of the two index dtypes, in blocks of rows.

- ``float32``: exact cosine, here in float64, top ``k`` by score descending,
  the lower row first on ties.
- ``int8``: the corpus rows and the queries quantised symmetrically (absmax
  times ``f32(1/127)``, round half to even, clip at 127), a shortlist of
  ``width`` rows by the integer dot product times the row's scale (lower row
  first on ties), then the shortlist re-scored exactly and cut to ``k``.

``lower`` gives the control: ``"tf32"`` scores the float32 tier and the int8
re-score with TF32 operands; ``"int4"`` quantises the shortlist to 4 bits
(clip at 7). The integer products are exact in float32 (below 2^24), so the
callers keep TF32 off (``torch.backends.cuda.matmul.allow_tf32``).
"""

from __future__ import annotations

import numpy as np
import torch

INV_127 = float(np.float32(1) / np.float32(127))
INV_7 = float(np.float32(1) / np.float32(7))


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-12)


def quantize_rows(x: torch.Tensor, bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """(integer values as float32, scale [rows, 1]) per row."""
    top, inv = (127.0, INV_127) if bits == 8 else (7.0, INV_7)
    scale = x.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) * inv
    return torch.clamp(torch.round(x / scale), -top, top), scale


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest even), as the
    tensor cores read float32 operands in TF32 mode; products of rounded
    operands accumulated in float32 are the TF32 product on any device."""
    u = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32).view(torch.float32)


def _merge(run_s, run_i, s, i, width):
    """Keep the best ``width`` of the running list and a later block (whose
    rows all come after the running ones): score descending, lower row first."""
    cat_s = torch.cat([run_s, s], dim=1)
    cat_i = torch.cat([run_i, i], dim=1)
    order = torch.sort(cat_s, dim=1, descending=True, stable=True).indices[:, :width]
    return torch.gather(cat_s, 1, order), torch.gather(cat_i, 1, order)


def _best(s: torch.Tensor, r: torch.Tensor, w: int):
    """The best ``w`` columns of ``s`` (their rows ``r``, ascending): score
    descending, lower row first. A top-k with a margin, then a stable order;
    a tie band wider than the margin falls back to a full stable sort."""
    m = min(w + 16, s.shape[1])
    vals, idx = torch.topk(s, m, dim=1)
    edge = vals[:, -1]
    by_col = torch.sort(idx, dim=1).indices
    vals, idx = torch.gather(vals, 1, by_col), torch.gather(idx, 1, by_col)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices[:, :w]
    best_s, best_i = torch.gather(vals, 1, order), torch.gather(idx, 1, order)
    if m < s.shape[1] and bool((best_s[:, -1] == edge).any()):
        order = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :w]
        best_s, best_i = torch.gather(s, 1, order), order
    return best_s, r[best_i]


def _scan(score_block, rows: torch.Tensor, n_queries: int, width: int, block: int, dtype):
    dev = rows.device
    run_s = torch.full((n_queries, 0), float("-inf"), dtype=dtype, device=dev)
    run_i = torch.zeros((n_queries, 0), dtype=torch.long, device=dev)
    for start in range(0, rows.numel(), block):
        r = rows[start : start + block]
        s, i = _best(score_block(r), r, min(width, r.numel()))
        run_s, run_i = _merge(run_s, run_i, s, i, width)
    return run_s, run_i


def exact_topk(unit: torch.Tensor, q: torch.Tensor, rows: torch.Tensor, k: int,
               lower: str | None = None, block: int = 1 << 20):
    """Top ``k`` rows among ``rows`` (ascending ids) by cosine with ``q``."""
    if lower == "tf32":
        qt = tf32(q)
        return _scan(lambda r: qt @ tf32(unit[r]).T, rows, q.shape[0], k, block, torch.float32)
    q64 = q.double()
    return _scan(lambda r: q64 @ unit[r].double().T, rows, q.shape[0], k, block, torch.float64)


def int8_topk(unit: torch.Tensor, q: torch.Tensor, rows: torch.Tensor, k: int, width: int,
              lower: str | None = None, block: int = 1 << 20):
    """The int8 tier: a ``width`` shortlist by quantised scores, re-scored exactly."""
    bits = 4 if lower == "int4" else 8
    q_int, _ = quantize_rows(q.float(), bits)

    def score(r):
        c_int, c_scale = quantize_rows(unit[r], bits)
        return (q_int @ c_int.T) * c_scale.T
    _, short = _scan(score, rows, q.shape[0], width, block, torch.float32)
    return rescore(unit, q, short, k, lower="tf32" if lower else None)


def rescore(unit: torch.Tensor, q: torch.Tensor, ids: torch.Tensor, k: int, lower: str | None = None):
    """Exact scores of the rows ``ids [Q, W]``, the best ``k`` by score then row."""
    if lower == "tf32":
        s = torch.einsum("qd,qwd->qw", tf32(q), tf32(unit[ids]))
    else:
        s = torch.einsum("qd,qwd->qw", q.double(), unit[ids].double())
    by_row = torch.sort(ids, dim=1, stable=True).indices
    ids, s = torch.gather(ids, 1, by_row), torch.gather(s, 1, by_row)
    order = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(s, 1, order), torch.gather(ids, 1, order)


def exact_of(unit: torch.Tensor, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """float64 cosine of each query with its rows ``ids [Q, W]``."""
    return torch.einsum("qd,qwd->qw", q.double(), unit[ids].double())
