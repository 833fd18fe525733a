"""On-device hybrid score fusion.

Counterpart of ``ragfin_tpu/ops/fusion.py``: the merge of vector top-k
results with graph-matched chunk rows, with the reference's host-side merge
semantics (``FinancialHybridRAG.hybrid_query_simple``): vector results first
in score order, then graph-only hits (graph hits carry score 1.0),
deduplicated by chunk id. One priority ranking over both blocks, so the
merge runs on the device next to the search kernels. The JAX version ranks
with ``lax.top_k``; here a stable descending sort of the same priorities
gives the same output.
"""

from __future__ import annotations

import torch

_VEC_BASE = 1.0e6  # vector block outranks graph block (reference: vector first)
_GRAPH_BASE = 1.0e3
_NEG_INF = float("-inf")


def fuse_results(
    vec_ids: torch.Tensor,  # [Q, Kv] int32 corpus rows (may include -1 padding)
    graph_rows: torch.Tensor,  # [G] int32 corpus rows of graph hits (-1 padding)
    k_out: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (fused_rows [Q, k] int32, origin [Q, k] int32) with
    ``k = min(k_out, Kv + G)``.

    origin: 0 = vector hit, 1 = graph-only hit, -1 = empty slot.
    Order: all valid vector hits (original order), then graph hits not
    already present and not repeating an earlier graph hit (graph order).
    """
    q, kv = vec_ids.shape
    g = graph_rows.shape[0]
    dev = vec_ids.device

    vec_valid = vec_ids >= 0
    vec_priority = torch.where(
        vec_valid, _VEC_BASE - torch.arange(kv, dtype=torch.float32, device=dev)[None, :], _NEG_INF
    )  # [Q, Kv]

    graph_b = graph_rows[None, :].expand(q, g)
    dup = ((vec_ids[:, :, None] == graph_b[:, None, :]) & vec_valid[:, :, None]).any(dim=1)  # [Q, G]
    same = graph_rows[None, :] == graph_rows[:, None]  # [G, G]
    earlier = torch.tril(same, diagonal=-1).any(dim=1)  # row repeats an earlier one
    graph_valid = (graph_b >= 0) & ~dup & ~earlier[None, :]
    graph_priority = torch.where(
        graph_valid, _GRAPH_BASE - torch.arange(g, dtype=torch.float32, device=dev)[None, :], _NEG_INF
    )

    all_ids = torch.cat([vec_ids, graph_b], dim=1)
    all_priority = torch.cat([vec_priority, graph_priority], dim=1)
    all_origin = torch.cat(
        [
            torch.zeros((q, kv), dtype=torch.int32, device=dev),
            torch.ones((q, g), dtype=torch.int32, device=dev),
        ],
        dim=1,
    )

    k = min(k_out, all_ids.shape[1])
    top_p, sel = torch.sort(all_priority, dim=1, descending=True, stable=True)
    top_p, sel = top_p[:, :k], sel[:, :k]
    fused = torch.gather(all_ids, 1, sel)
    origin = torch.gather(all_origin, 1, sel)
    empty = ~torch.isfinite(top_p)
    return fused.masked_fill(empty, -1), origin.masked_fill(empty, -1)
