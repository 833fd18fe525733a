"""Hybrid vector + graph retrieval with on-device fusion.

Counterpart of ``ragfin_tpu/retrieval/hybrid.py``, with the behaviour of the
reference's ``FinancialHybridRAG.hybrid_query_simple``: run vector search,
run graph strategy search, resolve graph hits back to their source chunks,
and merge: vector results first in score order, graph-only chunks appended
at score 1.0, deduplicated by chunk id. The merge itself runs on the
index's device (:mod:`ragfin_tpu_torch.ops.fusion`). The JAX version pads
both id lists to power-of-two buckets to bound its compiles; the pads only
ever fill empty slots, which are dropped, so they are left out here.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..index.graph_index import GraphIndex
from ..index.vector_index import DeviceVectorIndex
from ..llm.providers import LLMProvider
from ..ops.fusion import fuse_results
from .graph_rag import lexical_question_entities, llm_question_entities, strategy_search
from ..utils.profiling import METRICS

GRAPH_HIT_SCORE = 1.0  # reference assigns graph hits score 1.0 (:316)


class HybridRAG:
    """Vector + graph retrieval over the shared device corpus."""

    def __init__(
        self,
        vector_index: DeviceVectorIndex,
        graph: GraphIndex,
        provider: Optional[LLMProvider] = None,
    ):
        self.vector_index = vector_index
        self.graph = graph
        self.provider = provider

    async def graph_search(self, question: str, limit: int = 30) -> dict[str, Any]:
        """Entity extraction (LLM if available, lexical otherwise) → strategy
        dispatch (graph_cons.py:345-481)."""
        if self.provider is not None:
            entities = await llm_question_entities(question, self.provider)
        else:
            entities = lexical_question_entities(question)
        return strategy_search(self.graph, question, entities, limit=limit)

    async def hybrid_query(
        self, question: str, vector_k: int = 10, k_out: int = 20
    ) -> dict[str, Any]:
        METRICS.incr("hybrid.queries")
        # 1. Vector search over the full corpus (reference used limit=1000 on
        # a 16-chunk collection, i.e. everything; vector_k bounds it here).
        vec_hits = self.vector_index.search_texts([question], top_k=vector_k)[0]
        vec_rows = [self.vector_index._by_id[h.id] for h in vec_hits]

        # 2. Graph search → source chunk ids → corpus rows (reference fetches
        # the graph-hit chunks from Milvus by id, :298-324).
        graph_out = await self.graph_search(question)
        graph_chunk_ids: list[str] = []
        for row in graph_out["results"]:
            cid = row.get("source_chunk")
            if cid and cid in self.vector_index and cid not in graph_chunk_ids:
                graph_chunk_ids.append(cid)
        graph_rows = [self.vector_index._by_id[c] for c in graph_chunk_ids]

        # 3. On-device fusion: vector first, graph-only appended at 1.0.
        device = self.vector_index.device
        vec_arr = torch.tensor([vec_rows], dtype=torch.int32, device=device).reshape(1, -1)
        graph_arr = torch.tensor(graph_rows, dtype=torch.int32, device=device)
        fused, origin = fuse_results(vec_arr, graph_arr, k_out)
        fused, origin = fused[0].tolist(), origin[0].tolist()

        score_by_row = {r: h.score for r, h in zip(vec_rows, vec_hits)}
        merged = []
        for row, org in zip(fused, origin):
            if row < 0:
                continue
            record = self.vector_index.records[int(row)]
            merged.append(
                {
                    "id": record.id,
                    "text": record.text,
                    "period": record.period,
                    "chunk_type": record.chunk_type,
                    "score": score_by_row.get(int(row), GRAPH_HIT_SCORE),
                    "source": "vector" if org == 0 else "graph",
                }
            )
        return {
            "question": question,
            "chunks": merged,
            "vector_hits": len(vec_rows),
            "graph_hits": len(graph_rows),
            "graph_strategy": graph_out["strategy"],
            "graph_entities": graph_out["entities"],
            "graph_results": graph_out["results"],
        }

    # Convenience sync wrapper matching the reference's blocking API.
    def hybrid_query_simple(self, question: str, **kwargs) -> dict[str, Any]:
        import asyncio

        return asyncio.run(self.hybrid_query(question, **kwargs))
