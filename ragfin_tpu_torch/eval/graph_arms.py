"""Labeled quality arms for the graph and hybrid retrieval paths.

``strategy_search``, ``GraphQueryEngine`` and ``HybridRAG`` are measured for
answer-relevant retrieval quality the way the vector path is: these adapters
route the
labeled QA datasets (``qa_subset.json`` expected_relevant_chunks) through
each path with the standard :func:`ragfin_tpu_torch.eval.harness.evaluate_retrieval`
scoring surface, mapping graph fact rows back to their ``source_chunk`` ids
(the reference's fusion does exactly this before fetching from Milvus,
``graph_cons.py:298-324``).

The graph is bootstrapped from the REAL corpus records (the reference builds
its KG from its 16-chunk Milvus dump, ``graph_cons.py:34-53``); optional
noise chunks exercise multi-company fact scoping.
"""

from __future__ import annotations

import asyncio
from collections import Counter
from typing import Any, Optional, Sequence


class _IdHit:
    """Minimal SearchHit-like wrapper (harness only reads ``.id``)."""

    __slots__ = ("id", "score")

    def __init__(self, chunk_id: str, score: float = 1.0):
        self.id = chunk_id
        self.score = score


def _dedup_source_chunks(rows: Sequence[dict]) -> list[str]:
    out: list[str] = []
    for row in rows:
        cid = row.get("source_chunk")
        if cid and cid not in out:
            out.append(cid)
    return out


class GraphStrategySearcher:
    """qa questions → lexical entities → 6-branch strategy dispatch →
    source-chunk ids (C12 quality arm). Tracks the dispatch distribution."""

    def __init__(self, graph):
        self.graph = graph
        self.strategy_counts: Counter = Counter()

    def search_texts(self, queries, top_k: int = 10, method: str = "auto"):
        from ..retrieval.graph_rag import lexical_question_entities, strategy_search

        out = []
        for q in queries:
            d = strategy_search(
                self.graph, q, lexical_question_entities(q), limit=max(top_k * 3, 30)
            )
            self.strategy_counts[d["strategy"]] += 1
            out.append([_IdHit(c) for c in _dedup_source_chunks(d["results"])[:top_k]])
        return out


class GraphEngineSearcher:
    """qa questions → GraphQueryEngine (plan execution with deterministic
    fallbacks; FakeProvider-compatible) → source-chunk ids (C11 quality arm)."""

    def __init__(self, graph, provider=None):
        from ..retrieval.graph_rag import GraphQueryEngine

        self.engine = GraphQueryEngine(graph, provider)
        self.fallbacks = 0

    def search_texts(self, queries, top_k: int = 10, method: str = "auto"):
        out = []
        for q in queries:
            res = asyncio.run(self.engine.query(q, limit=max(top_k * 3, 30)))
            if res.get("fallback"):
                self.fallbacks += 1
            out.append([_IdHit(c) for c in _dedup_source_chunks(res["results"])[:top_k]])
        return out


class HybridSearcher:
    """qa questions → HybridRAG vector+graph fusion → fused chunk ids (C14/T4
    quality arm). ``vector_searcher`` (e.g. FilteredSearch) optionally
    replaces the raw index for the vector leg so the arm measures what graph
    fusion adds ON TOP of the production pipeline, not just on top of raw
    similarity."""

    def __init__(self, hybrid, vector_searcher=None):
        self.hybrid = hybrid
        self.vector_searcher = vector_searcher
        self.graph_contributed = 0  # queries where a graph-only chunk surfaced

    def search_texts(self, queries, top_k: int = 10, method: str = "auto"):
        out = []
        for q in queries:
            if self.vector_searcher is None:
                res = asyncio.run(self.hybrid.hybrid_query(q, vector_k=top_k, k_out=top_k))
                chunks = res["chunks"]
                hits = [_IdHit(c["id"], c["score"]) for c in chunks[:top_k]]
                if any(c["source"] == "graph" for c in chunks[:top_k]):
                    self.graph_contributed += 1
            else:
                hits = self._pipeline_fused(q, top_k)
            out.append(hits)
        return out

    def _pipeline_fused(self, question: str, top_k: int) -> list:
        """Reference fusion semantics (vector first in score order, graph-only
        appended at 1.0, dedup by id — graph_cons.py:326-342) with the
        production FilteredSearch as the vector leg."""
        vec_hits = self.vector_searcher.search_texts([question], top_k=top_k)[0]
        graph_out = asyncio.run(self.hybrid.graph_search(question))
        graph_ids = _dedup_source_chunks(graph_out["results"])
        seen = []
        fused: list[_IdHit] = []
        for h in vec_hits:
            if h.id not in seen:
                seen.append(h.id)
                fused.append(_IdHit(h.id, getattr(h, "score", 1.0)))
        contributed = False
        for cid in graph_ids:
            if cid not in seen:
                seen.append(cid)
                fused.append(_IdHit(cid, 1.0))
                contributed = True
        if contributed and any(h.id in graph_ids for h in fused[:top_k]):
            self.graph_contributed += 1
        return fused[:top_k]


def graph_hybrid_arms(
    idx,
    real_chunks,
    qa,
    vector_searcher=None,
    noise_chunks: Optional[Sequence] = None,
    ks: Sequence[int] = (3, 10),
) -> dict[str, Any]:
    """Run the graph / engine / hybrid quality arms and return artifact-ready
    summaries. ``idx`` is the (distractor-scale) vector index; the graph is
    built from ``real_chunks`` (+ ``noise_chunks`` for multi-company fact
    noise, company-scoped per record)."""
    from .harness import evaluate_retrieval
    from ..index.graph_index import GraphIndex
    from ..retrieval.graph_rag import GraphBuilder
    from ..retrieval.hybrid import HybridRAG

    # The graph store lives where the vector index does.
    builder = GraphBuilder(GraphIndex(device=idx.device))
    feed = list(real_chunks) + list(noise_chunks or [])
    build = asyncio.run(
        builder.build(
            [r.to_financial_chunk() for r in feed],
            companies=[getattr(r, "company", None) for r in feed],
        )
    )
    graph = builder.graph

    out: dict[str, Any] = {
        "graph_build": {
            "chunks_processed": build["chunks_processed"],
            "chunks_failed": build["chunks_failed"],
            "facts": build["total_entities_created"],
            "noise_chunks": len(noise_chunks or []),
        }
    }

    hybrid = HybridRAG(idx, graph)
    for k in ks:
        # Fresh searchers per k so dispatch/contribution counters stay
        # one-pass-over-qa; the (identical) distribution from the last k is
        # the one recorded.
        strat = GraphStrategySearcher(graph)
        engine = GraphEngineSearcher(graph)
        hyb_raw = HybridSearcher(hybrid)
        hyb_pipe = (
            HybridSearcher(hybrid, vector_searcher=vector_searcher)
            if vector_searcher
            else None
        )
        out[f"graph_strategy_k{k}"] = evaluate_retrieval(strat, qa, k=k).summary()
        out[f"graph_engine_k{k}"] = evaluate_retrieval(engine, qa, k=k).summary()
        out[f"hybrid_raw_k{k}"] = evaluate_retrieval(hyb_raw, qa, k=k).summary()
        if hyb_pipe is not None:
            out[f"hybrid_pipeline_k{k}"] = evaluate_retrieval(hyb_pipe, qa, k=k).summary()
        out["graph_strategy_dispatch"] = dict(strat.strategy_counts)
        out["graph_engine_fallbacks"] = engine.fallbacks
        out["hybrid_graph_contributed_queries"] = {
            "raw": hyb_raw.graph_contributed,
            **({"pipeline": hyb_pipe.graph_contributed} if hyb_pipe else {}),
        }
    return out
