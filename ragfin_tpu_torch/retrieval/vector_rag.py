"""Vector RAG: search + answer generation (C6).

Port of ``ragfin_tpu/retrieval/vector_rag.py`` onto the port's
DeviceVectorIndex; the logic is the JAX package's, line for line.

Behavioral parity with the reference's ``SimpleRAG`` (``retrieve.py:7-82``)
and ``VectorRAG`` (``vector_rag_mcp/main.py:48-108``): encode the question,
exact cosine top-k over the device index, assemble numbered contexts, prompt
an LLM for a grounded answer (exact numbers + period). Without a provider the
answer path degrades to a deterministic extractive answer built from the
top-ranked chunk (flagged ``extractive``) so the full pipeline works offline.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

from ..index.vector_index import DeviceVectorIndex, SearchHit

# Any object with ``async generate_content(prompt) -> str`` (the JAX
# package's llm.providers protocol); providers are ported with Slice 4.
LLMProvider = Any


def build_answer_prompt(question: str, contexts: Sequence[str]) -> str:
    """Grounded-answer prompt (same instruction semantics as retrieve.py:52-65)."""
    numbered = "\n\n".join(f"Context {i + 1}: {ctx}" for i, ctx in enumerate(contexts))
    return (
        "Answer the question using only the ICICI Bank financial data below.\n\n"
        f"QUESTION: {question}\n\n"
        f"CONTEXT:\n{numbered}\n\n"
        "Requirements:\n"
        "- Quote exact figures from the context, keeping decimals and units.\n"
        "- Name the quarter/period the figure belongs to.\n"
        "- If the context does not contain the answer, say so explicitly.\n"
        "- Be concise and factual.\n\n"
        "ANSWER:"
    )


class VectorRAG:
    """Search + answer over a DeviceVectorIndex."""

    def __init__(
        self,
        index: DeviceVectorIndex,
        provider: Optional[LLMProvider] = None,
        smart_retrieval: bool = True,
        integrity_weight: Optional[float] = None,
        conflict_detection: bool = True,
        detection_fetch_k: int = 32,
    ):
        self.index = index
        self.provider = provider
        self._analyst = None
        # Production retrieval pipeline: query filters + scoped device search
        # (retrieval/queryfilter.py). Semantic (featurizer-less) backends run
        # it too — scoping is metadata-driven, the sparse exact re-rank
        # simply no-ops without a featurizer. (Round-4 fix: the old
        # featurizer gate silently dropped trained-backend serving to raw
        # search — measured recall@10 0.10 raw vs 1.000 through the
        # pipeline at 20k distractors, eval_results/trained_eval_20000.json.)
        self._searcher = None
        if smart_retrieval and getattr(index, "supports_filters", False):
            from .queryfilter import FilteredSearch

            if integrity_weight is None:
                # Standalone construction: fall back to the env config. The
                # engine passes ITS settings explicitly so a programmatic
                # Settings(integrity_weight=...) is honored even when the
                # env var is unset.
                from ..config.settings import get_config

                integrity_weight = get_config().integrity_weight
            self._searcher = FilteredSearch(
                index, consistency_weight=integrity_weight
            )
        # Optional dynamic micro-batcher (serving/batcher.py); attached by
        # the engine so concurrent single-query callers share device
        # dispatches. Single-query entry points route through it when set.
        self.batcher = None
        # Conflict detection (retrieval/conflict.py): flag shortlists whose
        # scoped candidates carry mutually-contradictory figure sets — the
        # observable that scale-consistent tampering and fabrication cannot
        # avoid. Annotation only changes metadata + the abstention decision,
        # never ranking. Cache keyed by immutable chunk id.
        #
        # Detection runs over a WIDENED shortlist (``detection_fetch_k``,
        # independent of the user's top_k — round-4 verdict #4): at top_k=3
        # the forged and authentic members of one scope rarely co-occur in
        # the returned slice, so the top-hit flag rate trailed the any-scope
        # rate by ~0.15 (0.75 vs 0.90 scaled, 0.825 vs 0.975 fabrication at
        # 1M). The contradiction is in the corpus either way; fetching 32
        # candidates for detection (results still trim to top_k) lets the
        # detector see it whenever it is visible at all.
        self.conflict_detection = conflict_detection
        self.detection_fetch_k = detection_fetch_k
        self._figure_cache: dict = {}

    def _search_texts(self, queries, top_k: int):
        if self._searcher is not None:
            return self._searcher.search_texts(queries, top_k=top_k)
        return self.index.search_texts(queries, top_k=top_k)

    def _search_one(self, query: str, top_k: int):
        if self.batcher is not None:
            try:
                return self.batcher.search(query, top_k=top_k)
            except TimeoutError:
                # A batch that outlasts the batcher's wait (a first kernel
                # build, say): a slow direct answer beats a dead query.
                pass
        return self._search_texts([query], top_k)[0]

    @property
    def analyst(self):
        from .analytical import AnalyticalAnswerer

        if self._analyst is None:
            self._analyst = AnalyticalAnswerer(self.index.records)
        return self._analyst

    def _detection_fetch(self, top_k: int) -> int:
        """Shortlist width fetched from the index: the user's top_k, widened
        to the detection window when conflict detection is on."""
        if not self.conflict_detection:
            return top_k
        return max(top_k, self.detection_fetch_k)

    def _annotate_conflicts(self, hits, returned=None) -> list[tuple]:
        """Detect contested scopes over ``hits`` (the WIDE detection list)
        and mark members of ``returned`` (default: ``hits``) whose scope is
        contested. Returns the contested scopes present among the returned
        hits (empty when detection is off or nothing conflicts)."""
        if not self.conflict_detection or not hits:
            return []
        from .conflict import detect_conflicts

        if returned is None:
            returned = hits
        scopes = detect_conflicts(hits, cache=self._figure_cache)
        contested_set = {key for key, info in scopes.items() if info["conflict"]}
        if not contested_set:
            return []
        present = []
        for h in returned:
            rec = h.record
            key = (rec.company, rec.period, rec.chunk_type)
            if key in contested_set:
                h.conflict = True
                if key not in present:
                    present.append(key)
        return present

    # --- search (MCP tool `search_vectors` contract) ----------------------
    def search(self, query: str, top_k: int = 3) -> list[dict[str, Any]]:
        wide = self._search_one(query, self._detection_fetch(top_k))
        hits = wide[:top_k]
        self._annotate_conflicts(wide, returned=hits)
        return [h.to_dict() for h in hits]

    def search_batch(self, queries: Sequence[str], top_k: int = 3) -> list[list[SearchHit]]:
        return self._search_texts(list(queries), top_k=top_k)

    # --- answer (MCP tool `answer_question` contract) ---------------------
    async def search_and_answer(self, question: str, top_k: int = 3) -> dict[str, Any]:
        import asyncio

        # The batcher wait (and a cold direct search) BLOCKS — on the
        # shared MCP tool loop that would serialize concurrent
        # answer_question calls (defeating the micro-batcher, which
        # exists to coalesce them) and stall every other async tool
        # behind a single degraded-tunnel query. Run it off-loop.
        wide = await asyncio.to_thread(
            self._search_one, question, self._detection_fetch(top_k)
        )
        hits = wide[:top_k]
        contested = self._annotate_conflicts(wide, returned=hits)
        contexts = [h.record.text for h in hits]
        result = {
            "question": question,
            "contexts": [h.to_dict(include_text=True) for h in hits],
            "num_contexts": len(hits),
        }
        if contested:
            result["conflict"] = True
            result["conflicted_scopes"] = [
                {"company": c, "period": p, "chunk_type": t} for c, p, t in contested
            ]
        if hits and hits[0].conflict and self.provider is None:
            # The top-ranked evidence sits in a contested bucket: the corpus
            # holds mutually-contradictory figure sets for that exact scope,
            # and no ranking can certify the authentic one (see
            # retrieval/conflict.py). Abstain instead of confidently serving
            # a possible forgery — the honest production behavior the
            # reference's trust-the-store fusion lacks (graph_cons.py:268).
            scope = contested[0]
            result.update(
                answer=(
                    "Cannot answer reliably: the indexed corpus contains "
                    f"conflicting figure sets for {scope[0]} {scope[1]} "
                    f"({scope[2]}). The retrieved candidates disagree on "
                    "overlapping line items beyond tolerance, which indicates "
                    "tampered or fabricated data for this scope. Resolve "
                    "provenance before trusting any figure from it."
                ),
                answer_mode="conflict",
            )
            return result
        if self.provider is not None:
            try:
                answer = await self.provider.generate_content(
                    build_answer_prompt(question, contexts)
                )
                result.update(answer=answer.strip(), answer_mode="llm")
                return result
            except Exception as e:  # reference returns the error string
                result.update(answer=f"Error generating answer: {e}", answer_mode="error")
                return result
        answer, extra_ids = self._extractive_answer(question, hits)
        if extra_ids:
            # Chunks the analytical answerer consumed beyond the initial
            # retrieval (e.g. the other quarters of a trend question) are
            # follow-up retrievals — surface them as contexts so grounding
            # metrics see the full evidence set.
            seen = {h.record.id for h in hits}
            for rec in self.index.get_by_ids(extra_ids):
                if rec.id not in seen:
                    seen.add(rec.id)
                    result["contexts"].append(
                        {"id": rec.id, "score": 1.0, "period": rec.period,
                         "chunk_type": rec.chunk_type, "text": rec.text}
                    )
            result["num_contexts"] = len(result["contexts"])
        result.update(answer=answer, answer_mode="extractive")
        return result

    def _extractive_answer(self, question: str, hits: Sequence[SearchHit]):
        """Deterministic offline answer: analytical (parsed figures + the
        cross-quarter arithmetic the reference delegates to Gemini) when the
        question matches the financial vocabulary, else the top chunks
        verbatim."""
        analytical = self.analyst.answer(question)
        if analytical is not None:
            return analytical
        if not hits:
            return "No relevant context found.", []
        top = hits[0].record
        rest = " ".join(h.record.text for h in hits[1:])
        text = f"[{top.period} – {top.chunk_type}] {top.text}"
        return (text + ("\n\n" + rest if rest else ""), [])

    def stats(self) -> dict:
        return self.index.stats()
