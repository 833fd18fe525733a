"""The retrieval engine, vector half.

Port of ``ragfin_tpu/serving/engine.py`` for the vector-RAG path: chunks ->
trained embedder -> :class:`DeviceVectorIndex` on the card -> ``VectorRAG``
(FilteredSearch, conflict flags, extractive answers) -> ``QueryBatcher``.
The graph store, hybrid search, extraction and LLM providers are later
slices (ROADMAP Slices 2 and 4); ``provider=None`` is the offline path.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..config.settings import Settings, get_config
from ..index.vector_index import DeviceVectorIndex
from ..retrieval.vector_rag import VectorRAG
from ..utils.device import DeviceLike, resolve_device

logger = logging.getLogger("ragfin_tpu_torch.engine")


class RagFinEngine:
    """Vector index + VectorRAG + micro-batcher, built from Settings."""

    def __init__(
        self,
        settings: Optional[Settings] = None,
        chunks=None,
        provider=None,
        vector_index: Optional[DeviceVectorIndex] = None,
        device: DeviceLike = None,
    ):
        self.settings = settings or get_config()
        self.device = resolve_device(device)
        self.provider = provider
        if chunks is None and vector_index is None:
            raise NotImplementedError(
                "loading chunks from data_dir/snapshots is not ported yet "
                "(ROADMAP Slice 4): pass chunks or a vector_index"
            )
        self.chunks = list(chunks) if chunks is not None else []
        self.vector_index = (
            vector_index if vector_index is not None else self._build_index()
        )
        self.vector_rag = VectorRAG(
            self.vector_index, self.provider,
            integrity_weight=self.settings.integrity_weight,
        )
        # Default query path: dynamic micro-batching over the retrieval
        # pipeline, so concurrent callers share device searches.
        self.batcher = None
        if self.settings.batch_queries:
            from .batcher import QueryBatcher

            self.batcher = QueryBatcher(self.vector_rag._search_texts).start()
            self.vector_rag.batcher = self.batcher
        logger.info(
            "engine ready: %d chunks indexed (dim=%d, %s) on %s, provider=%s",
            self.vector_index.n, self.vector_index.dim,
            "int8" if self.vector_index.quantized else str(self.vector_index.dtype),
            self.device, getattr(self.provider, "model_name", None) or "offline",
        )

    def _build_index(self) -> DeviceVectorIndex:
        if self.settings.index_type != "flat":
            raise NotImplementedError("the IVF index is not ported yet (ROADMAP Slice 3)")
        from ..models.embedder import make_embedder

        embedder = make_embedder(
            self.settings.embed_backend,
            checkpoint=self.settings.trained_checkpoint,
            device=self.device,
        )
        return DeviceVectorIndex.build(
            self.chunks,
            embedder=embedder,
            batch_size=1024,
            dtype=self.settings.index_dtype,
            device=self.device,
        )

    def warmup(self) -> None:
        """Run the serving shapes once (top-k widths, tier-group plans, Q and
        sequence buckets), so first queries pay no one-time costs (kernel
        build and load, cuBLAS handles, allocator growth)."""
        if self.vector_index.n == 0:
            return
        detect_k = self.vector_rag._detection_fetch(self.settings.default_top_k)
        for top_k in (1, self.settings.default_top_k, 10, detect_k):
            self.vector_index.search_texts(["warmup query"], top_k=top_k)
        searcher = getattr(self.vector_rag, "_searcher", None)
        if searcher is not None:
            period = self.vector_index.records[0].period.replace("_", " ")
            for q in (f"warmup net profit in {period}", "warmup query"):
                for reps in (1, 8, 64):
                    searcher.search_texts([q] * reps, top_k=detect_k)
        embedder = getattr(self.vector_index, "embedder", None)
        if embedder is not None and hasattr(embedder, "tokenizer"):
            max_len = getattr(embedder.tokenizer, "max_len", 192) or 192
            for text in ("warmup " * 96, "warmup " * max_len):
                for reps in (1, 8, 64):
                    embedder.encode_texts([text] * reps)

    def close(self) -> None:
        """Stop the batcher's collector thread (it keeps the index reachable)."""
        if self.batcher is not None:
            self.batcher.stop()
            self.batcher = None
            self.vector_rag.batcher = None

    def health(self) -> dict:
        issues = self.settings.validate()
        return {
            "status": "healthy" if self.vector_index.n > 0 else "degraded",
            "vector_index": {
                "entities": self.vector_index.n,
                "dim": self.vector_index.dim,
                "dtype": "int8" if self.vector_index.quantized
                else str(self.vector_index.dtype).replace("torch.", ""),
                "device": str(self.vector_index.device),
            },
            "provider": getattr(self.provider, "model_name", None) or "offline",
            "integrity_weight": self.settings.integrity_weight,
            "config_issues": issues,
        }
