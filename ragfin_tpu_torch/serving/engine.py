"""The single retrieval engine behind every frontend.

Port of ``ragfin_tpu/serving/engine.py``: chunks -> trained embedder ->
:class:`DeviceVectorIndex` (or, with ``index_type="ivf"``, an
:class:`IVFVectorIndex` over it) on the card -> ``VectorRAG``
(FilteredSearch, conflict flags, extractive answers) -> ``QueryBatcher``;
beside it the graph store (:class:`GraphIndex`), its ``GraphBuilder`` and query
engine, and ``HybridRAG`` over both. ``default_model ==
"fake"`` is the offline path: no provider, lexical question entities,
rule-based extraction. Every frontend (REST, MCP, adapters, CLI) wraps the
one engine that :func:`get_engine` keeps for the process.

Unlike the JAX engine, nothing here falls back quietly: a graph store or an
index that fails to load raises, and ``warmup`` lets errors rise. The device
is the argument's, else ``Settings.device`` (``RAGFIN_DEVICE``), else the
card; without a card and without ``cpu`` asked for, construction raises.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from ..config.settings import Settings, get_config
from ..data.loader import build_corpus, load_chunk_snapshot
from ..extraction.service import EntityExtractor, RuleBasedExtractor
from ..index.graph_index import GraphIndex
from ..index.vector_index import DeviceVectorIndex
from ..llm.providers import LLMProvider, ModelFactory
from ..retrieval.graph_rag import GraphBuilder
from ..retrieval.hybrid import HybridRAG
from ..retrieval.vector_rag import VectorRAG
from ..utils.device import DeviceLike, resolve_device

logger = logging.getLogger("ragfin_tpu_torch.engine")


class RagFinEngine:
    """Vector index + graph store + RAG frontends, built from Settings."""

    def __init__(
        self,
        settings: Optional[Settings] = None,
        chunks=None,
        provider: Optional[LLMProvider] = None,
        vector_index: Optional[DeviceVectorIndex] = None,
        device: DeviceLike = None,
    ):
        self.settings = settings or get_config()
        self.device = resolve_device(device if device is not None else self.settings.device)
        self.provider = provider if provider is not None else self._make_provider()
        self.chunks = list(chunks) if chunks is not None else self._load_chunks()
        self.vector_index = (
            vector_index if vector_index is not None else self._build_or_load_index()
        )
        self.graph = self._load_graph()
        if self.provider is not None and self.settings.default_model != "fake":
            # Reuse the engine's provider (one rate-limited client) instead
            # of constructing a second one.
            extractor = EntityExtractor(
                self.settings.default_model,
                self.settings.get_api_key_for_model(self.settings.default_model),
                provider=self.provider,
            )
        else:
            extractor = RuleBasedExtractor()
        self.graph_builder = GraphBuilder(self.graph, extractor=extractor, provider=self.provider)
        self.vector_rag = VectorRAG(
            self.vector_index, self.provider,
            integrity_weight=self.settings.integrity_weight,
        )
        self.hybrid = HybridRAG(self.vector_index, self.graph, self.provider)
        # Default query path: dynamic micro-batching over the retrieval
        # pipeline, so concurrent callers share device searches.
        self.batcher = None
        if self.settings.batch_queries:
            from .batcher import QueryBatcher

            self.batcher = QueryBatcher(self.vector_rag._search_texts).start()
            self.vector_rag.batcher = self.batcher
        logger.info(
            "engine ready: %d chunks indexed (dim=%d, %s) on %s, %d graph facts, provider=%s",
            self.vector_index.n, self.vector_index.dim,
            "int8" if self.vector_index.quantized else str(self.vector_index.dtype),
            self.device, self.graph.stats().get("total_facts", 0),
            getattr(self.provider, "model_name", None) or "offline",
        )

    # --- construction -----------------------------------------------------
    def _make_provider(self) -> Optional[LLMProvider]:
        model = self.settings.default_model
        if model == "fake":
            return None  # offline: deterministic paths only
        return ModelFactory.create_provider(model, self.settings.get_api_key_for_model(model))

    def _load_chunks(self):
        """Snapshot, then ``data_dir``; an empty list (a degraded engine) if
        neither has chunks. The JAX package's last resort, a mount of the
        reference repository at a fixed path, has no counterpart."""
        snapshot = self.settings.chunks_snapshot
        if snapshot and os.path.exists(snapshot):
            return load_chunk_snapshot(snapshot)
        if os.path.isdir(self.settings.data_dir):
            return build_corpus(self.settings.data_dir)
        return []

    def _saved(self, name: str) -> bool:
        index_dir = self.settings.index_dir
        return bool(index_dir) and os.path.exists(os.path.join(index_dir, name))

    def _build_or_load_index(self):
        if self._saved("ivf.json"):
            from ..index.ivf_index import IVFVectorIndex

            index = IVFVectorIndex.load(self.settings.index_dir, device=self.device)
            # ivf.json records no trained embedder; queries are encoded with
            # the one the settings name (the JAX engine leaves a loaded IVF
            # index without a text encoder).
            index.embedder = self._make_embedder()
            return index
        if self._saved("index.json"):
            return DeviceVectorIndex.load(self.settings.index_dir, device=self.device)
        dense = DeviceVectorIndex.build(
            self.chunks,
            embedder=self._make_embedder(),
            batch_size=1024,
            dtype=self.settings.index_dtype,
            device=self.device,
        )
        if self.settings.index_type == "ivf":
            # The reference's actual index type (Milvus IVF_FLAT): cluster
            # the built matrix; metadata-filtered search stays on the exact
            # tier, so VectorRAG drops to raw (unfiltered) search here.
            from ..index.ivf_index import IVFVectorIndex

            return IVFVectorIndex.from_dense(dense, nprobe=self.settings.ivf_nprobe)
        if self.settings.index_type != "flat":
            raise ValueError(f"unknown index_type '{self.settings.index_type}'")
        return dense

    def _make_embedder(self):
        from ..models.embedder import make_embedder

        return make_embedder(
            self.settings.embed_backend,
            checkpoint=self.settings.trained_checkpoint,
            device=self.device,
        )

    def _load_graph(self) -> GraphIndex:
        graph_dir = os.path.join(self.settings.index_dir or "", "graph")
        if self.settings.index_dir and os.path.exists(os.path.join(graph_dir, "graph.json")):
            return GraphIndex.load(graph_dir, device=self.device)
        return GraphIndex(device=self.device)

    def persist(self) -> None:
        """Save the vector index under ``index_dir`` and the graph store
        under ``index_dir/graph``; a later engine with the same settings
        loads both and needs no chunks."""
        if self.settings.index_dir:
            self.vector_index.save(self.settings.index_dir)
            self.graph.save(os.path.join(self.settings.index_dir, "graph"))

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
        if self.settings.integrity_weight > 0 and hasattr(self.vector_index, "integrity_column"):
            # The per-chunk consistency pass is host work over every chunk:
            # it belongs to startup, not to the first weighted query. Unlike
            # the JAX engine, a failure here is raised, not passed over.
            self.vector_index.integrity_column()
        if self.graph.stats().get("total_facts", 0) and self.graph.entities:
            self.graph.match(
                quarters=self.graph.quarters[:1],
                names=self.graph.entities[:1],
                limit=1,
            )

    def close(self) -> None:
        """Stop the batcher's collector thread (it keeps the index reachable)."""
        if self.batcher is not None:
            self.batcher.stop()
            self.batcher = None
            self.vector_rag.batcher = None

    def health(self) -> dict:
        issues = self.settings.validate()
        integrity_active = bool(
            self.settings.integrity_weight > 0
            and getattr(self.vector_rag, "_searcher", None) is not None
        )
        if self.settings.integrity_weight > 0 and not integrity_active:
            # Runtime truth beats the static validate() heuristic: the
            # served index determines whether FilteredSearch (and thus the
            # tamper defense) is actually live.
            issues = issues + [
                "integrity_weight configured but INACTIVE at runtime "
                "(served index has no FilteredSearch pipeline)"
            ]
        return {
            "status": "healthy" if self.vector_index.n > 0 else "degraded",
            "vector_index": {
                "entities": self.vector_index.n,
                "dim": self.vector_index.dim,
                "dtype": "int8" if self.vector_index.quantized
                else str(self.vector_index.dtype).replace("torch.", ""),
                "device": str(self.vector_index.device),
            },
            "graph": {"facts": self.graph.stats().get("total_facts", 0)},
            "provider": getattr(self.provider, "model_name", None) or "offline",
            "extraction_model": self.graph_builder.current_model,
            "integrity_weight": self.settings.integrity_weight,
            # Whether the configured weight is live: it applies only through
            # the FilteredSearch pipeline (not with index_type=ivf).
            "integrity_active": integrity_active,
            "config_issues": issues,
        }


_engine: Optional[RagFinEngine] = None


def get_engine(**kwargs) -> RagFinEngine:
    """Process-wide engine singleton."""
    global _engine
    if _engine is None:
        _engine = RagFinEngine(**kwargs)
    return _engine


def reset_engine() -> None:
    global _engine
    if _engine is not None:
        _engine.close()
    _engine = None
