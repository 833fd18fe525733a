"""The system under test, built from a configuration, and the probes around it.

It builds the deployment a configuration names, with the corpus and weights
the benchmark made (seeded weights under the program's parameter names, which
``lib/states/<model_type>.py`` gives for the configuration's architecture),
and wraps three of its methods on the instances it built: the embedder's
``encode_texts`` and the index's ``search_texts`` / ``search_texts_tiers``.
The wrappers time each call on the host clock, count index dispatches, mark
the spans for the profiler in a traced run, and keep the query vectors of the
calls the check compares.

It is one of the two modules of the benchmark that import the program
(``ragfin_tpu_torch``); the other is ``lib/spans.py``, which reads the
program's own spans for the per-layer readers.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from . import spec


class CallStats:
    """What the probes saw during one timed call."""

    __slots__ = ("encode_s", "index_s", "dispatches", "encoded", "captured")

    def __init__(self, capture: bool):
        self.encode_s = 0.0
        self.index_s = 0.0
        self.dispatches = 0
        self.encoded: list = []  # the text lists handed to the encoder
        self.captured = [] if capture else None  # (texts, query vectors)


class Probes:
    def __init__(self):
        self.local = threading.local()
        self.tracing = False

    def begin(self, stats: CallStats | None) -> None:
        self.local.stats = stats
        self.local.depth = 0

    def _span(self, name):
        if self.tracing:
            return torch.profiler.record_function(name)
        return None

    def wrap_encoder(self, embedder) -> None:
        inner = embedder.encode_texts
        local = self.local

        def encode_texts(texts):
            stats = getattr(local, "stats", None)
            span = self._span("bench.encode")
            t0 = time.perf_counter()
            if span is None:
                out = inner(texts)
            else:
                with span:
                    out = inner(texts)
            dt = time.perf_counter() - t0
            if stats is not None:
                stats.encode_s += dt
                stats.encoded.append(texts)
                if stats.captured is not None:
                    stats.captured.append((list(texts), np.array(out, np.float32, copy=True)))
            return out

        embedder.encode_texts = encode_texts

    def wrap_index(self, index) -> None:
        for name in ("search_texts", "search_texts_tiers"):
            setattr(index, name, self._index_method(getattr(index, name)))

    def _index_method(self, inner):
        local = self.local

        def method(*args, **kwargs):
            if getattr(local, "depth", 0):
                return inner(*args, **kwargs)
            stats = getattr(local, "stats", None)
            enc0 = stats.encode_s if stats is not None else 0.0
            local.depth = 1
            span = self._span("bench.index")
            t0 = time.perf_counter()
            try:
                if span is None:
                    out = inner(*args, **kwargs)
                else:
                    with span:
                        out = inner(*args, **kwargs)
            finally:
                local.depth = 0
            dt = time.perf_counter() - t0
            if stats is not None:
                stats.index_s += dt - (stats.encode_s - enc0)
                stats.dispatches += 1
            return out

        return method


class System:
    """The deployment of one configuration: embedder, index, entry point."""

    def __init__(self, config: dict, root: str, records: list, vectors: torch.Tensor,
                 weights: dict | None, entry: str, device):
        from ragfin_tpu_torch.config.settings import Settings
        from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex
        from ragfin_tpu_torch.models.embedder import make_embedder
        from ragfin_tpu_torch.retrieval.vector_rag import VectorRAG

        dep = config["deployment"]
        self.settings = Settings(device=str(device), **dep["settings"])
        backend = self.settings.embed_backend
        checkpoint = os.path.join(root, dep["checkpoint"]) if dep.get("checkpoint") else None
        self.embedder = make_embedder(backend, checkpoint=checkpoint, device=device,
                                      **dep.get("embedder", {}))
        if weights is not None:
            self.embedder.model.load_state_dict(spec.states(config).program_state(weights))
        self.index = DeviceVectorIndex(vectors, records, dtype=self.settings.index_dtype,
                                       device=device, **dep.get("index", {}))
        self.index.embedder = self.embedder
        self.probes = Probes()
        self.probes.wrap_encoder(self.embedder)
        self.probes.wrap_index(self.index)
        if entry == "rag.search_batch":
            self.rag = VectorRAG(self.index, None, integrity_weight=self.settings.integrity_weight)
            self.entry = self.rag.search_batch
        elif entry == "index.search_texts":
            self.entry = self.index.search_texts
        else:
            raise ValueError(f"unknown entry {entry!r}")

    @staticmethod
    def record_class():
        """The program's chunk record type, which the corpus's records are."""
        from ragfin_tpu_torch.data.models import IndexedChunk

        return IndexedChunk

    def kernel_launches(self) -> dict:
        """The program's own launch counters of its hand-written top-k kernels."""
        from ragfin_tpu_torch.ops import topk

        return {"fused_f32": topk.cosine_topk_fused.launches,
                "fused_int8": topk.cosine_topk_fused_int8.launches}

    def mask_cache_sizes(self) -> tuple[int, int]:
        """Entries in the index's host and device row-mask caches: set-up
        warms every key the mix uses, so the window should add none."""
        return (len(getattr(self.index, "_host_mask_cache", {})),
                len(getattr(self.index, "_device_mask_cache", {})))

    def close(self) -> None:
        """Drop the deployment. The wrappers sit in the instances' own
        dicts and refer back to them; they are taken out first, so that
        reference counting frees the index (set-up's objects are frozen and
        no collection would)."""
        for obj, names in ((getattr(self, "index", None), ("search_texts", "search_texts_tiers")),
                           (getattr(self, "embedder", None), ("encode_texts",))):
            for name in names:
                if obj is not None:
                    vars(obj).pop(name, None)
        for name in ("entry", "rag", "index", "embedder", "probes"):
            if hasattr(self, name):
                delattr(self, name)
