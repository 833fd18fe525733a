"""Tracing / profiling / metrics (SURVEY.md §5 auxiliary subsystems).

The reference has no tracing (only an ad-hoc ``extraction_time`` field); the
rebuild's north-star metric is QPS/latency, so this is first-class here:

- :class:`StageTimer` — nested wall-clock stage timing with context managers.
- :class:`MetricRegistry` — process-wide counters + latency histograms with
  p50/p90/p99 summaries; every engine/service surface can record into it.

Copy of ``ragfin_tpu/utils/profiling.py`` without its ``jax.profiler``
helpers (``trace``, ``device_memory_stats``); a device trace on the GPU is
``torch.profiler``'s job.
"""

from __future__ import annotations

import contextlib
import statistics
import threading
import time
from collections import defaultdict
from typing import Iterator, Optional


class StageTimer:
    """Nested stage timing: ``with timer.stage("encode"): ...``."""

    def __init__(self):
        self.records: list[tuple[str, float]] = []
        self._stack: list[str] = []

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        self._stack.append(name)
        path = "/".join(self._stack)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.append((path, time.perf_counter() - t0))
            self._stack.pop()

    def summary(self) -> dict[str, dict[str, float]]:
        grouped: dict[str, list[float]] = defaultdict(list)
        for path, dt in self.records:
            grouped[path].append(dt)
        return {
            path: {
                "calls": len(times),
                "total_s": sum(times),
                "mean_ms": statistics.fmean(times) * 1e3,
            }
            for path, times in sorted(grouped.items())
        }


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return sorted_vals[idx]


class MetricRegistry:
    """Thread-safe counters and latency histograms."""

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)
        self._latencies: dict[str, list[float]] = defaultdict(list)
        self._values: dict[str, list[float]] = defaultdict(list)
        self._stamps: dict[str, list[float]] = defaultdict(list)
        self._window = window

    def incr(self, name: str, amount: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += amount

    def observe_latency(self, name: str, seconds: float) -> None:
        with self._lock:
            bucket = self._latencies[name]
            bucket.append(seconds)
            stamps = self._stamps[name]
            stamps.append(time.time())
            if len(bucket) > self._window:
                del bucket[: len(bucket) - self._window]
                del stamps[: len(stamps) - self._window]

    def observe_value(self, name: str, value: float) -> None:
        """Unitless value histogram (batch sizes, queue depths) — kept apart
        from latencies, whose summary scales samples into milliseconds."""
        with self._lock:
            bucket = self._values[name]
            bucket.append(value)
            if len(bucket) > self._window:
                del bucket[: len(bucket) - self._window]

    @contextlib.contextmanager
    def timed(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe_latency(name, time.perf_counter() - t0)
            self.incr(name + ".count")

    def summary(self) -> dict:
        with self._lock:
            out: dict = {"counters": dict(self._counters), "latency_ms": {}}
            for name, vals in self._latencies.items():
                s = sorted(vals)
                out["latency_ms"][name] = {
                    "count": len(s),
                    "p50": _percentile(s, 0.50) * 1e3,
                    "p90": _percentile(s, 0.90) * 1e3,
                    "p99": _percentile(s, 0.99) * 1e3,
                    "mean": statistics.fmean(s) * 1e3 if s else 0.0,
                }
            if self._values:
                out["values"] = {}
                for name, vals in self._values.items():
                    s = sorted(vals)
                    out["values"][name] = {
                        "count": len(s),
                        "p50": _percentile(s, 0.50),
                        "p90": _percentile(s, 0.90),
                        "mean": statistics.fmean(s) if s else 0.0,
                    }
            return out

    def qps(self, name: str, window_s: float = 60.0) -> Optional[float]:
        """Completions per second over the LAST ``window_s`` wall seconds.

        Counts completion timestamps — inverse-mean-latency would understate
        true throughput by the concurrency factor."""
        with self._lock:
            stamps = self._stamps.get(name)
            if not stamps:
                return None
            cutoff = time.time() - window_s
            recent = sum(1 for t in stamps if t >= cutoff)
            if recent == 0:
                return 0.0
            span = min(window_s, max(time.time() - stamps[0], 1e-9))
            return recent / span

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._latencies.clear()
            self._values.clear()
            self._stamps.clear()


METRICS = MetricRegistry()
