"""Tracing / profiling / metrics (SURVEY.md §5 auxiliary subsystems).

The reference has no tracing (only an ad-hoc ``extraction_time`` field); the
rebuild's north-star metric is QPS/latency, so this is first-class here:

- :class:`StageTimer` — nested wall-clock stage timing with context managers.
- :class:`MetricRegistry` — process-wide counters + latency histograms with
  p50/p90/p99 summaries; every engine/service surface can record into it.

- :func:`trace` — a ``torch.profiler`` capture of host and device activity,
  written as a Chrome trace into a directory.
- :func:`device_memory_stats` — live device memory per CUDA card.
- :func:`device_ms` — median CUDA-event time of a call, and :func:`card` —
  the card's name and power limit: the one timer and the one label of every
  device time the bench, the probe script and the chip smoke report.

Counterpart of ``ragfin_tpu/utils/profiling.py``: the timers and the registry
are copies, the two device helpers are over ``torch.profiler`` and
``torch.cuda.memory_stats`` where the JAX package uses ``jax.profiler``;
``device_ms`` stands where ``bench.py`` times a ``lax.scan`` on the device.
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


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (host, and the card when there is
    one) of the enclosed block into ``log_dir/trace.json`` (Chrome trace
    format: chrome://tracing, Perfetto, TensorBoard's profiler plugin)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats() -> list[dict]:
    """Live device memory per CUDA card (empty without one)."""
    import torch

    out = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append(
            {
                "device": f"cuda:{i}",
                "bytes_in_use": stats.get("allocated_bytes.all.current"),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
                "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
            }
        )
    return out


def device_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms: ``runs`` timings, one pair of
    CUDA events around each call, after ``warmup`` untimed calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card() -> str:
    """Name and power limit of the first card, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]
