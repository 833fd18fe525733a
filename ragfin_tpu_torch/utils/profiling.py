"""Tracing / profiling / metrics (SURVEY.md §5 auxiliary subsystems).

The reference has no tracing (only an ad-hoc ``extraction_time`` field); the
rebuild's north-star metric is QPS/latency, so this is first-class here:

- :class:`MetricRegistry` (``METRICS``) — process-wide counters, latency and
  value histograms with p50/p90/p99 summaries, and spans: named, nested
  intervals of one thread on the ``time.perf_counter_ns`` clock, each with
  the counts made inside it. The search path opens them (``retrieval.search``,
  ``index.*``, ``encode.*``, ``batcher.dispatch``).
- :func:`trace` — a ``torch.profiler`` capture of host and device activity
  with the program's spans in it, written as a Chrome trace into a directory.
- :func:`device_memory_stats` — live device memory per CUDA card.
- :func:`device_ms` — median CUDA-event time of a call, and :func:`card` —
  the card's name and power limit: the one timer and the one label of every
  device time the bench, the probe script and the chip smoke report.

Spans record only while a ``torch.profiler`` capture runs (:func:`trace`, or
the benchmark's traced window): a span that opens with no other span open on
its thread checks for one, and the spans nested in it follow its choice, so a
capture that starts while a call is in flight records none of that call. In a
capture, each span is also a host range ``ragfin.<name>``, on the profiler's
clock. Off, a span is a thread-local read and a flag test.

Counterpart of ``ragfin_tpu/utils/profiling.py``: the registry's counters and
histograms are its copy, the spans are the port's own; the two device helpers
are over ``torch.profiler`` and ``torch.cuda.memory_stats`` where the JAX
package uses ``jax.profiler``; ``device_ms`` stands where ``bench.py`` times a
``lax.scan`` on the device.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import statistics
import threading
import time
from collections import defaultdict
from typing import Iterator

import torch
import torch.autograd.profiler as _autograd_profiler

# A host-only profiler range. ``torch.profiler.record_function`` would also
# put a ``gpu_user_annotation`` interval over the kernels each span launched
# on the device timeline, which a reader of the capture's device events
# would count as busy time.
_profiler_range = torch._C._profiler._RecordFunctionFast


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return sorted_vals[idx]


class Span:
    """One span: ``name``, ``start_ns`` / ``end_ns`` (``perf_counter_ns``),
    the ``thread`` it ran on, its ``id``, its ``parent``'s id (None for a
    root) and its ``root``'s id (its own for a root), and ``counts``, what
    :meth:`MetricRegistry.count` added while it was the innermost open span
    of its thread."""

    __slots__ = ("name", "start_ns", "end_ns", "thread", "id", "parent", "root", "counts",
                 "_registry", "_stack", "_range")

    def __init__(self, registry, name, stack, parent):
        self.name = name
        self.id = next(registry._ids)
        if parent is None:
            self.parent, self.root, self.thread = None, self.id, threading.get_ident()
        else:
            self.parent, self.root, self.thread = parent.id, parent.root, parent.thread
        self.counts: dict[str, float] = {}
        self.start_ns = self.end_ns = 0
        self._registry = registry
        self._stack = stack
        self._range = _profiler_range("ragfin." + name)

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __enter__(self) -> "Span":
        self._range.__enter__()
        self._stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        self._stack.pop()
        self._range.__exit__(None, None, None)
        self._registry._keep(self)
        self._registry = self._stack = self._range = None
        return False


class _Off:
    """The span that records nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Stack(list):
    """A thread's open spans, innermost last, and ``untraced``: a reentrant
    lock the thread holds, as a flag, while a call that started outside a
    capture runs. It is the span such a call opens, so its spans record
    nothing even once a capture has started, and none of them is taken for
    a call of its own."""

    __slots__ = ("untraced",)

    def __init__(self):
        super().__init__()
        self.untraced = threading.RLock()


class _Open(threading.local):
    """The open spans of each thread."""

    def __init__(self):
        self.stack = _Stack()


class MetricRegistry:
    """Thread-safe counters, latency and value histograms, and spans."""

    span_limit = 1 << 20  # spans kept; past it ``trace.dropped`` counts the rest

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)
        self._latencies: dict[str, list[float]] = defaultdict(list)
        self._values: dict[str, list[float]] = defaultdict(list)
        self._window = window
        self._open = _Open()
        self._ids = itertools.count(1)
        self._spans: list[Span] = []

    # --- spans --------------------------------------------------------------
    def span(self, name: str, nested: bool = True):
        """Context manager for one span of ``name`` on this thread. Its
        parent is the innermost open span of the thread. ``nested=False``
        opens nothing inside an open span of the same name."""
        stack = self._open.stack
        if stack:
            if not nested and any(s.name == name for s in stack):
                return _OFF
            return Span(self, name, stack, stack[-1])
        if not _autograd_profiler._is_profiler_enabled:
            return stack.untraced
        if stack.untraced._is_owned():
            return _OFF
        return Span(self, name, stack, None)

    def spanned(self, name: str, nested: bool = True):
        """Decorator: the whole call is one span of ``name``."""

        def wrap(fn):
            @functools.wraps(fn)
            def inner(*args, **kwargs):
                with self.span(name, nested):
                    return fn(*args, **kwargs)

            return inner

        return wrap

    def _keep(self, span: Span) -> None:
        if len(self._spans) < self.span_limit:
            self._spans.append(span)
        else:
            with self._lock:
                self._counters["trace.dropped"] += 1

    def spans(self) -> list[Span]:
        """The closed spans kept since the last :meth:`reset`, in the order
        they closed (children before their parent)."""
        return list(self._spans)

    # --- counters and histograms ----------------------------------------------
    def count(self, name: str, n: float = 1) -> None:
        """Add ``n`` to the counter ``name``; while a span is open on this
        thread, to the innermost one's ``counts`` too."""
        with self._lock:
            self._counters[name] += n
        stack = self._open.stack
        if stack:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + n

    def observe_latency(self, name: str, seconds: float) -> None:
        with self._lock:
            bucket = self._latencies[name]
            bucket.append(seconds)
            if len(bucket) > self._window:
                del bucket[: len(bucket) - self._window]

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
        """A span of ``name`` whose duration also feeds the latency
        histogram ``name`` and the counter ``name.count``."""
        t0 = time.perf_counter()
        try:
            with self.span(name):
                yield
        finally:
            self.observe_latency(name, time.perf_counter() - t0)
            self.count(name + ".count")

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

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._latencies.clear()
            self._values.clear()
            self._spans.clear()


METRICS = MetricRegistry()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed block, every
    thread's host activity and the card's when there is one, into
    ``log_dir/trace.json`` (Chrome trace format: chrome://tracing, Perfetto,
    TensorBoard's profiler plugin). The program's spans of the calls that
    start inside it appear as ``ragfin.<name>``."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
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
