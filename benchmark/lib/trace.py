"""A ``torch.profiler`` capture of the window and its reduction.

The harness marks its own spans with ``record_function``: ``bench.call``
around each timed call, ``bench.index`` around the index's search methods and
``bench.encode`` around the embedder. The reduction reads the profiler's raw
events once (the per-event objects of ``prof.events()`` cost too much at a
million kernels) and gives:

- the device's busy seconds: the union of its kernels, copies and sets;
- the device time of the work launched inside index calls and outside the
  encoder, each event tied to the host thread and time that launched it;
- the device operations that took most time, and the idle gaps by what the
  host threads were doing at the gap's middle.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

SPAN_PREFIX = "bench."
GAP_LABELS = {
    "bench.encode": "encode (tokenise, forward, copies)",
    "bench.index": "index outside kernels (masks, dispatch, repair, hits)",
    "bench.call": "call outside the index (plans, merge)",
}


class Capture:
    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        from torch._C._profiler import _ExperimentalConfig

        # The callers are threads of their own: without profile_all_threads
        # their spans and operators are not recorded.
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                            experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self.prof.__enter__()
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self.prof.__exit__(*exc)
        self.stop_s = (time.time_ns() - self.t1_ns) / 1e9
        return False


def _union(intervals: list[tuple[int, int]]) -> tuple[int, list[tuple[int, int]]]:
    """Total covered length and the merged intervals, sorted."""
    merged: list[tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return sum(b - a for a, b in merged), merged


class _Spans:
    """The harness's spans of one host thread, queried by time."""

    def __init__(self, spans: list[tuple[int, int, str]]):
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def active(self, t: int) -> set[str]:
        """Names of the spans open at ``t``. Spans of a thread nest inside its
        ``bench.call`` spans, so the walk back stops at the nearest call."""
        out = set()
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            _, end, name = self.spans[i]
            if end >= t:
                out.add(name)
            if name == "bench.call":
                break
            i -= 1
        return out


def reduce(cap: Capture, top: int = 10) -> dict:
    events = cap.prof.profiler.kineto_results.events()
    t0, t1 = cap.t0_ns, cap.t1_ns
    spans_by_tid: dict[int, list] = defaultdict(list)
    ops: dict[int, tuple[int, int]] = {}
    runtime: dict[int, tuple[int, int, int]] = {}
    device: list = []
    for e in events:
        name = e.name()
        if str(e.device_type()).endswith("CPU"):
            start = e.start_ns()
            tid = e.start_thread_id()
            if name.startswith(SPAN_PREFIX):
                spans_by_tid[tid].append((start, start + e.duration_ns(), name))
            if name.startswith("cuda") or name.startswith("cu"):
                runtime[e.correlation_id()] = (tid, start, e.linked_correlation_id())
            else:
                ops[e.correlation_id()] = (tid, start)
        elif not name.startswith(SPAN_PREFIX):
            device.append((e.start_ns(), e.duration_ns(), name, e.correlation_id(),
                           e.linked_correlation_id()))
    threads = {tid: _Spans(s) for tid, s in spans_by_tid.items()}

    def inside_index(spans: set) -> bool:
        return "bench.index" in spans and "bench.encode" not in spans

    def launched_in_index(corr: int, linked: int) -> bool:
        """Whether the host launched this device work inside an index call
        and outside the encoder. An operator's launch carries its thread;
        a launch outside any operator (the kernels the program calls
        through ctypes) carries only its time, and counts where some
        caller was inside an index call and outside the encoder then."""
        rt = runtime.get(corr)
        where = ops.get(rt[2] if rt is not None and rt[2] else linked)
        if where is not None and where[0] in threads:
            return inside_index(threads[where[0]].active(where[1]))
        if rt is None:
            return False
        return any(inside_index(sp.active(rt[1])) for sp in threads.values())

    intervals = []
    by_name: dict[str, float] = defaultdict(float)
    index_device_s = 0.0
    index_events = 0
    for start, dur, name, corr, linked in device:
        if start + dur < t0 or start > t1:
            continue
        intervals.append((max(start, t0), min(start + dur, t1)))
        by_name[name] += dur / 1e9
        if launched_in_index(corr, linked):
            index_device_s += dur / 1e9
            index_events += 1
    busy_ns, merged = _union(intervals)
    gaps: dict[str, float] = defaultdict(float)
    prev = t0
    for a, b in merged + [(t1, t1)]:
        if a > prev:
            mid = (prev + a) // 2
            active = set()
            for spans in threads.values():
                kinds = spans.active(mid)
                for span in ("bench.encode", "bench.index", "bench.call"):
                    if span in kinds:
                        active.add(GAP_LABELS[span])
                        break
            label = " + ".join(sorted(active)) or "no call in flight"
            gaps[label] += (a - prev) / 1e9
        prev = max(prev, b)
    window_s = (t1 - t0) / 1e9
    return {
        "window_s": window_s,
        "busy_s": busy_ns / 1e9,
        "index_device_s": index_device_s,
        "index_events": index_events,
        "device_events": len(intervals),
        "device_ops": sorted(([n[:96], s] for n, s in by_name.items()), key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([n, s] for n, s in gaps.items()), key=lambda x: -x[1])[:top],
        "kernel_counts": {
            "fused_topk_pass1": sum(1 for d in device if "fused_topk_pass1" in d[2]),
            "merge_bound": sum(1 for d in device if "merge_bound" in d[2]),
        },
    }
