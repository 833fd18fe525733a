"""Closed-loop callers: each on its own thread sends its next call of
questions when the last one has returned, until the window closes.

A call runs from its send to the return of its results. Calls still in
flight at the close are waited for (a minute at most) and judged if they are
among the checked calls. The readers decide what counts: ``qps`` counts such
a call by the share of its duration inside the window, the tail takes only
the calls completed inside it.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import torch

from .system import CallStats


@dataclass
class Call:
    caller: int
    index: int
    start: float
    end: float
    questions: int
    stats: CallStats
    error: str | None = None
    result: list | None = None


def run_window(system, pools: list[list[list[str]]], seconds: float, top_k: int,
               checked: set, tracing: bool = False, grace_s: float = 60.0):
    """Drive the callers for ``seconds``; returns (calls, window start, window end)."""
    n = len(pools)
    barrier = threading.Barrier(n + 1)
    clock: dict = {}
    calls: list[list[Call]] = [[] for _ in range(n)]

    def caller(c: int) -> None:
        pool = pools[c]
        barrier.wait()
        end = clock["end"]
        i = 0
        while True:
            start = time.perf_counter()
            if start >= end:
                return
            questions = pool[i % len(pool)]
            stats = CallStats(capture=(c, i) in checked)
            system.probes.begin(stats)
            error, result = None, None
            try:
                if tracing:
                    with torch.profiler.record_function("bench.call"):
                        out = system.entry(questions, top_k=top_k)
                else:
                    out = system.entry(questions, top_k=top_k)
                if len(out) != len(questions):
                    error = f"{len(out)} results for {len(questions)} questions"
                result = out if (c, i) in checked else None
            except Exception as e:  # noqa: BLE001 - a failed call is counted, not fatal
                error = f"{type(e).__name__}: {e}"
            system.probes.begin(None)
            calls[c].append(Call(c, i, start, time.perf_counter(), len(questions), stats, error, result))
            i += 1

    threads = [threading.Thread(target=caller, args=(c,), daemon=True) for c in range(n)]
    for t in threads:
        t.start()
    clock["start"] = time.perf_counter()
    clock["end"] = clock["start"] + seconds
    barrier.wait()
    for t in threads:
        t.join(timeout=max(0.0, clock["end"] - time.perf_counter()) + grace_s)
    alive = sum(t.is_alive() for t in threads)
    return [c for per in calls for c in per], clock["start"], clock["end"], alive
