"""The program's own spans of a traced window, for the per-layer readers.

The program (``ragfin_tpu_torch.utils.profiling.METRICS``) records its spans
while a profiler capture runs, as in a ``--trace 1`` window, on the
``perf_counter`` clock of the window and the calls. A call's spans share the
id of its root: ``retrieval.search`` in the scoped cell, ``index.search`` in
the raw one. This module gives the readers the roots that started and ended
inside ``[run.window_start, run.window_end]``, one per completed call, with
their descendants, and sums them per call. Every function returns None
outside a traced run, with no root in the window, or when the program
dropped spans (``trace.dropped``), so that a program without spans, or with
a part of them, reads nothing.
"""

from __future__ import annotations

from collections import defaultdict

from ragfin_tpu_torch.utils.profiling import METRICS


def _window(run):
    """(roots, descendants by root id, children by parent id), or None."""
    if run.trace is None:
        return None
    if not hasattr(METRICS, "spans"):  # a program from before its spans
        return None
    if METRICS.summary()["counters"].get("trace.dropped"):
        return None
    start, end = run.window_start * 1e9, run.window_end * 1e9
    spans = METRICS.spans()
    roots = [s for s in spans if s.parent is None and start <= s.start_ns and s.end_ns <= end]
    if not roots:
        return None
    ids = {s.id for s in roots}
    tree, children = defaultdict(list), defaultdict(list)
    for s in spans:
        if s.root in ids and s.parent is not None:
            tree[s.root].append(s)
            children[s.parent].append(s)
    return roots, tree, children


def _per_call(run, value):
    """The mean over the window's roots of ``value(spans of one call,
    children by parent id)``, where a call's spans include its root."""
    found = _window(run)
    if found is None:
        return None
    roots, tree, children = found
    return sum(value([r] + tree[r.id], children) for r in roots) / len(roots)


def ms(run, *names: str):
    """Summed duration of the spans named, per call, in ms."""
    return _per_call(run, lambda spans, _: sum(s.duration_ns for s in spans if s.name in names) / 1e6)


def self_ms(run, name: str):
    """Self time of the spans named (each one's duration less its
    children's), per call, in ms."""
    def value(spans, children):
        return sum(s.duration_ns - sum(c.duration_ns for c in children[s.id])
                   for s in spans if s.name == name) / 1e6

    return _per_call(run, value)


def count(run, counter: str):
    """Total of a counter made inside the call's spans, per call."""
    return _per_call(run, lambda spans, _: sum(s.counts.get(counter, 0) for s in spans))
