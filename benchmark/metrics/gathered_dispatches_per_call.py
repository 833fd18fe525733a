"""Scoped dispatches per call scored on their scope's columns alone: the
program's `index.scope_gather` counter (one per gathered dispatch, inside
`index.topk`). A program that has never counted it reads nothing."""

from benchmark.lib import spans


def read(run):
    if "index.scope_gather" not in spans.METRICS.summary()["counters"]:
        return None
    return spans.count(run, "index.scope_gather")
