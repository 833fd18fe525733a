"""Host time building the hit lists per call: the program's `index.hits` spans
(sentinel drop, `SearchHit` objects, re-ranks, and the exact host bucket
search), in ms."""

from benchmark.lib import spans


def read(run):
    return spans.ms(run, "index.hits")
