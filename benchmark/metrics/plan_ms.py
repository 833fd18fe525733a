"""Host time of FilteredSearch itself per call: the self time of the program's
`retrieval.search` span (its duration less its child spans: the plans, the
tier bookkeeping and the merge), in ms."""

from benchmark.lib import spans


def read(run):
    return spans.self_ms(run, "retrieval.search")
