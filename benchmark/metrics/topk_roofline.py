"""Share of the top-k roofline: the least time of every traced call's top-k
(the work the call asks for: its questions against the whole corpus, read
once) over the device time of the work launched inside the index's search
methods, encoder excluded, in the traced window. Nothing read, nothing
returned."""

from benchmark.lib import roofline


def read(run):
    if run.trace is None or run.trace["index_device_s"] <= 0:
        return None
    least = sum(
        roofline.topk_least_s(c.questions, run.layout.rows, run.layout.dim, run.top_k, run.dtype)
        for c in run.calls
    )
    return 100.0 * least / run.trace["index_device_s"]
