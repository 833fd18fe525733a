"""Host wall time inside the index's search methods per timed call, less the
encoder's time inside them (masks, dispatch, waiting on the device, the
int8 repair, hits), over the calls completed inside the window, in ms."""


def read(run):
    if not run.completed:
        return None
    return sum(c.stats.index_s for c in run.completed) / len(run.completed) * 1e3
