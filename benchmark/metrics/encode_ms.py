"""Host wall time inside the embedder's ``encode_texts`` per timed call
(tokenising, the forward, the copy back), over the calls completed inside
the window, in ms."""


def read(run):
    if not run.completed:
        return None
    return sum(c.stats.encode_s for c in run.completed) / len(run.completed) * 1e3
