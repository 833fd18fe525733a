"""Questions answered per second over the window: every call without an
error counts its questions times the share of its duration that lies inside
the window (1 for a call that completed inside it), over the window's
seconds. Counting the calls in flight at the close by their share keeps the
rate from moving in steps of one call when calls are long."""


def read(run):
    done = 0.0
    for c in run.calls:
        if c.error is None and c.end > c.start:
            inside = min(c.end, run.window_end) - max(c.start, run.window_start)
            done += c.questions * max(0.0, inside) / (c.end - c.start)
    return done / run.seconds
