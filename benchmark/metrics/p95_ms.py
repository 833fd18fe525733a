"""95th percentile of call latency, send to return of all results, over every
call that completed inside the window (linear interpolation between ranks)."""

import numpy as np


def read(run):
    lat = [(c.end - c.start) * 1e3 for c in run.completed]
    return float(np.percentile(lat, 95)) if lat else None
