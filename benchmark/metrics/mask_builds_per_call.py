"""Row masks built per call: the program's `index.mask_build` counter (a miss
in the index's host or device mask cache)."""

from benchmark.lib import spans


def read(run):
    return spans.count(run, "index.mask_build")
