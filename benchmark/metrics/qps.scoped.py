"""The reading of ``qps`` in the scoped cell, which reports it per layer: the
host sets that cell's pace, and its rate drifts with the host's speed from
run to run more than the largest bound could hold (PERF.md, section 2)."""

from benchmark.lib.spec import reader

read = reader("qps")
