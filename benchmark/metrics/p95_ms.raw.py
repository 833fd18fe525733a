"""The reading of ``p95_ms`` in a cell that does not report ``qps`` end to
end: the host sets that cell's pace, and its rate and tail spread from run to
run more than any bound could hold (PERF.md, section 2)."""

from benchmark.lib.spec import reader

read = reader("p95_ms")
