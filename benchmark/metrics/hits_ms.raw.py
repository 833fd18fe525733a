"""The reading of `hits_ms` in the raw cell, whose per-layer metrics name
`peak_gib` (PERF.md, section 2)."""

from benchmark.lib.spec import reader

read = reader("hits_ms")
