"""Host time of the int8 exact repair per call: the program's `index.repair`
spans (the float32 re-score of the int8 shortlist against the host shadow
rows, after its readback), in ms. Raw cell only, whose per-layer metrics
name `peak_gib` (PERF.md, section 2)."""

from benchmark.lib import spans


def read(run):
    return spans.ms(run, "index.repair")
