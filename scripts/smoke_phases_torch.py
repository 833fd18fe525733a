"""Run another checkout's chip_smoke.py with a `phase <name>: <s> s` line per
phase, as the current script prints them, so that two commits' whole runs
can be set side by side phase by phase (older scripts print no such lines).

    python3 scripts/smoke_phases_torch.py <checkout> [chip_smoke.py options]

The checkout's own script and package run unchanged: each of its phase
functions that main() calls is wrapped in a timer, and the first lap starts
when the kernels' build starts, as the current script's does.
"""

import functools
import os
import sys
import time

PHASES = (
    ("merge_phase", "build, ptxas, merge cases"), ("first_k_phase", "first-k"),
    ("kernel_phase", "kernels"), ("ceiling_phase", "ceiling"), ("ivf_phase", "IVF alone"),
    ("graph_scale_phase", "graph store"), ("main_path_phase", "main path"),
    ("parallel_phase", "parallel"), ("integrity_phase", "integrity"),
    ("hashed_phase", "hashed"), ("minilm_phase", "minilm"), ("train_phase", "train"),
    ("served_phase", "served"), ("cli_phase", "cli"), ("drivers_phase", "drivers"),
)


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.argv = [os.path.join(root, "chip_smoke.py")] + sys.argv[2:]
    sys.path.insert(0, root)
    import chip_smoke
    from ragfin_tpu_torch.ops import _cuda

    lap = {"t": None}

    def timed(fn, name):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            now = time.perf_counter()
            print(f"phase {name}: {now - lap['t']:.1f} s", flush=True)
            lap["t"] = now
            return out
        return run

    build_all = _cuda.build_all

    def start_then_build(*args, **kwargs):
        lap["t"] = time.perf_counter()
        return build_all(*args, **kwargs)

    _cuda.build_all = start_then_build
    for fn_name, name in PHASES:
        setattr(chip_smoke, fn_name, timed(getattr(chip_smoke, fn_name), name))
    return chip_smoke.main()


if __name__ == "__main__":
    sys.exit(main())
