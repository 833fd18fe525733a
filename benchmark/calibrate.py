"""Readings for a cell's limits: the program on many seeds, and the control.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 --control-seeds 4,5,6 --seconds 20

For each seed, one process makes a whole run of the cell as
``benchmark/run.py`` does (``run.run_cell``, the records made once for all
seeds), with a window of ``--seconds``: long enough that the mix's checked
calls are sent. Then, for each control seed, the reference put in the
program's place one precision step down (``judge.judge(control=True)``) is
judged on that seed's checked calls. One JSON line per reading. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != _ROOT:
    sys.path.insert(0, _ROOT)

import torch  # noqa: E402


def readings(cell: dict, seeds: list[int], control_seeds: list[int], seconds: float, device,
             rows: int | None = None, emit=print) -> list[dict]:
    from benchmark import run
    from benchmark.lib import corpus, judge, questions
    from benchmark.lib.system import System

    config, mix = cell["config"], cell["mix"]
    layout = corpus.Layout.from_config(config["corpus"], rows)
    out = []
    if seeds:
        gc.disable()  # tens of millions of long-lived records: no collector walks
        records = corpus.make_records(layout, System.record_class())
        for seed in seeds:
            t = time.perf_counter()
            numbers: dict = {}
            result = run.run_cell(cell, seed, seconds, False, device, rows=rows, records=records,
                                  numbers=numbers, log=lambda *a, **k: None)
            line = {"seed": seed, "side": "program", "correct": result["correct"], **numbers,
                    "s": time.perf_counter() - t}
            emit(json.dumps(line), flush=True)
            out.append(line)
        del records
        gc.enable()
    for seed in control_seeds:
        t = time.perf_counter()
        pools = [questions.caller_calls(mix, seed, c, mix["pooled_calls"]) for c in range(mix["callers"])]
        checked_calls = [judge.CheckedCall(pools[c][i % len(pools[c])])
                         for c, i in sorted(run.checked_keys(mix, seed))]
        ref = judge.Reference(config, mix, layout, seed, _ROOT, device)
        line = {"seed": seed, "side": "control",
                **judge.judge(ref, mix["entry"], checked_calls, control=True), "s": time.perf_counter() - t}
        emit(json.dumps(line), flush=True)
        out.append(line)
        del ref
    return out


def main() -> int:
    from benchmark.lib import spec

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    readings(spec.cell(args.workload), ints(args.seeds), ints(args.control_seeds), args.seconds, "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
