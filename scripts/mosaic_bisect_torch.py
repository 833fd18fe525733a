"""Run the primitives of the in-tile selection on the card.

The CUDA counterpart of scripts/mosaic_bisect.py. It builds
ragfin_tpu_torch/csrc/merge_cases.cu for sm_90a, prints each case's
``ptxas -v`` line (registers, shared memory, spills: the card's answer to
"does it legalise"), runs each case on seeded [64, 256] tiles (uniform
values, all ones, heavy ties, -inf columns) and prints ``name: OK`` when the
kernel equals its plain version bit for bit on every tile, else
``name: FAIL <reason>``. Exits nonzero if any case fails or there is no card.

    python3 scripts/mosaic_bisect_torch.py [case ...]
"""

from __future__ import annotations

import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from ragfin_tpu_torch.ops import _cuda
from ragfin_tpu_torch.ops.merge_cases import CASES, merge_case, merge_case_plain


def tiles(seed: int = 0) -> dict[str, torch.Tensor]:
    """The seeded [64, 256] f32 inputs every case runs on (CPU tensors)."""
    rng = np.random.default_rng(seed)
    neg = rng.random((64, 256), dtype=np.float32)
    neg[:, rng.choice(256, 40, replace=False)] = -np.inf
    neg[rng.choice(64, 8, replace=False), 128:] = -np.inf
    out = {
        "uniform": rng.random((64, 256), dtype=np.float32),
        "ones": np.ones((64, 256), np.float32),
        "ties": rng.choice(np.array([0.0, 0.25, 0.5, 0.75, 1.0], np.float32), (64, 256)),
        "-inf columns": neg,
    }
    return {k: torch.from_numpy(v) for k, v in out.items()}


def ptxas_lines() -> dict[str, str]:
    """Each case's ptxas summary, by case name."""
    lines = {}
    for kernel, summary in _cuda.ptxas_report(_cuda.build_log("merge_cases")):
        m = re.search(r"merge_case_kernel\s*<\s*(\d+)\s*>|merge_case_kernelILi(\d+)E", kernel)
        if m:
            lines[CASES[int(m.group(1) or m.group(2))]] = summary
    return lines


def run(names) -> dict[str, str]:
    """Each case on every tile against its plain version: '' if equal bit for
    bit everywhere, else the reason it failed."""
    dev = torch.device("cuda")
    results = {}
    for name in names:
        reason = ""
        for label, x in tiles().items():
            got = merge_case(name, x.to(dev))
            torch.cuda.synchronize()
            want = merge_case_plain(name, x)
            if not torch.equal(got.cpu(), want):
                diff = int((got.cpu() != want).sum())
                reason = f"{label} tile: {diff} of {want.numel()} values differ from the plain version"
                break
        results[name] = reason
    return results


def main(argv=None) -> int:
    names = list(argv if argv is not None else sys.argv[1:]) or list(CASES)
    unknown = [n for n in names if n not in CASES]
    if unknown:
        print(f"unknown case(s) {unknown}; the cases are {list(CASES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device: the merge cases run only on the card", file=sys.stderr)
        return 1
    lines = ptxas_lines()
    failed = 0
    for name, reason in run(names).items():
        print(f"ptxas {name}: {lines.get(name, 'no ptxas line')}", flush=True)
        if reason:
            failed += 1
            print(f"{name}: FAIL {reason}", flush=True)
        else:
            print(f"{name}: OK", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
