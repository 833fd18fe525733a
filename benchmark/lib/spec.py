"""Find a cell's parts by the names in ``BENCHMARK.json``.

- ``benchmark/configs/<config>.json``: the configuration as it is run;
- ``benchmark/traffic/<traffic>.json``: the mix's parameters;
- ``benchmark/checks/<workload>.json``: the limit of each number compared;
- ``benchmark/metrics/<metric>.py``: one reader per metric, ``read(run)``
  returning a number or None (nothing to read).

A later cell, mix or metric is new files and a new entry, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT, "BENCHMARK.json")


def cell(name: str) -> dict:
    spec = benchmark()
    for w in spec["workloads"]:
        if w["name"] == name:
            return {
                "workload": w,
                "config": _json(BENCH_DIR, "configs", w["config"] + ".json"),
                "mix": _json(BENCH_DIR, "traffic", w["traffic"] + ".json"),
                "limits": _json(BENCH_DIR, "checks", name + ".json"),
                "end_to_end": [m for m in spec["end_to_end"] if _applies(m, name)],
                "per_layer": [m for m in spec["per_layer"] if _applies(m, name)],
            }
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def reader(metric: str):
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("benchmark.metrics." + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
