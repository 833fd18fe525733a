"""Find a cell's parts by the names in ``BENCHMARK.json``.

- ``benchmark/configs/<config>.json``: the configuration as it is run;
- ``benchmark/traffic/<traffic>.json``: the mix's parameters;
- ``benchmark/checks/<workload>.json``: the limit of each number compared;
- ``benchmark/metrics/<metric>.py``: one reader per metric, ``read(run)``
  returning a number or None (nothing to read);
- by a configuration's ``model_type``, its encoder architecture:
  ``benchmark/reference/models/<model_type>.py``, the plain reference
  (``shapes(config)``, the weight leaves the seeded draw fills;
  ``encode(params, config, ids, device, lower=None, rows=128)``, the float32
  forward with its ``lower="fp8"`` control; ``matmul_flops(tokens, config)``,
  the encoder's matrix-product FLOPs), and ``benchmark/lib/states/<model_type>.py``,
  ``program_state(flat)``: those weights under the program's parameter names.

A later cell, mix, metric or architecture is new files and a new entry, never
an edit.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
MODELS_DIR = os.path.join(BENCH_DIR, "reference", "models")
STATES_DIR = os.path.join(BENCH_DIR, "lib", "states")


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


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    return _load("benchmark.metrics." + metric.replace(".", "_"), path).read


def _by_model_type(folder: str, config: dict):
    model_type = config["model_type"]
    path = os.path.join(folder, model_type + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"model_type {model_type!r}: no {os.path.relpath(path, ROOT)}, "
                       "which a configuration of a new architecture adds")
    return _load(f"benchmark.{os.path.basename(folder)}.{model_type}", path)


def arch(config: dict):
    """The plain reference module of the configuration's architecture."""
    return _by_model_type(MODELS_DIR, config)


def states(config: dict):
    """The module that gives the configuration's weights the program's names."""
    return _by_model_type(STATES_DIR, config)
