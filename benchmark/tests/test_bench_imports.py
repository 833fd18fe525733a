"""Nothing the benchmark runs loads JAX or the JAX package; the reference and
the comparison load nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark import run as bench_run
from benchmark.lib import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "ragfin_tpu"}


def _sources():
    for folder, _, files in os.walk(spec.BENCH_DIR):
        if os.sep + "tests" in folder:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(folder, f)


def _top_level_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        found = set(_top_level_imports(path)) & FORBIDDEN
        assert not found, (path, found)


def test_reference_imports_nothing_of_the_program():
    checked = set()
    for path in _sources():
        rel = os.path.relpath(path, spec.BENCH_DIR)
        if rel.startswith(("reference", "lib/states")) or rel in ("lib/judge.py", "lib/corpus.py", "lib/weights.py"):
            assert "ragfin_tpu_torch" not in set(_top_level_imports(path)), rel
            checked.add(rel)
    assert {"reference/models/bert.py", "lib/states/bert.py"} <= checked


def _in_subprocess(code):
    env = dict(os.environ, PYTHONPATH=spec.ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=spec.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_whole_run_loads_no_forbidden_module():
    code = (
        "import sys\n"
        "from benchmark import run\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from _bench_cells import small_cell, RAW\n"
        "run.run_cell(small_cell(RAW), 3, 0.5, False, 'cpu', rows=4096, log=lambda *a, **k: None)\n"
        "from benchmark.lib import spec\n"
        "for m in spec.benchmark()['per_layer'] + spec.benchmark()['end_to_end']: spec.reader(m['name'])\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'ragfin_tpu', 'ragfin_tpu_torch'}))\n"
    )
    assert _in_subprocess(code) == "['ragfin_tpu_torch']"


def test_the_comparison_loads_nothing_of_the_program():
    code = (
        "import sys\n"
        "import benchmark.lib.judge, benchmark.reference.search, benchmark.reference.filters\n"
        "from benchmark.lib import spec\n"
        "for w in spec.benchmark()['workloads']:\n"
        "    config = spec.cell(w['name'])['config']\n"
        "    spec.arch(config), spec.states(config)\n"
        "print('ragfin_tpu_torch' in sys.modules)\n"
    )
    assert _in_subprocess(code) == "False"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ragfin_tpu_torch_extra", sys)
    assert "ragfin_tpu" not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ragfin_tpu.ops", sys)
    assert "ragfin_tpu" in bench_run.forbidden_modules()


def test_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", spec.benchmark()["workloads"][0]["name"],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
