"""The port stands alone: ``ragfin_tpu_torch``, ``chip_smoke.py``,
``bench_torch.py``, ``scripts/kernel_probe_torch.py``,
``scripts/mosaic_bisect_torch.py`` and ``scripts/train_encoder_torch.py``
import neither JAX (nor flax, optax or orbax, which import it) nor anything
of the JAX package, and the port's entry points refuse to run on the CPU
unless the caller asks for it."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ragfin_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ragfin_tpu")


def _port_files():
    out = [
        os.path.join(ROOT, "chip_smoke.py"),
        os.path.join(ROOT, "bench_torch.py"),
        os.path.join(ROOT, "scripts", "kernel_probe_torch.py"),
        os.path.join(ROOT, "scripts", "mosaic_bisect_torch.py"),
        os.path.join(ROOT, "scripts", "train_encoder_torch.py"),
    ]
    for dirpath, _, names in os.walk(PKG):
        out += [os.path.join(dirpath, n) for n in sorted(names) if n.endswith(".py")]
    return sorted(out)


def _port_modules():
    mods = []
    for path in _port_files():
        if not path.startswith(PKG):
            continue
        rel = os.path.relpath(path, ROOT)[: -len(".py")].replace(os.sep, ".")
        mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return mods


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_package_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = [
        name for name in _imported_roots(tree)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    """A fresh interpreter in which ``import jax`` (and the JAX package)
    fails imports every module of the port."""
    blocked = ", ".join(f"{name!r}" for name in FORBIDDEN)
    code = (
        "import sys\n"
        f"for name in ({blocked},):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for mod in {_port_modules()!r}:\n"
        "    importlib.import_module(mod)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


class TestNoSilentCpu:
    @pytest.fixture(autouse=True)
    def _no_card(self):
        if torch.cuda.is_available():
            pytest.skip("checks the behaviour without CUDA")

    def test_resolve_device_raises(self):
        from ragfin_tpu_torch.utils.device import resolve_device

        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")
        assert resolve_device("cpu") == torch.device("cpu")

    def test_index_raises_without_cuda(self):
        from ragfin_tpu_torch.data.models import IndexedChunk
        from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex

        recs = [IndexedChunk(id=f"c{i}", text="t", period="Q1_FY2024", chunk_type="x")
                for i in range(4)]
        emb = torch.ones((4, 8))
        with pytest.raises(RuntimeError, match="CUDA"):
            DeviceVectorIndex(emb, recs, device=None)
        assert DeviceVectorIndex(emb, recs, device="cpu").device.type == "cpu"

    def test_embedder_and_engine_raise_without_cuda(self):
        from ragfin_tpu_torch.config.settings import Settings
        from ragfin_tpu_torch.models.embedder import TrainedEmbedder
        from ragfin_tpu_torch.serving.engine import RagFinEngine

        with pytest.raises(RuntimeError, match="CUDA"):
            TrainedEmbedder()
        with pytest.raises(RuntimeError, match="CUDA"):
            RagFinEngine(settings=Settings(embed_backend="trained"), chunks=[])

    def test_cuda_kernels_reject_cpu_build(self):
        """Asking for a kernel's library where there is no CUDA toolkit fails
        loudly; nothing builds at import time."""
        import shutil

        from ragfin_tpu_torch.ops import _cuda

        if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
            pytest.skip("a CUDA toolkit is installed here")
        with pytest.raises(RuntimeError, match="nvcc"):
            _cuda.kernel("fused_topk")


def test_chip_smoke_refuses_without_card(tmp_path):
    """chip_smoke.py exits nonzero and prints no result line without a card,
    and when it stands alone without the package."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")), (tmp_path, str(alone))):
        out = subprocess.run(
            [sys.executable, script], cwd=cwd, capture_output=True, text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=""),
        )
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def _run_cli(tmp_path, device_env):
    from ragfin_tpu_torch.eval.statements import write_extract_data

    data = write_extract_data(str(tmp_path / "extract_data"), seed=2)
    env = {k: v for k, v in os.environ.items() if not k.startswith("RAGFIN_")}
    env.update(PYTHONPATH=ROOT, **device_env)
    return subprocess.run(
        [sys.executable, "-m", "ragfin_tpu_torch.cli", "query", "What was the net profit in Q1 FY2024?",
         "--data", data, "--index", ""],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
    )


def test_cli_query_refuses_without_card_unless_cpu_is_asked_for(tmp_path):
    """``python -m ragfin_tpu_torch.cli query`` without a card exits with the
    "no CUDA device" error and no answer; with RAGFIN_DEVICE=cpu it answers."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run_cli(tmp_path, {})
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert '"answer"' not in out.stdout
    out = _run_cli(tmp_path, {"RAGFIN_DEVICE": "cpu"})
    assert out.returncode == 0, out.stderr[-1500:]
    import json

    assert json.loads(out.stdout)["contexts"][0]["id"] == "icici_q1_fy2024_profitability_analysis"


@pytest.mark.parametrize("script", ["bench_torch.py", os.path.join("scripts", "kernel_probe_torch.py"),
                                    os.path.join("scripts", "train_encoder_torch.py")])
def test_bench_scripts_say_so_without_a_card(script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    argv = [sys.executable, os.path.join(ROOT, script)] + (["ceiling_dma_1m"] if "probe" in script else [])
    out = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT, BENCH_N="4096"))
    assert out.returncode != 0
    assert "no CUDA device" in out.stdout + out.stderr
    if script == "bench_torch.py":
        import json

        lines = out.stdout.strip().splitlines()
        assert len(lines) == 1 and json.loads(lines[0])["value"] is None


def test_launcher_runs_on_the_cpu_when_asked(tmp_path):
    """``python -m ragfin_tpu_torch.serving.main --services ...`` starts, prints
    its service table and answers /health."""
    import http.client
    import json
    import signal

    from ragfin_tpu_torch.eval.statements import write_extract_data

    data = write_extract_data(str(tmp_path / "extract_data"), seed=2)
    env = {k: v for k, v in os.environ.items() if not k.startswith("RAGFIN_")}
    env.update(PYTHONPATH=ROOT, RAGFIN_DEVICE="cpu", RAGFIN_DATA_DIR=data, RAGFIN_INDEX_DIR="",
               PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "from ragfin_tpu_torch.config.settings import get_config\n"
         "get_config().ports.update({'graph_service': 0})\n"
         "from ragfin_tpu_torch.serving.main import main\n"
         "main(['--services', 'graph_service'])"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    import threading

    watchdog = threading.Timer(240, proc.kill)  # a hung launcher must not hang the suite
    watchdog.start()
    try:
        line = ""
        while "graph_service:" not in line:
            line = proc.stdout.readline()
            assert line, "the launcher exited before it printed its services"
        port = int(line.strip().rsplit(":", 1)[1])
        assert port != 8002  # the ephemeral port asked for, not the registry's
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/health")
        body = json.loads(conn.getresponse().read())
        conn.close()
        assert body["status"] == "healthy" and body["neo4j_connected"] is True
    finally:
        watchdog.cancel()
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.poll() is not None
