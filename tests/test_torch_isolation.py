"""The port stands alone: ``ragfin_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package, and the port's entry points
refuse to run on the CPU unless the caller asks for it."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ragfin_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ragfin_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
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
