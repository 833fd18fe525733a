"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, into ``build/ragfin_tpu_torch/`` at the repository root (listed
in ``.gitignore``), under a name that hashes the sources and flags, so an
edited source rebuilds and an unchanged one loads. :func:`build_all` starts
one ``nvcc`` per source at once. Nothing here runs at import time: the CPU
test machines have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "ragfin_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signature of each library's entry point (returns a cudaError_t as int).
KERNELS = {
    "fused_topk": (
        "ragfin_fused_topk",
        [_P, _I, _I, _P, _I, _LL, _LL, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    ),
    "fused_topk_int8": (
        "ragfin_fused_topk_int8",
        [_P, _P, _I, _I, _P, _P, _LL, _LL, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    ),
    "first_k": ("ragfin_first_k", [_P, _LL, _I, _I, _P, _P, _P, _P, _P]),
    "ivf_topk": (
        "ragfin_ivf_topk",
        [_P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P],
    ),
    "ceiling": (
        "ragfin_ceiling",
        [_P, _I, _I, _P, _P, _I, _I, _LL, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    ),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes._CFuncPtr] = {}
# ptxas report (registers, shared memory, spills) of the last build per name.
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(_CSRC, name + ".cu")
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(os.listdir(_CSRC)):
        if path.endswith((".cu", ".cuh")) and (path == name + ".cu" or path.endswith(".cuh")):
            with open(os.path.join(_CSRC, path), "rb") as f:
                h.update(path.encode() + f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str):
    src, out = _target(name)
    if os.path.exists(out):
        return None
    cmd = [_nvcc(), *NVCC_FLAGS]
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd += ["-o", tmp, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> dict[str, str]:
    """Compile every kernel source in parallel (one nvcc each) and load them.
    Returns the ptxas report of each source built in this call."""
    with _lock:
        started = {name: _start(name) for name in KERNELS if name not in _loaded}
        for name, proc in started.items():
            _finish(name, proc)
    for name in KERNELS:
        kernel(name)
    return dict(BUILD_LOGS)


def kernel(name: str):
    """The C entry point of kernel library ``name``, built on first use."""
    fn = _loaded.get(name)
    if fn is not None:
        return fn
    with _lock:
        if name not in _loaded:
            _finish(name, _start(name))
            symbol, argtypes = KERNELS[name]
            lib = ctypes.CDLL(_target(name)[1])
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
    return _loaded[name]


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")
