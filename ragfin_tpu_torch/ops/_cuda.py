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
import re
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
        [_P, _I, _I, _P, _I, _I, _LL, _LL, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    ),
    "fused_topk_int8": (
        "ragfin_fused_topk_int8",
        [_P, _P, _I, _I, _P, _P, _LL, _LL, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    ),
    "first_k": ("ragfin_first_k", [_P, _LL, _I, _P, _I, _P, _P]),
    "ivf_topk": (
        "ragfin_ivf_topk",
        [_P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P],
    ),
    "ceiling": (
        "ragfin_ceiling",
        [_P, _I, _I, _P, _P, _I, _I, _LL, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    ),
    "merge_cases": ("ragfin_merge_case", [_P, _P, _I, _P]),
}

_lock = threading.Lock()
_loaded: dict[tuple[str, tuple[str, ...]], ctypes._CFuncPtr] = {}
# ptxas report (registers, shared memory, spills) of the last build per name.
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def _target(name: str, defines: tuple[str, ...] = ()) -> tuple[str, str]:
    src = os.path.join(_CSRC, name + ".cu")
    h = hashlib.sha1(" ".join(NVCC_FLAGS + defines).encode())
    for path in sorted(os.listdir(_CSRC)):
        if path.endswith((".cu", ".cuh")) and (path == name + ".cu" or path.endswith(".cuh")):
            with open(os.path.join(_CSRC, path), "rb") as f:
                h.update(path.encode() + f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str, defines: tuple[str, ...] = ()):
    src, out = _target(name, defines)
    if os.path.exists(out):
        return None
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd += ["-o", tmp, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out


def _finish(name: str, started, defines: tuple[str, ...] = ()) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    BUILD_LOGS[" ".join((name, *defines))] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu {' '.join(defines)}:\n{log}")
    with open(out + ".ptxas", "w") as f:
        f.write(log)
    os.replace(tmp, out)


def build_all() -> dict[str, str]:
    """Compile every kernel source in parallel (one nvcc each) and load them.
    Returns the ptxas report of each source built in this call."""
    with _lock:
        started = {name: _start(name) for name in KERNELS if (name, ()) not in _loaded}
        for name, proc in started.items():
            _finish(name, proc)
    for name in KERNELS:
        kernel(name)
    return dict(BUILD_LOGS)


def build_log(name: str) -> str:
    """The nvcc/ptxas log of library ``name``'s current build (building it
    first if needed), also when an earlier process built it."""
    kernel(name)
    if name in BUILD_LOGS:
        return BUILD_LOGS[name]
    with open(_target(name)[1] + ".ptxas") as f:
        return f.read()


def kernel(name: str, defines: tuple[str, ...] = ()):
    """The C entry point of kernel library ``name``, built on first use;
    ``defines`` (``"MACRO=value"``) build a variant beside it, for sweeps."""
    fn = _loaded.get((name, defines))
    if fn is not None:
        return fn
    with _lock:
        if (name, defines) not in _loaded:
            _finish(name, _start(name, defines), defines)
            symbol, argtypes = KERNELS[name]
            lib = ctypes.CDLL(_target(name, defines)[1])
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[(name, defines)] = fn
    return _loaded[(name, defines)]


def ptxas_report(log: str) -> list[tuple[str, str]]:
    """(kernel, "N registers, S bytes spill stores, L bytes spill loads, ...")
    for every entry function in an ``nvcc -Xptxas -v`` log, names demangled
    where ``c++filt`` is installed."""
    rows, current, props = [], None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current, props = m.group(1), {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            props["spills"] = f"{m.group(1)} bytes spill stores, {m.group(2)} bytes spill loads"
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m:
            extra = m.group(2).strip(", ")
            rows.append((current, f"{m.group(1)} registers, {props.get('spills', 'spills not reported')}"
                         + (f", {extra}" if extra else "")))
            current = None
    names = [name for name, _ in rows]
    filt = shutil.which("c++filt")
    if filt and names:
        out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = out.stdout.splitlines()
    return [(name, summary) for name, (_, summary) in zip(names, rows)]


def spills(report: list[tuple[str, str]]) -> list[str]:
    """The kernels of a ptxas_report that spill registers."""
    return [name for name, summary in report
            if re.search(r"[1-9]\d* bytes spill (stores|loads)", summary)]


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")
