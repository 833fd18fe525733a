"""ctypes binding for the native batch featurizer (``native/fasthash.cpp``).

Copy of ``ragfin_tpu/models/fasthash.py`` with its own build: the repository's
``native/fasthash.cpp`` is compiled with the host C++ compiler into
``build/ragfin_tpu_torch/libfasthash.so`` (beside the CUDA libraries of
``ops/_cuda.py``, listed in ``.gitignore``) at first use, never at import.
:func:`featurize_batch` gives the pure-Python featurizer's arrays bit for bit:
it is the host-side hot loop at million-chunk scale. Without a compiler, or
when the library fails its ABI check, the featurizer falls back to its Python
path; :func:`available` says which path runs.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SOURCE = os.path.join(_REPO_ROOT, "native", "fasthash.cpp")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "ragfin_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libfasthash.so")
ABI_VERSION = 1

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_lock = threading.Lock()


def _try_build() -> None:
    """Compile the shared library into a private name, then rename it into
    place, so concurrent processes never load a half-written file."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None or not os.path.exists(_SOURCE):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            [cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-o", tmp, _SOURCE],
            capture_output=True, timeout=120, check=True,
        )
        os.replace(tmp, LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        pass
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        if not os.path.exists(LIB_PATH) or os.path.getmtime(LIB_PATH) < os.path.getmtime(_SOURCE):
            _try_build()
        if not os.path.exists(LIB_PATH):
            return None
        try:
            lib = ctypes.CDLL(LIB_PATH)
            lib.ragfin_featurize_batch.restype = ctypes.c_int
            lib.ragfin_featurize_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int,
                ctypes.c_uint64,
                ctypes.c_float,
                ctypes.c_int,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ]
            lib.ragfin_fasthash_abi_version.restype = ctypes.c_int
            if lib.ragfin_fasthash_abi_version() != ABI_VERSION:
                return None
            _lib = lib
        except (OSError, AttributeError):
            # AttributeError: a stale or foreign library without an exported
            # symbol falls back to the Python path like any other failure.
            return None
        return _lib


def available() -> bool:
    """True when the native library is loaded (the featurizer's native
    path runs); False when the featurizer runs its Python path."""
    return _load() is not None


def featurize_batch(
    texts: Sequence[str],
    vocab_size: int,
    bigram_weight: float = 1.0,
    max_feats: int = 4096,
) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Native batch featurize -> (ids [B, max_feats], tf [B, max_feats],
    lens [B]); None when the native library is unavailable."""
    lib = _load()
    if lib is None or not texts:
        return None
    n = len(texts)
    encoded = [t.encode("utf-8") for t in texts]
    arr = (ctypes.c_char_p * n)(*encoded)
    out_ids = np.zeros((n, max_feats), np.int32)
    out_tf = np.zeros((n, max_feats), np.float32)
    out_lens = np.zeros((n,), np.int32)
    rc = lib.ragfin_featurize_batch(
        arr, n, vocab_size, bigram_weight, max_feats, out_ids, out_tf, out_lens
    )
    if rc != 0:
        return None
    return out_ids, out_tf, out_lens
