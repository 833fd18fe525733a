"""ctypes binding for the native binary index format (native/indexio.cpp).

``write_array``/``read_array`` persist a 2-D f32/int8 matrix with a CRC32
integrity check — the fast path for large indexes where npz compression is
untenable (gigabytes at 10M chunks), and a loud failure on truncated or
bit-flipped files instead of serving garbage. Falls back to numpy ``.npy``
when the native library is unavailable (no checksum in that case).

Copy of ``ragfin_tpu/utils/indexio.py``: both packages load the one library
built from the repository's ``native/`` sources, so a file written by either
reads in the other.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "build", "libindexio.so")

_DTYPE_CODES = {"float32": 0, "int8": 2}
_CODE_DTYPES = {0: np.float32, 2: np.int8}

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


class IndexIOError(OSError):
    pass


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(
                ["make", "-C", os.path.join(_REPO_ROOT, "native")],
                capture_output=True, timeout=120, check=False,
            )
        except (OSError, subprocess.TimeoutExpired):
            pass
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.ragfin_index_write.restype = ctypes.c_int
        lib.ragfin_index_read_header.restype = ctypes.c_int
        lib.ragfin_index_read_payload.restype = ctypes.c_int
        _lib = lib
    except OSError:
        return None
    return _lib


def available() -> bool:
    return _load() is not None


def write_array(path: str, array: np.ndarray) -> None:
    """Write a 2-D f32/int8 array in RGFI format with CRC32."""
    arr = np.ascontiguousarray(array)
    if str(arr.dtype) not in _DTYPE_CODES:
        arr = np.ascontiguousarray(arr, np.float32)
    lib = _load()
    if lib is None:
        np.save(path + ".npy", arr)
        return
    # Pass the contiguous array's buffer directly — tobytes() would copy
    # the full payload (15 GB at 10M chunks f32) just to hand it to C.
    rc = lib.ragfin_index_write(
        path.encode(), _DTYPE_CODES[str(arr.dtype)], arr.shape[0],
        ctypes.c_uint64(arr.shape[1]),
        arr.ctypes.data_as(ctypes.c_char_p),
        ctypes.c_uint64(arr.nbytes),
    )
    if rc != 0:
        raise IndexIOError(f"index write failed rc={rc}")


def read_array(path: str) -> np.ndarray:
    """Read + checksum-verify an RGFI file (or the .npy fallback)."""
    lib = _load()
    if lib is None or not os.path.exists(path):
        npy = path + ".npy"
        if os.path.exists(npy):
            return np.load(npy)
        raise IndexIOError(f"no index file at {path}")
    dtype = ctypes.c_uint32()
    rows = ctypes.c_uint32()
    cols = ctypes.c_uint64()
    plen = ctypes.c_uint64()
    rc = lib.ragfin_index_read_header(
        path.encode(), ctypes.byref(dtype), ctypes.byref(rows),
        ctypes.byref(cols), ctypes.byref(plen),
    )
    if rc != 0:
        raise IndexIOError(f"index header read failed rc={rc}")
    if dtype.value not in _CODE_DTYPES:
        raise IndexIOError(f"unsupported dtype code {dtype.value}")
    # The header is not CRC-covered (the checksum guards the payload), so
    # validate its self-consistency before trusting plen for an allocation:
    # a bit-flipped length would otherwise attempt a multi-TB buffer, and
    # flipped dims would surface as a bare reshape ValueError.
    np_dtype = np.dtype(_CODE_DTYPES[dtype.value])
    expect = int(rows.value) * int(cols.value) * np_dtype.itemsize
    if plen.value != expect:
        raise IndexIOError(
            f"index header inconsistent: payload_len={plen.value} but "
            f"{rows.value}x{cols.value} {np_dtype.name} needs {expect}"
        )
    fsize = os.path.getsize(path)
    if plen.value > fsize:
        raise IndexIOError(
            f"index payload_len {plen.value} exceeds file size {fsize}"
        )
    # Read straight into the destination array — create_string_buffer +
    # frombuffer().copy() would hold TWO full payload copies at peak.
    out = np.empty((rows.value, cols.value), dtype=np_dtype)
    rc = lib.ragfin_index_read_payload(
        path.encode(), out.ctypes.data_as(ctypes.c_char_p), ctypes.c_uint64(plen.value)
    )
    if rc == -7:
        raise IndexIOError("index checksum mismatch (corrupt file)")
    if rc != 0:
        raise IndexIOError(f"index payload read failed rc={rc}")
    return out
