"""Bag-of-hashed-features encoder (the weight-free lexical embedder), in PyTorch.

Counterpart of ``ragfin_tpu/models/bag_encoder.py``, the device half of the
hashed backend (host half: :mod:`ragfin_tpu_torch.models.featurizer`). Each
hashed feature id indexes a row of a fixed seeded random table ``[V, D]``; a
text's embedding is the L2-normalised weighted sum of its feature rows (a
Johnson-Lindenstrauss projection of the sparse TF-IDF vector).

:func:`init_table` draws the JAX package's table without JAX: an untuned
index saved by either package keeps only the seed, so both must regenerate
the same ``jax.random.normal(jax.random.PRNGKey(seed), (V, D)) / sqrt(D)``.
The draw is Threefry-2x32 over the flat element index (JAX's partitionable
layout, ``jax_threefry_partitionable=True``, the default since JAX 0.5), its
two output words XOR'd, mapped to ``u`` in ``[nextafter(-1, 0), 1)``, then
``sqrt(2) * erfinv(u)`` with Giles' single-precision polynomial, evaluated
step by step as XLA's CPU backend compiles it: its ``log1p`` (a Cephes
rational below ``sqrt(2) - 1``, else a Cephes ``logf`` of ``1 + x``) and its
fused multiply-adds (emulated exactly: an f32 product is exact in f64, one
f64 add, one rounding). It is bitwise equal to JAX 0.9.0 on the CPU
(``tests/test_torch_hashed.py``); XLA on another backend may round its
``log`` differently.

``bag_encode`` is ``torch.nn.functional.embedding_bag`` (sum, per-sample
weights) in f32, then L2 normalisation: each bag is summed in its stored
order, so rows with equal (canonically ordered) feature multisets come out
bitwise equal.
"""

from __future__ import annotations

import functools
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from ..config.constants import EMBED_DIM
from ..utils.device import DeviceLike, resolve_device

_F32 = np.float32
_F64 = np.float64

# Giles, "Approximating the erfinv function": w < 5 and w >= 5 coefficients,
# highest degree first (XLA's ErfInv32).
_ERFINV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
              -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
              -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# XLA's log1p below sqrt(2) - 1: x - x^2/2 + x^3 * N(x) / D(x) (Cephes).
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
# Cephes logf polynomial, XLA's CPU log of f32.
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
          1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
          3.3333331174E-1)


def _fma(a, b, c) -> np.ndarray:
    """f32 fused multiply-add: the f32 product is exact in f64, then one add
    and one rounding to f32."""
    r = np.multiply(a, b, dtype=_F64)
    r += c
    return r.astype(_F32)


def _horner(x: np.ndarray, coeffs) -> np.ndarray:
    r = np.full_like(x, _F32(coeffs[0]))
    for c in coeffs[1:]:
        r = _fma(r, x, _F64(_F32(c)))
    return r


def _xla_log(x: np.ndarray) -> np.ndarray:
    bits = np.maximum(x, np.array(0x00800000, np.int32).view(_F32)).view(np.int32)
    frac = ((bits & np.int32(~0x7F800000)) | np.int32(0x3F000000)).view(_F32)  # [0.5, 1)
    e = ((bits >> 23) - 126).astype(_F32)
    low = frac < _F32(0.707106781186547524)
    t = (frac - _F32(1)) + np.where(low, frac, _F32(0))
    e -= low
    x2 = t * t
    x3 = x2 * t
    y = _fma(_horner(t, _LOG_P[0:3]), x3, _horner(t, _LOG_P[3:6]))
    y = _fma(y, x3, _horner(t, _LOG_P[6:9]))
    y = _fma(y, x3, _F32(-2.12194440e-4) * e)
    return ((t - _F32(0.5) * x2) + y) + _F32(0.693359375) * e


def _xla_log1p(x: np.ndarray) -> np.ndarray:
    out = np.empty_like(x)
    small = np.abs(x) < _F32(0.41421356237309504880)
    xs = x[small]
    x2 = xs * xs
    r = (xs * x2) * (_horner(xs, _LOG1P_NUM) / _horner(xs, _LOG1P_DEN))
    out[small] = xs + _fma(_F32(-0.5), x2, r)
    out[~small] = _xla_log(x[~small] + _F32(1))
    return out


def _erfinv(x: np.ndarray) -> np.ndarray:
    w = -_xla_log1p(x * -x)
    lt = w < _F32(5)
    w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3))
    p = np.where(lt, _F32(_ERFINV_LT[0]), _F32(_ERFINV_GE[0]))
    for a, b in zip(_ERFINV_LT[1:], _ERFINV_GE[1:]):
        p = _fma(p, w, np.where(lt, _F64(_F32(a)), _F64(_F32(b))))
    return np.where(np.abs(x) == _F32(1), x * _F32(np.inf), p * x)


def _threefry2x32(k1: int, k2: int, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32, 20 rounds, on uint32 arrays (wrapping adds)."""
    ks = (np.uint32(k1), np.uint32(k2), np.uint32(k1 ^ k2 ^ 0x1BD11BDA))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in rotations[i % 2]:
            x0 += x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _normal_f32(seed: int, n: int, step: int = 1 << 19) -> np.ndarray:
    """The first ``n`` elements of ``jax.random.normal(PRNGKey(seed), ...,
    float32)`` in row-major order. The key is JAX's with 64-bit types off
    (its default): (0, seed mod 2**32). Slices run on a thread pool (numpy
    releases the interpreter lock inside its loops)."""
    out = np.empty(n, _F32)
    lo = np.nextafter(_F32(-1), _F32(0))
    span = _F32(1) - lo
    key = int(seed) & 0xFFFFFFFF

    def fill(start: int) -> None:
        with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
            idx = np.arange(start, min(n, start + step), dtype=np.uint64)
            hi_w = (idx >> np.uint64(32)).astype(np.uint32)
            a, b = _threefry2x32(0, key, hi_w, idx.astype(np.uint32))
            u = (((a ^ b) >> np.uint32(9)) | np.uint32(0x3F800000)).view(_F32) - _F32(1)
            u = np.maximum(lo, u * span + lo)
            out[start : start + idx.size] = _F32(math.sqrt(2)) * _erfinv(u)

    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as pool:
        for fut in [pool.submit(fill, s) for s in range(0, n, step)]:
            fut.result()
    return out


@functools.lru_cache(maxsize=4)
def _host_table(vocab_size: int, dim: int, seed: int) -> np.ndarray:
    table = _normal_f32(seed, vocab_size * dim).reshape(vocab_size, dim) / _F32(math.sqrt(dim))
    table.flags.writeable = False  # shared by every caller in the process
    return table


def init_table(
    vocab_size: int = 1 << 16,
    dim: int = EMBED_DIM,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Seeded random projection table, rows ~ N(0, 1/D): the JAX package's
    draw (see the module docstring), made on the host once per process and
    (vocab, dim, seed), then copied to ``device``."""
    dev = resolve_device(device)
    host = torch.from_numpy(np.array(_host_table(int(vocab_size), int(dim), int(seed))))
    return host.to(dev, dtype)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def bag_encode(
    table: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor, normalize: bool = True
) -> torch.Tensor:
    """(table [V, D], ids [B, L], weights [B, L]) -> [B, D] f32 embeddings.

    Padded slots carry weight 0 and contribute nothing."""
    emb = F.embedding_bag(
        ids, table, mode="sum", per_sample_weights=weights.to(table.dtype)
    ).float()
    return l2_normalize(emb) if normalize else emb


class BagEncoder:
    """The projection table on a device, with an ``encode`` of host arrays."""

    def __init__(
        self,
        vocab_size: int = 1 << 16,
        dim: int = EMBED_DIM,
        seed: int = 0,
        dtype: torch.dtype = torch.float32,
        table=None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.vocab_size = vocab_size
        self.dim = dim
        self.seed = seed
        # A caller-supplied table (a fine-tuned projection) cannot be
        # regenerated from the seed: persistence must write it
        # (encoder_table.npy, see DeviceVectorIndex.save).
        self.tuned = table is not None
        if table is None:
            self.table = init_table(vocab_size, dim, seed, dtype, device=self.device)
        else:
            if not isinstance(table, torch.Tensor):
                table = torch.from_numpy(np.array(table, np.float32))
            self.table = table.to(self.device, dtype)

    def encode(self, ids, weights) -> torch.Tensor:
        """ids [B, L] int32, weights [B, L] float32 (host arrays) -> unit
        embeddings [B, D] on the encoder's device."""
        ids = torch.as_tensor(np.asarray(ids, np.int64)).to(self.device)
        weights = torch.as_tensor(np.asarray(weights, np.float32)).to(self.device)
        return bag_encode(self.table, ids, weights)

    def state_dict(self) -> dict:
        return {
            "vocab_size": self.vocab_size,
            "dim": self.dim,
            "seed": self.seed,
            "tuned": self.tuned,
        }

    @classmethod
    def from_state_dict(cls, state: dict, table=None, device: DeviceLike = None) -> "BagEncoder":
        if state.get("tuned") and table is None:
            raise ValueError(
                "encoder state says the projection table was tuned, but no "
                "table array was provided — reconstructing from the seed "
                "would silently mismatch the saved corpus matrix"
            )
        return cls(
            vocab_size=int(state["vocab_size"]),
            dim=int(state["dim"]),
            seed=int(state["seed"]),
            table=table,
            device=device,
        )
