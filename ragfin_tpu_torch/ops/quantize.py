"""Int8 corpus and query quantization (symmetric absmax, f32 throughout).

Counterpart of ``ragfin_tpu/ops/quantize.py``:

    score[i, j] ~= (q_i8[i] . c_i8[:, j]) * q_scale[i] * c_scale[j]

``torch.round`` rounds half to even, like ``jnp.round`` and ``np.rint``, so
the int8 values are the JAX package's bit for bit. The scale is
``absmax * f32(1/127)``: XLA rewrites the JAX source's division by the
constant 127 into that multiply, so the port's scales equal the JAX device
path's bit for bit (and lie within 1 ulp of an exact division, which the
JAX host-quantize path in ``index/vector_index.py`` uses).
"""

from __future__ import annotations

import numpy as np
import torch

_INV_127 = float(np.float32(1) / np.float32(127))


def _absmax_quantize(x: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    x = x.float()
    absmax = torch.amax(torch.abs(x), dim=dim, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) * _INV_127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_corpus_t(corpus_t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[D, N] f32/bf16 -> (int8 [D, N], scales f32 [1, N]) per-column absmax."""
    return _absmax_quantize(corpus_t, dim=0)


def quantize_queries(queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[Q, D] f32 -> (int8 [Q, D], scales f32 [Q, 1]) per-row absmax."""
    return _absmax_quantize(queries, dim=1)
