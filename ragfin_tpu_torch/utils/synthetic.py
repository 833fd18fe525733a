"""Seeded synthetic kernel inputs, made on the device.

The corpora and queries that ``bench_torch.py``, ``scripts/kernel_probe_torch.py``
and ``chip_smoke.py`` feed to the kernels: the distributions of ``bench.py``
and ``scripts/kernel_probe.py`` (standard normal values rounded to bf16,
unit-normalized columns for the top-k kernels).
"""

from __future__ import annotations

import torch

D = 384


def normal_bf16(shape, seed: int, device="cuda") -> torch.Tensor:
    """Standard normal values of ``shape``, rounded to bf16."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(tuple(shape), generator=gen, device=device).to(torch.bfloat16)


def unit_corpus_t(n: int, seed: int = 0, device="cuda", d: int = D) -> torch.Tensor:
    """``[d, n]`` bf16 with unit columns."""
    x = normal_bf16((d, n), seed, device).float()
    nrm = torch.linalg.vector_norm(x, dim=0, keepdim=True).clamp_min(1e-12)
    return (x / nrm).to(torch.bfloat16)


def unit_queries(shape, seed: int = 1, device="cuda") -> torch.Tensor:
    """f32 queries of ``shape`` (``[..., d]``), unit along the last axis."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(tuple(shape), generator=gen, device=device)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
