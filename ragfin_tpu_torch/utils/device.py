"""Device selection for the port's entry points.

Every entry point takes a ``device`` argument. ``None`` means the CUDA card,
and raises when there is none: the port never carries on silently on the
CPU. The CPU runs only when a caller asks for it (the tests do).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        # The "exact" tier is an f32 HIGHEST-precision product in the JAX
        # package (ragfin_tpu/ops/topk.py _PRECISIONS). TF32 keeps ~3 decimal
        # digits, enough to reorder near-tied ids against the host oracle.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device
