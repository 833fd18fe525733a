"""Encoder weights: the committed checkpoint's, or drawn from the seed on the card.

Both come as one flat dict keyed by Flax paths (kernels ``[in, out]``), the
layout of ``params.npz`` in a ``ragfin-domain-encoder-v1`` checkpoint. Seeded
weights fill the leaves that the architecture's reference lists
(``shapes(config)`` of ``reference/models/<model_type>.py``, by name suffix)
and are drawn in one call: kernels normal with std ``1/sqrt(fan_in)``
clipped at two std, embeddings normal with std ``1/sqrt(hidden)``, biases and
LayerNorm offsets normal with std 0.02 around 0 (scales around 1), so that
every parameter takes part in the comparison.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from . import spec

_WEIGHT_SEED_MIX = 0x9E3779B97F4A7C15


def seeded(config: dict, seed: int, device) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * _WEIGHT_SEED_MIX + 1) % (1 << 64))
    leaves = spec.arch(config).shapes(config)
    flat = torch.randn(sum(math.prod(s) for _, s in leaves), generator=gen, device=device)
    out, at = {}, 0
    for name, shape in leaves:
        x = flat[at : at + math.prod(shape)].view(shape)
        at += x.numel()
        if name.endswith("/kernel"):
            std = 1.0 / math.sqrt(shape[0])
            x = (x * std).clamp(-2 * std, 2 * std)
        elif name.endswith("/embedding"):
            x = x / math.sqrt(config["hidden_size"])
        elif name.endswith("/scale"):
            x = 1.0 + 0.02 * x
        else:
            x = 0.02 * x
        out[name] = x
    return out


def checkpoint(root: str, path: str) -> dict[str, np.ndarray]:
    with np.load(os.path.join(root, path, "params.npz")) as archive:
        return {k: np.asarray(archive[k], np.float32) for k in archive.files}
