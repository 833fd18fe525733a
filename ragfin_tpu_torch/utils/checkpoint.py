"""Train-state checkpoints: save, find the latest, restore.

Counterpart of ``ragfin_tpu/utils/checkpoint.py`` with the same numbered
``ckpt_%08d`` directories. JAX writes its ``TrainState`` pytree with orbax;
the port writes one ``state.pt`` with ``torch.save`` (the parameters, the
optimizer's and the scheduler's ``state_dict`` and the step) and reads it
with ``torch.load(weights_only=True)``. A train state written by one package
therefore does not load in the other: that is deliberate, the encoder
checkpoints (``models/domain_encoder.py``) are the format both share.
Restoring into a fresh state and training on continues exactly as the run
that was never interrupted.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from ..models.training import TrainState

_FILE = "state.pt"


def save_train_state(directory: str, state: TrainState, step: Optional[int] = None) -> str:
    """Write ``state`` as ``directory/ckpt_<step>`` (the state's own step
    unless ``step`` is given). Returns the checkpoint's path."""
    step = int(step if step is not None else state.step)
    path = os.path.join(directory, f"ckpt_{step:08d}")
    os.makedirs(path, exist_ok=True)
    params = state.params
    payload = {
        "params": params.state_dict() if isinstance(params, nn.Module) else params.detach(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict() if state.scheduler is not None else None,
        "step": int(state.step),
    }
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(d for d in os.listdir(directory) if d.startswith("ckpt_"))
    return os.path.join(directory, ckpts[-1]) if ckpts else None


def restore_train_state(path: str, template: TrainState) -> TrainState:
    """Load the checkpoint at ``path`` into ``template`` (a state made by
    ``init_train_state`` over parameters of the same shapes, on the device
    to restore onto) and return it."""
    device = template.tensors()[0].device
    payload = torch.load(os.path.join(path, _FILE), map_location=device, weights_only=True)
    if isinstance(template.params, nn.Module):
        template.params.load_state_dict(payload["params"])
    else:
        with torch.no_grad():
            template.params.copy_(payload["params"])
    template.optimizer.load_state_dict(payload["optimizer"])
    if template.scheduler is not None:
        template.scheduler.load_state_dict(payload["scheduler"])
    template.step = int(payload["step"])
    return template
