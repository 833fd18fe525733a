"""Contrastive training of the embedding models (in-batch negatives, InfoNCE).

Counterpart of ``ragfin_tpu/models/training.py``. One step function drives
both the bag encoder (the projection table is the parameter, applied by
:func:`bag_apply`) and the MiniLM-class transformer (an ``nn.Module``,
applied by :func:`.minilm.minilm_apply`): any encoder expressed as
``apply(params, side) -> [B, D]`` unit embeddings.

JAX differentiates the step with ``jax.value_and_grad`` and updates through
optax; here autograd computes the gradients and the optimizer is
``torch.optim.AdamW`` with the optax pieces the JAX package uses written
beside it, numerically as optax defines them:

- :func:`clip_by_global_norm`: ``g / norm * max_norm`` when
  ``norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` divides by
  ``norm + 1e-6``, which differs);
- :class:`AdamW`: optax.adamw's defaults (b1 0.9, b2 0.999, eps 1e-8 and
  **weight decay 1e-4**; torch's own default is 1e-2);
- :func:`warmup_cosine_decay_schedule` on ``LambdaLR``. optax evaluates the
  schedule at count 0 before the first update, so with a warmup from 0 the
  first update moves the Adam moments but not the parameters; ``LambdaLR``
  gives the same sequence because :func:`make_train_step` steps the
  scheduler after the optimizer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from .bag_encoder import bag_encode

# (params, batch side) -> [B, D]; params is a tensor (the bag table) or a module.
EncoderApply = Callable[[Any, dict], torch.Tensor]
Schedule = Callable[[int], float]


def bag_apply(params: torch.Tensor, side: dict) -> torch.Tensor:
    """Encoder-apply adapter for the bag encoder (params = projection table)."""
    return bag_encode(params, side["ids"], side["weights"])


def info_nce_loss(
    q_emb: torch.Tensor, d_emb: torch.Tensor, temperature: float = 0.05
) -> torch.Tensor:
    """Symmetric InfoNCE over in-batch negatives: [B, D] unit embeddings
    both sides, positives on the diagonal."""
    logits = q_emb @ d_emb.T / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2


# --- the optax pieces ---------------------------------------------------------


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float = 0.0,
) -> Schedule:
    """optax's schedule of the same name: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then cosine decay to ``end_value``
    at ``decay_steps`` (which includes the warmup)."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, span)
        return peak_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / span)) + alpha)

    return schedule


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: every gradient scaled by
    ``max_norm / norm`` when the global L2 norm reaches ``max_norm``.
    Returns the norm before clipping."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.adamw (b1 0.9, b2 0.999, eps 1e-8), behind
    optax.clip_by_global_norm when ``max_grad_norm`` is set (the
    ``optax.chain`` the domain-encoder trainer uses). ``learning_rate`` is a
    number or a schedule of the update count."""

    learning_rate: Union[float, Schedule]
    weight_decay: float = 1e-4
    max_grad_norm: Optional[float] = None

    def init(self, params: list[torch.Tensor]):
        """(torch optimizer, LambdaLR or None) over ``params``."""
        scheduled = callable(self.learning_rate)
        opt = torch.optim.AdamW(
            params, lr=1.0 if scheduled else float(self.learning_rate),
            betas=(0.9, 0.999), eps=1e-8, weight_decay=self.weight_decay,
        )
        sched = torch.optim.lr_scheduler.LambdaLR(opt, self.learning_rate) if scheduled else None
        return opt, sched


# --- the step -------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    """The parameters (a leaf tensor or a module), the torch optimizer over
    them, its schedule (or None) and the number of updates taken. The step
    updates them in place and returns the same object."""

    params: Union[torch.Tensor, nn.Module]
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler]
    step: int = 0

    def tensors(self) -> list[torch.Tensor]:
        if isinstance(self.params, nn.Module):
            return list(self.params.parameters())
        return [self.params]


def init_train_state(params: Union[torch.Tensor, nn.Module], optimizer: AdamW) -> TrainState:
    """A state over ``params``: a tensor becomes a leaf that requires grad
    (a copy, so the caller's tensor is not trained in place); a module is
    trained as it is."""
    if not isinstance(params, nn.Module):
        params = params.detach().clone().requires_grad_(True)
    state = TrainState(params, None, None)
    state.optimizer, state.scheduler = optimizer.init(state.tensors())
    return state


def make_train_step(apply_fn: EncoderApply, optimizer: AdamW, temperature: float = 0.05):
    """(state, batch) -> (state, metrics): one InfoNCE update.

    ``batch = {"query": side, "doc": side}`` where each side is what
    ``apply_fn`` consumes. ``metrics`` holds 0-dim tensors on the device
    (``loss``, and ``accuracy``: ``argmax(q @ d.T) == arange``), so a caller
    can take many steps before it reads one back."""

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        state.optimizer.zero_grad(set_to_none=True)
        q = apply_fn(state.params, batch["query"])
        d = apply_fn(state.params, batch["doc"])
        loss = info_nce_loss(q, d, temperature)
        loss.backward()
        with torch.no_grad():
            hits = torch.argmax(q @ d.T, dim=1) == torch.arange(q.shape[0], device=q.device)
            # count * f32(1 / B): the rounding XLA gives jnp.mean, so the
            # accuracies equal the JAX package's
            acc = hits.sum(dtype=torch.float32) * (1.0 / q.shape[0])
        if optimizer.max_grad_norm is not None:
            grads = [p.grad for p in state.tensors() if p.grad is not None]
            clip_by_global_norm(grads, optimizer.max_grad_norm)
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        return state, {"loss": loss.detach(), "accuracy": acc}

    return train_step
