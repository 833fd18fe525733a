"""Pipeline parallelism: a GPipe microbatch pipeline over a ``pp`` axis.

Counterpart of ``ragfin_tpu/parallel/pipeline.py``. The retrieval models
here are shallow, so pipeline parallelism is not load-bearing for the
product; it completes the parallel toolkit (corpus sharding in
:mod:`.sharded`, pp here and in :mod:`.minilm_pipeline`).

A stack of L residual layers ``[L, d, d]`` splits into contiguous blocks of
L/P layers, one per stage device. The schedule runs M + P - 1 ticks for M
microbatches (fill and drain): stage 0 takes a fresh microbatch each tick,
each stage hands its output to the next stage's device (:func:`~.mesh.
ppermute`), and the last stage banks the finished ones. Autograd runs back
through the same transfers, so a train step is ``torch.autograd.grad`` of
the pipelined loss. The pipeline runs within one process.
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import numpy as np
import torch

from .mesh import Mesh, on_device, ppermute, require_one_process

Params = Union[torch.Tensor, Sequence[torch.Tensor]]


def init_pipeline_params(generator: torch.Generator, n_layers: int, dim: int, scale: float = 0.1) -> torch.Tensor:
    """Stacked residual-MLP layer weights [L, d, d], drawn from ``generator``."""
    return scale * torch.randn((n_layers, dim, dim), generator=generator, dtype=torch.float32)


def pipeline_params_from_numpy(params: np.ndarray) -> torch.Tensor:
    """[L, d, d] weights from a host array (such as the JAX package's)."""
    return torch.from_numpy(np.array(params, np.float32))


def _local_forward(local_params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Run one stage's block of layers in order (residual tanh MLP)."""
    for w in local_params:
        x = x + torch.tanh(x @ w)
    return x


def sequential_forward(params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Single-device reference: all L layers in order."""
    return _local_forward(params, x)


def stage_blocks(params: Params, devices: Sequence[torch.device]) -> list[torch.Tensor]:
    """Each stage's block of layers on its device: the [L, d, d] stack split
    along dim 0, or the blocks :func:`place_pipeline_params` made."""
    blocks = torch.chunk(params, len(devices)) if isinstance(params, torch.Tensor) else list(params)
    if len(blocks) != len(devices) or len({b.shape[0] for b in blocks}) != 1:
        raise ValueError(f"layers do not split evenly over {len(devices)} stages")
    return [b.to(d) for b, d in zip(blocks, devices)]


def gpipe(stages: Sequence[Callable], devices: Sequence[torch.device], microbatches) -> list[torch.Tensor]:
    """Run ``stages[s]`` on ``devices[s]`` over the microbatches on the GPipe
    fill-and-drain schedule; returns the finished microbatches in order (on
    the last stage's device). ``stages[s](x, mb)`` also gets the index of the
    microbatch in flight."""
    n_stages, m = len(stages), len(microbatches)
    inbox: list = [None] * n_stages  # what each stage takes on the next tick
    done: list = [None] * m
    for t in range(m + n_stages - 1):
        outbox: list = [None] * n_stages
        for s in range(n_stages):
            mb = t - s  # the microbatch in flight at stage s on tick t
            if not 0 <= mb < m:
                continue
            x = microbatches[mb].to(devices[0]) if s == 0 else inbox[s]
            with on_device(devices[s]):
                y = stages[s](x, mb)
            if s == n_stages - 1:
                done[mb] = y
            else:
                outbox[s + 1] = ppermute(y, devices[s + 1])
        inbox = outbox
    return done


def make_pipeline_forward(mesh: Mesh, axis: str = "pp") -> Callable:
    """forward(params [L, d, d] or its placed blocks, microbatches [M, B, d])
    -> outputs [M, B, d] on the first stage's device, equal to
    :func:`sequential_forward` per microbatch."""
    devices = mesh.axis_devices(axis)

    def forward(params: Params, microbatches: torch.Tensor) -> torch.Tensor:
        require_one_process("the pipeline")
        blocks = stage_blocks(params, devices)
        stages = [lambda x, _mb, w=w: _local_forward(w, x) for w in blocks]
        return torch.stack([y.to(devices[0]) for y in gpipe(stages, devices, microbatches)])

    return forward


def make_pipeline_train_step(mesh: Mesh, learning_rate: float = 1e-2, axis: str = "pp"):
    """(params, microbatches, targets) -> (params', loss): SGD on MSE through
    the pipeline. ``params`` is the [L, d, d] stack or its placed blocks, and
    ``params'`` has the same form."""
    forward = make_pipeline_forward(mesh, axis)
    devices = mesh.axis_devices(axis)

    def step(params: Params, microbatches: torch.Tensor, targets: torch.Tensor):
        blocks = [b.detach().requires_grad_() for b in stage_blocks(params, devices)]
        preds = forward(blocks, microbatches)
        loss = torch.mean((preds - targets.to(preds.device)) ** 2)
        grads = torch.autograd.grad(loss, blocks)
        new = [(b - learning_rate * g).detach() for b, g in zip(blocks, grads)]
        if isinstance(params, torch.Tensor):
            return torch.cat([b.to(params.device) for b in new]), loss.detach()
        return new, loss.detach()

    return step


def place_pipeline_params(params: torch.Tensor, mesh: Mesh, axis: str = "pp") -> list[torch.Tensor]:
    """Each stage's block of the [L, d, d] stack, on its stage's device."""
    return stage_blocks(params, mesh.axis_devices(axis))
