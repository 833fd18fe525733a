"""Device meshes and the collectives of the port's parallel layer.

Counterpart of ``ragfin_tpu/parallel/mesh.py``. JAX's ``shard_map`` runs one
program per device from one process; the port does the same in plain
PyTorch with a single controller:

- a :class:`Mesh` is a named grid of ``torch.device`` s (``mesh.shape[axis]``
  as in JAX). A device may be listed more than once, so one card (or the
  CPU, in the tests) can stand for a mesh of any size;
- a sharded tensor is the list of its shards, each on its mesh device
  (:func:`shard`), and each shard's local function runs under
  :func:`on_device`;
- the collectives are the small functions below: :func:`all_gather` and
  :func:`psum` bring the shards' parts to one device, :func:`ppermute` moves
  a tensor to the next stage's device (autograd flows back through it, as
  JAX's gradients ride the reverse ``ppermute``).

When ``torch.distributed`` is initialised, a mesh holds this process's
devices and its shards are the process's slice of the global shard axis:
:func:`process_span` gives that slice and :func:`gather_processes` gathers
across ranks (NCCL on the card, gloo on the CPU).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device


class Mesh:
    """A grid of torch devices with one name per axis."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D device grid needs as many axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis`` (index 0 on every other axis)."""
        where = tuple(slice(None) if a == axis else 0 for a in self.axis_names)
        return list(self.devices[where])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]})"


def make_mesh(
    axis_names: Sequence[str] = ("data",),
    shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """Build a mesh over ``devices`` (default: every CUDA device, and it
    raises when there is none; the CPU only when the caller lists it).

    With no ``shape``, all devices go on the first axis (the 1-D corpus
    mesh). For multi-axis meshes pass a shape, e.g. ``make_mesh(("dp",
    "tp"), (4, 2))``."""
    if devices is None:
        resolve_device(None)  # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if shape is None:
        shape = [len(devices)] + [1] * (len(axis_names) - 1)
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(tuple(shape)), axis_names)


def factor_mesh_shape(n_devices: int, n_axes: int = 2) -> tuple[int, ...]:
    """Split ``n_devices`` into a near-balanced n_axes-dim mesh shape.

    E.g. 8 → (4, 2); 4 → (2, 2); 6 → (3, 2); 1 → (1, 1). Favors putting the
    larger factor on the first (data) axis.
    """
    if n_axes == 1:
        return (n_devices,)
    best = (n_devices, 1)
    for a in range(1, int(n_devices**0.5) + 1):
        if n_devices % a == 0:
            best = (n_devices // a, a)
    return best + (1,) * (n_axes - 2)


def on_device(device: torch.device):
    """Context in which a shard's local function runs: its card is the
    current CUDA device (allocations, streams, kernel launches)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def process_span() -> tuple[int, int]:
    """(this process's rank, the number of processes): (0, 1) unless
    ``torch.distributed`` is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def require_one_process(what: str) -> None:
    """The pipeline and sequence-parallel programs run in one process."""
    world = process_span()[1]
    if world > 1:
        raise ValueError(f"{what} runs within one process, not across {world}")


def shard(mesh: Mesh, axis: str, tensor: torch.Tensor, dim: int) -> list[torch.Tensor]:
    """Split ``tensor`` (the whole array, the same in every process) into
    equal parts along ``dim``, one per shard of ``axis`` across all
    processes, and place this process's parts on their devices."""
    devices = mesh.axis_devices(axis)
    rank, world = process_span()
    n_shards = len(devices) * world
    if tensor.shape[dim] % n_shards:
        raise ValueError(f"dim {dim} of size {tensor.shape[dim]} does not split into {n_shards} shards")
    parts = torch.chunk(tensor, n_shards, dim=dim)[rank * len(devices) : (rank + 1) * len(devices)]
    return [p.to(d).contiguous() for p, d in zip(parts, devices)]


def all_gather(parts: Sequence[torch.Tensor], device: torch.device, dim: int = 0) -> torch.Tensor:
    """The shards' parts concatenated along ``dim`` on ``device`` (JAX's
    tiled ``all_gather``)."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def psum(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The sum of the shards' parts on ``device``."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def ppermute(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Send a stage's activations to the next stage's device."""
    return x.to(device)


def gather_processes(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Every process's ``t`` concatenated along ``dim`` in rank order (the
    identity in one process without a process group)."""
    if not (dist.is_available() and dist.is_initialized()):
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts, dim=dim)
