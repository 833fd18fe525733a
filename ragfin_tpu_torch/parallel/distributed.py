"""Multi-process initialization helpers.

Counterpart of ``ragfin_tpu/parallel/distributed.py``. Where JAX's
``jax.distributed.initialize`` makes ``jax.devices()`` span every host, the
port joins the processes with ``torch.distributed.init_process_group``
(NCCL on the card, gloo on the CPU). Each process then holds the devices it
sees; the 1-D retrieval programs (:mod:`.sharded`, :mod:`.sharded_ivf`,
:mod:`.sharded_graph`) place each process's slice of the shard axis and
merge their candidates across ranks as well, so only top-k candidates,
never corpus data, cross between processes.

Single-process runs go through the same calls with ``num_processes=1``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import DeviceLike
from .mesh import Mesh, make_mesh


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> dict:
    """Connect this process to the job (no-op for single-process runs).

    Arguments default from torch's launcher variables (``MASTER_ADDR`` and
    ``MASTER_PORT`` as ``host:port``, ``WORLD_SIZE``, ``RANK``), so
    launchers can configure purely through the environment."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))

    if num_processes > 1 and not dist.is_initialized():
        if coordinator_address is None:
            raise ValueError("more than one process needs a coordinator address (host:port)")
        dist.init_process_group(
            "nccl" if torch.cuda.is_available() else "gloo",
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes,
            rank=process_id,
        )
    local = torch.cuda.device_count()
    return {
        "process_id": process_id,
        "num_processes": num_processes,
        "local_devices": local,
        "global_devices": local * num_processes,
    }


def global_corpus_mesh(axis: str = "data", devices: Optional[list[DeviceLike]] = None) -> Mesh:
    """1-D mesh over this process's devices (every CUDA device unless
    ``devices`` are given). With a process group, the shard axis spans the
    processes' meshes in rank order."""
    return make_mesh((axis,), devices=devices)
