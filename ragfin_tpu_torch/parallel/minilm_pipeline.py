"""Pipeline-parallel MiniLM encoder: GPipe over the transformer stack.

Counterpart of ``ragfin_tpu/parallel/minilm_pipeline.py``. The encoder's
transformer layers (:mod:`ragfin_tpu_torch.models.minilm`) split into
contiguous blocks of L/P per pipeline stage; embeddings and pooling are
cheap and run on the mesh's first device around the pipeline. Hidden
states flow stage to stage on the GPipe schedule of :mod:`.pipeline` (M + P
- 1 ticks for M microbatches), and each stage masks attention with the mask
of the microbatch in flight. An optional ``dp`` axis splits each
microbatch's batch over data-parallel replicas of the pipeline; gradients
of the replicas' copies of a weight sum into it.

Parameters are the encoder's ``state_dict`` (``layers.{i}.*`` per layer);
each layer runs through ``torch.func.functional_call`` on the port's own
``TransformerLayer``, so the pipelined forward computes what the
single-device encoder computes and autograd reaches the given tensors. The
pipeline runs within one process.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.minilm import MiniLMConfig, TransformerLayer, embed_tokens, pool_tokens
from .mesh import Mesh, require_one_process
from .pipeline import gpipe

_LAYER = "layers."


# --- parameter restructuring -------------------------------------------------

def split_minilm_params(params: dict, config: MiniLMConfig):
    """Encoder ``state_dict`` -> (embedding/pooling entries, per-layer
    entries stacked to [L, ...] under their names within a layer)."""
    outer = {k: v for k, v in params.items() if not k.startswith(_LAYER)}
    names = [k[len(f"{_LAYER}0."):] for k in params if k.startswith(f"{_LAYER}0.")]
    stacked = {
        name: torch.stack([params[f"{_LAYER}{i}.{name}"] for i in range(config.num_layers)])
        for name in names
    }
    return outer, stacked


def merge_minilm_params(outer: dict, stacked: dict, config: MiniLMConfig) -> dict:
    """Inverse of :func:`split_minilm_params`."""
    params = dict(outer)
    for i in range(config.num_layers):
        params.update({f"{_LAYER}{i}.{name}": t[i] for name, t in stacked.items()})
    return params


def _layer_params(params: dict, i: int, device: torch.device) -> dict:
    prefix = f"{_LAYER}{i}."
    return {k[len(prefix):]: v.to(device) for k, v in params.items() if k.startswith(prefix)}


# --- stages around the pipeline ----------------------------------------------

def embed_stage(outer: dict, input_ids: torch.Tensor, config: MiniLMConfig) -> torch.Tensor:
    """Token + position + type embeddings and their LayerNorm over the
    outer entries (the encoder's own embedding step)."""
    positions = torch.arange(input_ids.shape[-1], device=input_ids.device)
    return embed_tokens(outer, input_ids, positions, config)


def pool_stage(x: torch.Tensor, attention_mask: torch.Tensor, config: MiniLMConfig) -> torch.Tensor:
    """Mean (or CLS) pooling over real tokens + L2 norm (the encoder's own)."""
    return pool_tokens(x, attention_mask.bool(), config)


# --- pipelined transformer stack ----------------------------------------------

def make_minilm_pp_forward(
    mesh: Mesh,
    config: MiniLMConfig,
    pp_axis: str = "pp",
    dp_axis: Optional[str] = None,
):
    """Build forward(params, input_ids [M, B, S], attention_mask [M, B, S])
    -> unit embeddings [M, B, H] on the mesh's first device, equal to the
    single-device MiniLMEncoder forward per microbatch. ``params`` is the
    encoder's ``state_dict``, on any devices."""
    n_stages = mesh.shape[pp_axis]
    if config.num_layers % n_stages:
        raise ValueError(f"{config.num_layers} layers do not split over {n_stages} stages")
    per_stage = config.num_layers // n_stages
    n_dp = mesh.shape[dp_axis] if dp_axis else 1
    axes = mesh.axis_names
    # Stage s of replica r sits at (pp = s, dp = r), index 0 on other axes.
    grid = [
        [mesh.devices[tuple(s if a == pp_axis else r if a == dp_axis else 0 for a in axes)]
         for s in range(n_stages)]
        for r in range(n_dp)
    ]
    template = TransformerLayer(config).to("meta")

    def forward(params: dict, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        require_one_process("the MiniLM pipeline")
        first = grid[0][0]
        ids, mask = input_ids.to(first), attention_mask.to(first).bool()
        if ids.shape[1] % n_dp:
            raise ValueError(f"batch {ids.shape[1]} does not split over dp={n_dp}")
        outer = {k: v.to(first) for k, v in params.items() if not k.startswith(_LAYER)}
        hidden = embed_stage(outer, ids, config)  # [M, B, S, H]
        b_local = ids.shape[1] // n_dp
        out = []
        for r, devices in enumerate(grid):
            rows = slice(r * b_local, (r + 1) * b_local)
            layers = [
                [_layer_params(params, s * per_stage + i, dev) for i in range(per_stage)]
                for s, dev in enumerate(devices)
            ]
            masks = [mask[:, rows].to(dev) for dev in devices]

            def stage(s):
                def run(x, mb):
                    for p in layers[s]:
                        x = torch.func.functional_call(template, p, (x, masks[s][mb]))
                    return x
                return run

            done = gpipe([stage(s) for s in range(n_stages)], devices, hidden[:, rows])
            out.append(torch.stack([y.to(first) for y in done]))
        return pool_stage(torch.cat(out, dim=1), mask, config)

    return forward


def make_minilm_pp_train_step(
    mesh: Mesh,
    config: MiniLMConfig,
    pp_axis: str = "pp",
    dp_axis: Optional[str] = None,
    learning_rate: float = 1e-3,
):
    """SGD train step over the pp(+dp) mesh: MSE pull of the microbatch
    embeddings toward targets. (params, input_ids, attention_mask, targets)
    -> (params', loss), ``params'`` a new ``state_dict``."""
    forward = make_minilm_pp_forward(mesh, config, pp_axis, dp_axis)

    def step(params: dict, input_ids, attention_mask, targets):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        emb = forward(leaves, input_ids, attention_mask)
        loss = torch.mean((emb - targets.to(emb.device)) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        new = {k: (v - learning_rate * g).detach() for (k, v), g in zip(leaves.items(), grads)}
        return new, loss.detach()

    return step


def place_minilm_pp_params(params: dict, mesh: Mesh, config: MiniLMConfig, pp_axis: str = "pp") -> dict:
    """The same ``state_dict`` with each layer on its stage's device (first
    replica) and the embedding and norm entries on the mesh's first device,
    so each stage's block stays local. Callers may skip this: the forward
    moves what it needs."""
    devices = mesh.axis_devices(pp_axis)
    per_stage = config.num_layers // mesh.shape[pp_axis]
    placed = {}
    for k, v in params.items():
        if k.startswith(_LAYER):
            placed[k] = v.to(devices[int(k.split(".")[1]) // per_stage])
        else:
            placed[k] = v.to(devices[0])
    return placed
