"""Sequence(context)-parallel MiniLM encoder: tokens sharded over a mesh.

Counterpart of ``ragfin_tpu/parallel/minilm_sp.py``. The sequence dimension
is split over ``sp`` shards: each shard embeds and transforms its S/P token
slice at their global positions, and only attention needs other shards'
data, which it gets by gathering the keys and values per layer:

- per-token work (embeddings, LayerNorm, FFN, residuals) stays local;
- attention computes the shard's LOCAL query rows against the FULL gathered
  keys and values (``2 * B * S * H`` elements a layer, whatever P);
- mean pooling finishes with two :func:`~.mesh.psum` s (CLS pooling takes
  shard 0's first row).

Every piece is the port's own encoder code (:mod:`ragfin_tpu_torch.models.
minilm`: ``embed_tokens``, ``attend``, the layer's dense and LayerNorm
modules, ``feed_forward``), so the result equals the single-device
``MiniLMEncoder`` forward. Weights are replicated, one encoder per distinct
device. The forward runs within one process.
"""

from __future__ import annotations

import torch

from ..models.minilm import MiniLMConfig, MiniLMEncoder, _dense, _layer_norm, attend, embed_tokens, unit_rows
from .mesh import Mesh, all_gather, on_device, psum, require_one_process


def make_minilm_sp_forward(mesh: Mesh, config: MiniLMConfig, sp_axis: str = "sp"):
    """Build ``forward(params, input_ids [B, S], attention_mask [B, S]) ->
    unit embeddings [B, H]`` (on the mesh's first device) with S split over
    ``sp_axis``. ``params`` is the encoder's ``state_dict``; sequence
    parallelism splits activations, not weights."""
    devices = mesh.axis_devices(sp_axis)
    n_sp = len(devices)
    cfg = config

    def forward(params: dict, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        require_one_process("the sequence-parallel encoder")
        b, s = input_ids.shape
        if s % n_sp:
            raise ValueError(f"sequence length {s} not divisible by sp={n_sp}")
        s_local = s // n_sp
        models = {}
        for dev in devices:
            if dev not in models:
                with torch.device("meta"):  # no initialisation: the weights are params
                    models[dev] = MiniLMEncoder(cfg)
                models[dev].load_state_dict({k: v.to(dev) for k, v in params.items()}, assign=True)
        mods = [models[dev] for dev in devices]
        cols = [slice(j * s_local, (j + 1) * s_local) for j in range(n_sp)]
        masks = [attention_mask[:, c].bool().to(dev) for c, dev in zip(cols, devices)]
        with torch.no_grad():
            x = []
            for j, dev in enumerate(devices):
                with on_device(dev):
                    pos = torch.arange(j * s_local, (j + 1) * s_local, device=dev)
                    p = dict(mods[j].named_parameters())
                    x.append(embed_tokens(p, input_ids[:, cols[j]].to(dev), pos, cfg))
            # Every key position's validity, gathered once.
            mask_full = [all_gather(masks, dev, 1) for dev in devices]
            for i in range(cfg.num_layers):
                layers = [m.layers[i] for m in mods]
                q = [_dense(l.attention.query, xj) for l, xj in zip(layers, x)]
                k = [_dense(l.attention.key, xj) for l, xj in zip(layers, x)]
                v = [_dense(l.attention.value, xj) for l, xj in zip(layers, x)]
                for j, (layer, dev) in enumerate(zip(layers, devices)):
                    with on_device(dev):
                        ctx = attend(cfg, q[j], all_gather(k, dev, 1), all_gather(v, dev, 1), mask_full[j])
                        h = _layer_norm(layer.attention_norm, x[j] + _dense(layer.attention.output, ctx), x[j].dtype)
                        x[j] = layer.feed_forward(h)
            first = devices[0]
            if cfg.pooling == "cls":
                pooled = x[0][:, 0, :].float()  # the CLS row lives on shard 0
            else:
                w = [m.float()[:, :, None] for m in masks]
                wsum = psum([(xj.float() * wj).sum(dim=1) for xj, wj in zip(x, w)], first)
                wcnt = psum([wj.sum(dim=1) for wj in w], first)
                pooled = wsum / torch.clamp(wcnt, min=1e-9)
            return unit_rows(pooled.to(first))

    return forward
