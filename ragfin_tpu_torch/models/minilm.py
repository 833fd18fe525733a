"""MiniLM-class sentence encoder in plain PyTorch.

Counterpart of ``ragfin_tpu/models/minilm.py:MiniLMEncoder``, with the Flax
module's numerics:

- parameters stay f32; Dense/Embed weights are cast to the activation dtype
  (bf16 by default) at each call, and the Dense bias is added after the
  product has been rounded to that dtype, as ``flax.linen.Dense`` does;
- LayerNorm runs in f32 (eps 1e-12, variance as E[x^2] - E[x]^2 clipped at
  0, Flax's fast variance) and is cast back to the activation dtype;
- GELU is the exact erf form;
- attention scores are an f32 product of the bf16 heads, masked with -1e9,
  softmaxed in f32 and cast back. The attention is plain torch ops on
  purpose: ``scaled_dot_product_attention`` masks differently;
- mean pooling in f32 with a 1e-9 floor, then L2 normalisation with a 1e-12
  floor.

:func:`params_from_flax` carries a Flax parameter tree (``{"params": ...}``,
as ``load_encoder_checkpoint`` returns it) across as a ``state_dict``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config.constants import EMBED_DIM


@dataclasses.dataclass(frozen=True)
class MiniLMConfig:
    vocab_size: int = 30522
    hidden_size: int = EMBED_DIM  # 384
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pooling: str = "mean"  # "mean" | "cls"
    dtype: torch.dtype = torch.bfloat16  # activation dtype (params stay f32)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    y = F.linear(x, layer.weight.to(x.dtype))
    return y + layer.bias.to(x.dtype)


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + norm.eps) * norm.weight
    return ((x - mean) * mul + norm.bias).to(out_dtype)


class SelfAttention(nn.Module):
    def __init__(self, config: MiniLMConfig):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.output = nn.Linear(h, h)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, s, _ = x.shape

        def split(t):  # [B, S, H] -> [B, heads, S, head_dim]
            return t.reshape(b, s, cfg.num_heads, cfg.head_dim).transpose(1, 2)

        q = split(_dense(self.query, x))
        k = split(_dense(self.key, x))
        v = split(_dense(self.value, x))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores / math.sqrt(cfg.head_dim)
        scores = scores.masked_fill(~mask[:, None, None, :], -1e9)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.matmul(probs, v)
        ctx = ctx.transpose(1, 2).reshape(b, s, cfg.hidden_size)
        return _dense(self.output, ctx)


class TransformerLayer(nn.Module):
    def __init__(self, config: MiniLMConfig):
        super().__init__()
        self.config = config
        h, eps = config.hidden_size, config.layer_norm_eps
        self.attention = SelfAttention(config)
        self.attention_norm = nn.LayerNorm(h, eps=eps)
        self.intermediate = nn.Linear(h, config.intermediate_size)
        self.ffn_output = nn.Linear(config.intermediate_size, h)
        self.ffn_norm = nn.LayerNorm(h, eps=eps)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = _layer_norm(self.attention_norm, x + self.attention(x, mask), dt)
        h = F.gelu(_dense(self.intermediate, x))
        h = _dense(self.ffn_output, h)
        return _layer_norm(self.ffn_norm, x + h, dt)


class MiniLMEncoder(nn.Module):
    """Token ids [B, S] + attention mask [B, S] -> unit embeddings [B, H] f32."""

    def __init__(self, config: MiniLMConfig = MiniLMConfig()):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, h)
        self.position_embeddings = nn.Embedding(config.max_position, h)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h)
        self.embeddings_norm = nn.LayerNorm(h, eps=config.layer_norm_eps)
        self.layers = nn.ModuleList(TransformerLayer(config) for _ in range(config.num_layers))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dt = cfg.dtype
        mask = attention_mask.bool()
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = F.embedding(input_ids, self.word_embeddings.weight.to(dt))
        x = x + F.embedding(pos, self.position_embeddings.weight.to(dt))[None]
        x = x + self.token_type_embeddings.weight[0].to(dt)
        x = _layer_norm(self.embeddings_norm, x, dt)
        for layer in self.layers:
            x = layer(x, mask)
        if cfg.pooling == "cls":
            pooled = x[:, 0, :].float()
        else:
            weights = mask.float()[:, :, None]
            pooled = (x.float() * weights).sum(dim=1) / torch.clamp(weights.sum(dim=1), min=1e-9)
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return pooled / torch.clamp(norm, min=1e-12)


_FLAX_LINEARS = {
    "attention/query": "attention.query",
    "attention/key": "attention.key",
    "attention/value": "attention.value",
    "attention/output": "attention.output",
    "intermediate": "intermediate",
    "ffn_output": "ffn_output",
}
_FLAX_NORMS = ("attention_norm", "ffn_norm")


def params_from_flax(flax_params: dict) -> dict[str, torch.Tensor]:
    """Flax MiniLM parameter tree -> :class:`MiniLMEncoder` ``state_dict``.

    Dense ``kernel [in, out]`` becomes ``Linear.weight [out, in]``; LayerNorm
    ``scale``/``bias`` become ``weight``/``bias``; the three embedding tables
    are copied as they are."""
    p = flax_params.get("params", flax_params)

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32, copy=True))

    sd = {
        "word_embeddings.weight": t(p["word_embeddings"]["embedding"]),
        "position_embeddings.weight": t(p["position_embeddings"]["embedding"]),
        "token_type_embeddings.weight": t(p["token_type_embeddings"]["embedding"]),
        "embeddings_norm.weight": t(p["embeddings_norm"]["scale"]),
        "embeddings_norm.bias": t(p["embeddings_norm"]["bias"]),
    }
    i = 0
    while f"layer_{i}" in p:
        layer = p[f"layer_{i}"]
        for flax_path, name in _FLAX_LINEARS.items():
            node = layer
            for part in flax_path.split("/"):
                node = node[part]
            sd[f"layers.{i}.{name}.weight"] = t(np.asarray(node["kernel"]).T)
            sd[f"layers.{i}.{name}.bias"] = t(node["bias"])
        for norm in _FLAX_NORMS:
            sd[f"layers.{i}.{norm}.weight"] = t(layer[norm]["scale"])
            sd[f"layers.{i}.{norm}.bias"] = t(layer[norm]["bias"])
        i += 1
    return sd
