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
as ``load_encoder_checkpoint`` returns it) across as a ``state_dict``;
:func:`load_hf_weights` reads a local HF BERT/MiniLM checkpoint directory
(``model.safetensors`` through the port's own reader, or
``pytorch_model.bin``) straight into one; :func:`init_params` draws seeded
random weights with Flax's initialiser shapes (not its draws).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

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


def minilm_apply(model: MiniLMEncoder, side: dict) -> torch.Tensor:
    """Encoder-apply adapter for training: ``side`` holds ``input_ids`` and
    ``attention_mask`` [B, S]."""
    return model(side["input_ids"], side["attention_mask"])


def init_params(config: MiniLMConfig = MiniLMConfig(), seed: int = 0) -> dict[str, torch.Tensor]:
    """Seeded random :class:`MiniLMEncoder` ``state_dict`` with Flax's
    initialisers: Dense kernels truncated normal (2 sigma) of std
    1/sqrt(fan_in), embeddings normal of std 1/sqrt(hidden), biases 0,
    LayerNorm scales 1. Drawn from one ``torch.Generator``, in the order of
    the module's parameters."""
    gen = torch.Generator().manual_seed(int(seed))
    sd = {}
    for name, shape in ((n, p.shape) for n, p in MiniLMEncoder(config).state_dict().items()):
        if name.endswith("bias"):
            t = torch.zeros(shape)
        elif "norm" in name:
            t = torch.ones(shape)
        elif "embeddings" in name:
            t = torch.empty(shape).normal_(0.0, 1.0 / math.sqrt(shape[1]), generator=gen)
        else:  # Linear weight [out, in]
            std = 1.0 / math.sqrt(shape[1]) / 0.87962566103423978
            t = torch.nn.init.trunc_normal_(
                torch.empty(shape), std=std, a=-2 * std, b=2 * std, generator=gen
            )
        sd[name] = t
    return sd


# --- HF checkpoint import (a local directory; nothing is downloaded) ---------

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.uint16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}
_ST_NAMES = {np.dtype(v): k for k, v in _ST_DTYPES.items() if k != "BF16"}


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """Tensors of a ``.safetensors`` file as numpy arrays (BF16 widened to
    f32): an 8-byte little-endian header length, a JSON header of ``dtype``,
    ``shape`` and ``data_offsets`` per tensor, then the raw bytes."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file")
    n = int.from_bytes(data[:8], "little")
    if n > len(data) - 8:
        raise ValueError(f"{path}: header length {n} past the end of the file")
    header = json.loads(data[8 : 8 + n])
    body = memoryview(data)[8 + n :]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = np.dtype(_ST_DTYPES[info["dtype"]])
        shape = tuple(int(d) for d in info["shape"])
        start, end = (int(o) for o in info["data_offsets"])
        if not 0 <= start <= end <= len(body) or end - start != dtype.itemsize * math.prod(shape):
            raise ValueError(f"{path}: tensor {name!r} has offsets {start}:{end} for {shape}")
        arr = np.frombuffer(body[start:end], dtype=dtype).reshape(shape)
        if info["dtype"] == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr.copy()
    return out


def write_safetensors(path: str, tensors: dict[str, np.ndarray]) -> None:
    """Write numpy arrays (f64/f32/f16, integer or bool) as ``.safetensors``."""
    header, offset, blobs = {}, 0, []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        blob = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": _ST_NAMES[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        offset += len(blob)
        blobs.append(blob)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for blob in blobs:
            f.write(blob)


def save_hf_weights(
    path: str, state_dict: dict, vocab=None, formats=("safetensors", "bin")
) -> None:
    """Write a :class:`MiniLMEncoder` ``state_dict`` as a HF BERT checkpoint
    directory (the inverse of :func:`load_hf_weights`): ``model.safetensors``
    and/or ``pytorch_model.bin``, and ``vocab.txt`` when ``vocab`` (tokens in
    id order) is given."""
    hf = {
        "embeddings.word_embeddings.weight": state_dict["word_embeddings.weight"],
        "embeddings.position_embeddings.weight": state_dict["position_embeddings.weight"],
        "embeddings.token_type_embeddings.weight": state_dict["token_type_embeddings.weight"],
        "embeddings.LayerNorm.weight": state_dict["embeddings_norm.weight"],
        "embeddings.LayerNorm.bias": state_dict["embeddings_norm.bias"],
    }
    i = 0
    while f"layers.{i}.ffn_norm.weight" in state_dict:
        for hf_key, ours in {**_HF_LINEARS, **_HF_NORMS}.items():
            for part in ("weight", "bias"):
                hf[f"encoder.layer.{i}.{hf_key}.{part}"] = state_dict[f"layers.{i}.{ours}.{part}"]
        i += 1
    os.makedirs(path, exist_ok=True)
    hf = {k: v.detach().cpu().float().contiguous() for k, v in hf.items()}
    if "safetensors" in formats:
        write_safetensors(os.path.join(path, "model.safetensors"),
                          {k: v.numpy() for k, v in hf.items()})
    if "bin" in formats:
        torch.save(hf, os.path.join(path, "pytorch_model.bin"))
    if vocab is not None:
        with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
            f.write("\n".join(vocab) + "\n")


_HF_LINEARS = {
    "attention.self.query": "attention.query",
    "attention.self.key": "attention.key",
    "attention.self.value": "attention.value",
    "attention.output.dense": "attention.output",
    "intermediate.dense": "intermediate",
    "output.dense": "ffn_output",
}
_HF_NORMS = {"attention.output.LayerNorm": "attention_norm", "output.LayerNorm": "ffn_norm"}


def load_hf_weights(path: str, config: MiniLMConfig = MiniLMConfig()) -> dict[str, torch.Tensor]:
    """A local HF BERT/MiniLM checkpoint directory (``model.safetensors`` or
    ``pytorch_model.bin``) -> :class:`MiniLMEncoder` ``state_dict``. Linear
    weights keep torch's ``[out, in]``; keys may carry a ``bert.`` or
    ``encoder.`` prefix; a missing tensor raises ``KeyError``."""
    st_path = os.path.join(path, "model.safetensors")
    pt_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(st_path):
        tensors = {k: torch.from_numpy(v) for k, v in read_safetensors(st_path).items()}
    elif os.path.exists(pt_path):
        tensors = torch.load(pt_path, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"no checkpoint under {path}")

    def t(name: str) -> torch.Tensor:
        for prefix in ("", "bert.", "encoder."):
            if prefix + name in tensors:
                return tensors[prefix + name].to(torch.float32).contiguous()
        raise KeyError(name)

    sd = {
        "word_embeddings.weight": t("embeddings.word_embeddings.weight"),
        "position_embeddings.weight": t("embeddings.position_embeddings.weight"),
        "token_type_embeddings.weight": t("embeddings.token_type_embeddings.weight"),
        "embeddings_norm.weight": t("embeddings.LayerNorm.weight"),
        "embeddings_norm.bias": t("embeddings.LayerNorm.bias"),
    }
    for i in range(config.num_layers):
        hf = f"encoder.layer.{i}."
        for hf_key, ours in _HF_LINEARS.items():
            sd[f"layers.{i}.{ours}.weight"] = t(hf + hf_key + ".weight")
            sd[f"layers.{i}.{ours}.bias"] = t(hf + hf_key + ".bias")
        for hf_key, ours in _HF_NORMS.items():
            sd[f"layers.{i}.{ours}.weight"] = t(hf + hf_key + ".weight")
            sd[f"layers.{i}.{ours}.bias"] = t(hf + hf_key + ".bias")
    return sd
