"""Plain float32 reference of a BERT / MiniLM sentence encoder (``model_type: "bert"``).

Post-LayerNorm BERT (Devlin et al., arXiv:1810.04805) as sentence-transformers
runs all-MiniLM-L6-v2: word + position + token-type-0 embeddings and their
LayerNorm; per layer, multi-head self-attention over the real tokens, residual
and LayerNorm, then a GELU (erf) feed-forward, residual and LayerNorm; the
configuration's ``pooling`` (the mean over the real tokens, or the first
token's row) and L2 normalisation. No kernels, no cache.

Parameters are a flat dict keyed by the checkpoint's Flax paths
(``params/layer_0/attention/query/kernel``, kernels ``[in, out]``), the layout
of ``checkpoints/domain_encoder/params.npz`` and of the weights the benchmark
draws for a configuration without a checkpoint (:func:`shapes`).

``lower="fp8"`` is the precision control: every matrix product takes its two
operands rounded to float8 e4m3 with one amax scale per tensor.
"""

from __future__ import annotations

import math

import torch

POOLINGS = ("mean", "cls")


def shapes(config: dict) -> list[tuple[str, tuple[int, ...]]]:
    """The weight leaves in the order the seeded draw fills them."""
    h, f = config["hidden_size"], config["intermediate_size"]
    out = [
        ("params/word_embeddings/embedding", (config["vocab_size"], h)),
        ("params/position_embeddings/embedding", (config["max_position_embeddings"], h)),
        ("params/token_type_embeddings/embedding", (config["type_vocab_size"], h)),
        ("params/embeddings_norm/scale", (h,)),
        ("params/embeddings_norm/bias", (h,)),
    ]
    for layer in range(config["num_hidden_layers"]):
        pre = f"params/layer_{layer}"
        for name, (i, o) in (("attention/query", (h, h)), ("attention/key", (h, h)),
                             ("attention/value", (h, h)), ("attention/output", (h, h)),
                             ("intermediate", (h, f)), ("ffn_output", (f, h))):
            out += [(f"{pre}/{name}/kernel", (i, o)), (f"{pre}/{name}/bias", (o,))]
        for norm in ("attention_norm", "ffn_norm"):
            out += [(f"{pre}/{norm}/scale", (h,)), (f"{pre}/{norm}/bias", (h,))]
    return out


def matmul_flops(tokens: list[int], config: dict) -> int:
    """Matrix-product FLOPs of the encoder over sequences of ``tokens`` real
    tokens each: the four attention projections and the two FFN products per
    token, and the score and context products over the sequence, per layer."""
    layers, hidden, ffn = config["num_hidden_layers"], config["hidden_size"], config["intermediate_size"]
    per_token = 2 * (4 * hidden * hidden + 2 * hidden * ffn)
    total = 0
    for s in tokens:
        total += layers * (s * per_token + 2 * 2 * s * s * hidden)
    return total


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _layer_norm(x, p, name, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p[f"{name}/scale"] + p[f"{name}/bias"]


@torch.no_grad()
def encode(params: dict, config: dict, ids: list[list[int]], device, lower: str | None = None,
           rows: int = 128) -> torch.Tensor:
    """Unit sentence embeddings ``[len(ids), hidden]`` (float32) of token id lists."""
    pooling = config["pooling"]
    if pooling not in POOLINGS:
        raise ValueError(f"pooling {pooling!r}: the BERT reference pools by one of {POOLINGS}")
    p = {k: torch.as_tensor(v).to(device, torch.float32) for k, v in params.items()}
    heads, hidden = config["num_attention_heads"], config["hidden_size"]
    hd = hidden // heads
    eps = config.get("layer_norm_eps", 1e-12)

    def dense(x, name):
        w, b = p[f"{name}/kernel"], p[f"{name}/bias"]
        if lower == "fp8":
            x, w = _fp8(x), _fp8(w)
        return x @ w + b

    out = []
    for start in range(0, len(ids), rows):
        block = ids[start : start + rows]
        s = max(len(t) for t in block)
        tok = torch.zeros((len(block), s), dtype=torch.long)
        real = torch.zeros((len(block), s), dtype=torch.bool)
        for i, t in enumerate(block):
            tok[i, : len(t)] = torch.tensor(t)
            real[i, : len(t)] = True
        tok, real = tok.to(device), real.to(device)
        x = p["params/word_embeddings/embedding"][tok]
        x = x + p["params/position_embeddings/embedding"][:s][None]
        x = x + p["params/token_type_embeddings/embedding"][0]
        x = _layer_norm(x, p, "params/embeddings_norm", eps)
        for layer in range(config["num_hidden_layers"]):
            pre = f"params/layer_{layer}"
            split = lambda t: t.view(t.shape[0], s, heads, hd).transpose(1, 2)  # noqa: E731
            q = split(dense(x, f"{pre}/attention/query"))
            k = split(dense(x, f"{pre}/attention/key"))
            v = split(dense(x, f"{pre}/attention/value"))
            att = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
            att = att.masked_fill(~real[:, None, None, :], float("-inf")).softmax(-1)
            ctx = (att @ v).transpose(1, 2).reshape(x.shape)
            x = _layer_norm(x + dense(ctx, f"{pre}/attention/output"), p, f"{pre}/attention_norm", eps)
            h = torch.nn.functional.gelu(dense(x, f"{pre}/intermediate"))
            x = _layer_norm(x + dense(h, f"{pre}/ffn_output"), p, f"{pre}/ffn_norm", eps)
        if pooling == "cls":
            pooled = x[:, 0]
        else:
            w = real.to(torch.float32)[..., None]
            pooled = (x * w).sum(1) / w.sum(1)
        out.append(pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-12))
    return torch.cat(out)
