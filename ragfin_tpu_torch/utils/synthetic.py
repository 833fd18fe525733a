"""Seeded synthetic inputs.

The corpora and queries that ``bench_torch.py``, ``scripts/kernel_probe_torch.py``
and ``chip_smoke.py`` feed to the kernels, made on the device: the
distributions of ``bench.py`` and ``scripts/kernel_probe.py`` (standard
normal values rounded to bf16, unit-normalized columns for the top-k
kernels). And a WordPiece vocabulary in the HF layout for synthetic MiniLM
checkpoints (nothing is downloaded).
"""

from __future__ import annotations

import torch

D = 384


def normal_bf16(shape, seed: int, device="cuda") -> torch.Tensor:
    """Standard normal values of ``shape``, rounded to bf16."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(tuple(shape), generator=gen, device=device).to(torch.bfloat16)


def unit_corpus_t(n: int, seed: int = 0, device="cuda", d: int = D) -> torch.Tensor:
    """``[d, n]`` bf16 with unit columns."""
    x = normal_bf16((d, n), seed, device).float()
    nrm = torch.linalg.vector_norm(x, dim=0, keepdim=True).clamp_min(1e-12)
    return (x / nrm).to(torch.bfloat16)


def unit_queries(shape, seed: int = 1, device="cuda") -> torch.Tensor:
    """f32 queries of ``shape`` (``[..., d]``), unit along the last axis."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(tuple(shape), generator=gen, device=device)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def wordpiece_vocab(words, size: int = 30522) -> list[str]:
    """A ``vocab.txt`` token list of ``size`` entries in the BERT layout:
    [PAD] at 0, [UNK] [CLS] [SEP] [MASK] at 100-103, then every letter and
    digit alone and as a "##" continuation, then ``words`` (lowercased,
    deduplicated), then filler."""
    head = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    chars = [chr(c) for c in range(ord("a"), ord("z") + 1)] + [str(d) for d in range(10)]
    tokens = head + chars + ["##" + c for c in chars]
    seen = set(tokens)
    for w in words:
        w = w.lower()
        if w not in seen:
            seen.add(w)
            tokens.append(w)
    tokens = tokens[:size]
    tokens += [f"[filler{i}]" for i in range(size - len(tokens))]
    return tokens
