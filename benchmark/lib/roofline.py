"""The yardstick's arithmetic: the card's peaks, a top-k call's least time, and
the FLOPs of a step.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity) at its
full 700 W limit. A top-k call is counted by the work it asks for, whatever
implements it: the corpus matrix read once at its dtype (with the int8 row
scales), the queries read and the ids and scores written once, and
``2 Q N D`` multiply-adds. Its least time is the larger of bytes over the
memory bandwidth and operations over the peak of the product's type: TF32
for exact float32 (no exact float32 product runs faster), int8 for int8.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {
    "float32": 495e12,  # TF32 tensor cores
    "bfloat16": 989e12,
    "int8": 1979e12,
}
BF16_DENSE_PEAK = 989e12
ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}


def topk_bytes(q: int, n: int, d: int, k: int, dtype: str) -> int:
    corpus = n * d * ITEMSIZE[dtype] + (4 * n if dtype == "int8" else 0)
    return corpus + q * d * 4 + q * k * 8


def topk_ops(q: int, n: int, d: int) -> int:
    return 2 * q * n * d


def topk_least_s(q: int, n: int, d: int, k: int, dtype: str) -> float:
    return max(topk_bytes(q, n, d, k, dtype) / HBM_BYTES_PER_S,
               topk_ops(q, n, d) / PEAK_OPS_PER_S[dtype])


def encoder_flops(tokens: list[int], layers: int, hidden: int, ffn: int) -> int:
    """Matrix-product FLOPs of a BERT encoder over sequences of ``tokens``
    real tokens each: the four attention projections and the two FFN
    products per token, and the score and context products over the
    sequence, per layer."""
    per_token = 2 * (4 * hidden * hidden + 2 * hidden * ffn)
    total = 0
    for s in tokens:
        total += layers * (s * per_token + 2 * 2 * s * s * hidden)
    return total
