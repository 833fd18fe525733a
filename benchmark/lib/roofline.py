"""The yardstick's arithmetic: the card's peaks and a top-k call's least time.
(An encoder's FLOPs are its architecture's: ``matmul_flops`` in
``reference/models/<model_type>.py``.)

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
