"""Headline benchmark of the port: exact cosine top-k query throughput.

Counterpart of ``bench.py`` on the CUDA card: the fused CUDA top-k kernel
(``ragfin_tpu_torch/ops/topk.py``) over a synthetic unit-normalized corpus of
BENCH_N chunks stored ``[D, N]`` in the serving dtype (BENCH_DTYPE: bf16
default, int8 for the quantized index, f32 for the exact tier), queried in
batches of BENCH_Q, top BENCH_K. The time is the device's: the median of
BENCH_REPS CUDA-event timings after a warm-up.

Prints two JSON lines. The first holds the ceiling stages (pass 1 of the same
kernel with the selection replaced by cheaper stand-ins, ``ops/ceiling.py``)
at the same ``(dtype, Q, N)``, in ms. The last is the result,
``{"metric", "value", "unit", "vs_baseline"}``, with the card's name and power
limit; ``vs_baseline`` compares against numpy f32 matmul + argpartition on
this host's CPU, measured on a subsample and scaled linearly in N.

Without a CUDA card it says so in its one JSON line and exits non-zero: there
is no CPU measurement under this metric's name.
"""

import itertools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

N = int(os.environ.get("BENCH_N", 1_000_000))
Q = int(os.environ.get("BENCH_Q", 1024))
K = int(os.environ.get("BENCH_K", 10))
D = 384
REPS = int(os.environ.get("BENCH_REPS", 8))
DTYPE = os.environ.get("BENCH_DTYPE", "bf16")  # bf16 | int8 | f32

SCALE_TAG = f"{N // 1_000_000}M" if N >= 1_000_000 else f"{N // 1000}k"
METRIC = f"exact_cosine_top{K}_qps_{SCALE_TAG}_chunks_{DTYPE}"


def cpu_baseline_qps(d: int = D, k: int = K) -> float:
    """Exact cosine top-k on host CPU (numpy), scaled to the full corpus."""
    n_sub, q_sub = 65_536, 64
    rng = np.random.default_rng(1)
    corpus = rng.standard_normal((n_sub, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = rng.standard_normal((q_sub, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        scores = queries @ corpus.T
        part = np.argpartition(-scores, k, axis=1)[:, :k]
        np.take_along_axis(scores, part, axis=1)
        times.append(time.perf_counter() - t0)
    qps_sub = q_sub / min(times)
    return qps_sub * (n_sub / N)


def main() -> int:
    import torch

    if DTYPE not in ("bf16", "int8", "f32"):
        print(json.dumps({"metric": METRIC, "error": f"unknown BENCH_DTYPE '{DTYPE}'"}))
        return 2
    if not torch.cuda.is_available():
        print(json.dumps({
            "metric": METRIC, "value": None, "unit": "QPS", "vs_baseline": None,
            "error": "no CUDA device: this benchmark times the card and has no CPU fall-back",
        }))
        return 1

    from ragfin_tpu_torch.ops.ceiling import ceiling, fused_chunk_columns, ladder_stages
    from ragfin_tpu_torch.ops.quantize import quantize_corpus_t, quantize_queries
    from ragfin_tpu_torch.ops.topk import cosine_topk_fused, cosine_topk_fused_int8
    from ragfin_tpu_torch.utils.profiling import card, device_ms
    from ragfin_tpu_torch.utils.synthetic import unit_corpus_t, unit_queries

    dev = torch.device("cuda")
    ct = unit_corpus_t(N, seed=0, device=dev, d=D)
    scales = None
    if DTYPE == "int8":
        corpus, scales = quantize_corpus_t(ct.float())
        run = lambda q: cosine_topk_fused_int8(q, corpus, scales, K, n_valid=N)
    else:
        corpus = ct.float() if DTYPE == "f32" else ct
        precision = "exact" if DTYPE == "f32" else "fast"
        run = lambda q: cosine_topk_fused(q, corpus, K, n_valid=N, precision=precision)
    del ct

    qs = unit_queries((REPS, Q, D), seed=1, device=dev)

    def batch_ms(fn, batches) -> float:
        """Median device time of fn over the batches, one call each, after one
        warm-up call."""
        turn = itertools.cycle(batches)
        return device_ms(lambda: fn(next(turn)), runs=len(batches), warmup=1)

    # The ceiling stages see the kernel's own inputs: int8 queries as the
    # fused int8 wrapper quantizes them, bf16-rounded ones for the bf16 tier.
    block_n = fused_chunk_columns(Q, N, dev, corpus.dtype, D)
    if DTYPE == "int8":
        probe_q = [quantize_queries(q)[0] for q in qs]
    else:
        probe_q = [q.to(torch.bfloat16) if DTYPE == "bf16" else q for q in qs]
    ladder = {
        stage: round(batch_ms(
            lambda q, stage=stage: ceiling(q, corpus, stage, block_n, n_valid=N, scales=scales),
            probe_q,
        ), 4)
        for stage in ladder_stages(corpus.dtype)
    }
    per_batch = batch_ms(run, list(qs))
    ladder["kernel"] = round(per_batch, 4)
    info = {"card": card(), "dtype": DTYPE, "q": Q, "n": N, "k": K, "block_n": block_n}
    print(json.dumps({"ceiling_stages_ms": ladder, **info}), flush=True)

    qps = Q / (per_batch / 1e3)
    print(json.dumps({
        "metric": METRIC,
        "value": round(qps, 1),
        "unit": "QPS",
        "vs_baseline": round(qps / cpu_baseline_qps(), 1),
        "card": info["card"],
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
