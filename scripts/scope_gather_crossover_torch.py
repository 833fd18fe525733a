"""Dense against gathered scoped tiers on the CUDA card, by scope size.

Usage: ``python scripts/scope_gather_crossover_torch.py [dtype ...]``
(``float32``, ``bfloat16``, ``int8``; default ``float32 int8``).

For each dtype, builds a ``DeviceVectorIndex`` of N = 10,000,000 random unit
rows on the card and times ``DeviceVectorIndex._masked_topk``, the masked
search both entry points share, at Q = 8 and k = 10 over a group of G = 2
tiers: an untyped tier of R rows and a typed tier of every fourth of them.
The R rows lie one every N / R, as the round-robin scopes of the benchmark's
corpus do, so that every gathered column is its own DRAM sector, the worst
case for a gather. R runs from N / 1024 to N / 2. Each R is timed both ways
through the same method, the bound forced to the whole width (gathered) or
to 0 (dense): the median of 20 CUDA-event timings after a warm-up, the
median host time of a call ending in a synchronise, and the memory the call
takes above the resident index. The two routes' ids must agree.

Prints one line per R and writes ``chiprun_out/scope_gather_crossover.json``.
The int8 index is built without its host shadow, so its searches are not
repaired; the repair is host work after either route.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex
from ragfin_tpu_torch.utils.profiling import card, device_ms

N, D, Q, K = 10_000_000, 384, 8, 10
DIVISORS = [1024, 512, 256, 128, 64, 32, 16, 8, 4, 2]
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "chiprun_out", "scope_gather_crossover.json")


class _Row:
    """A record with an id alone: the masked search reads no other field."""

    __slots__ = ("id",)

    def __init__(self, i: int):
        self.id = i


def _index(dtype: str) -> DeviceVectorIndex:
    gen = torch.Generator(device="cuda").manual_seed(20260417)
    x = torch.randn((N, D), generator=gen, device="cuda")
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
    index = DeviceVectorIndex(x, [_Row(i) for i in range(N)], dtype=dtype, normalize=False,
                              int8_shadow=False, device="cuda")
    del x
    torch.cuda.empty_cache()
    return index


def _host_ms(fn, runs: int = 20) -> float:
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _extra_bytes(fn) -> int:
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _route(index, share, q, masks, key):
    index.scope_gather_max_share = share
    fn = lambda: index._masked_topk(q, masks, key, K, 0.0, True)  # noqa: E731
    s, r = fn()  # builds and caches the route's masks
    torch.cuda.synchronize()
    return {
        "device_ms": device_ms(fn),
        "host_ms": _host_ms(fn),
        "extra_bytes": _extra_bytes(fn),
        "scores": s.cpu().numpy(),
        "ids": r.cpu().numpy(),
    }


def sweep(dtype: str) -> list[dict]:
    index = _index(dtype)
    q = np.random.default_rng(7).standard_normal((Q, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    width = int(index.matrix_t.shape[1])
    lines = []
    for div in DIVISORS:
        rows = np.arange(0, N, div)
        untyped = np.zeros(width, bool)
        untyped[rows] = True
        typed = np.zeros(width, bool)
        typed[rows[::4]] = True
        masks = [typed, untyped]
        key = (("typed", div), ("untyped", div))
        gathered = _route(index, 1.0, q, masks, key)
        dense = _route(index, 0.0, q, masks, key)
        index._device_mask_cache.clear()
        # Slots past a tier's rows are -inf, their ids unspecified.
        found = np.isfinite(dense["scores"])
        line = {
            "dtype": dtype, "n": N, "q": Q, "g": len(masks), "k": K, "r": int(rows.size),
            "r_share": f"N/{div}",
            "ids_equal": bool((np.isfinite(gathered["scores"]) == found).all()
                              and (gathered["ids"] == dense["ids"])[found].all()),
            "max_score_diff": float(np.abs(gathered["scores"] - dense["scores"])[found].max()),
        }
        for name, res in (("gathered", gathered), ("dense", dense)):
            for field in ("device_ms", "host_ms", "extra_bytes"):
                line[f"{name}_{field}"] = res[field]
        lines.append(line)
        print(f"{dtype} R={line['r']} ({line['r_share']}): gathered {line['gathered_device_ms']:.4f} ms "
              f"device, {line['gathered_host_ms']:.4f} ms host, {line['gathered_extra_bytes']} B; "
              f"dense {line['dense_device_ms']:.4f} ms device, {line['dense_host_ms']:.4f} ms host, "
              f"{line['dense_extra_bytes']} B; ids equal {line['ids_equal']}, "
              f"max score diff {line['max_score_diff']:.3g}", flush=True)
    del index
    torch.cuda.empty_cache()
    return lines


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dtypes = argv or ["float32", "int8"]
    result = {"card": card(), "torch": torch.__version__, "lines": []}
    print(f"card: {result['card']}, torch {result['torch']}", flush=True)
    for dtype in dtypes:
        result["lines"] += sweep(dtype)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(result, f, indent=1)
    return 0 if all(line["ids_equal"] for line in result["lines"]) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
