"""One-experiment kernel probe on the CUDA card.

Usage: ``python scripts/kernel_probe_torch.py <name>`` runs one experiment
and appends one line, with the card's name and power limit, to
``scripts/probe_results_h100.log``. Counterpart of ``scripts/kernel_probe.py``
for the experiments that have a meaning on the card. Device times are
medians of 20 CUDA-event timings after a warm-up.

Names:

- ``ceiling_<stage>_1m`` (stage ``dma``, ``matmul``, ``rowmax``; a numeric
  suffix overrides block_n 2048), ``ceiling_1m``, ``ceiling_tiled_1m``:
  Q = 128 bf16 over ``[384, 1M]`` bf16, flat or tile-major.
- ``ceiling_q64_<stage>`` (``mm``, ``mask``, ``rowmax``, ``prologue``; block_n
  6144): Q = 64 bf16 with the ``n_valid`` mask.
- ``ceiling_q1024_<stage>`` (``mmint``, ``rowmaxint``, ``mm``, ``rowmax``,
  ``prologue``; block_n 8192): Q = 1024 int8.
- ``fused_<f32|bf16|int8>_q<Q>``, ``tenm_fused_...`` (10M columns),
  ``canary_fused_<dtype>`` (65,536 columns, Q = 8): the fused kernels. The TPU
  table's block_n / block_q / merge-variant fields are TPU tuning and have no
  counterpart here.
- ``oracle_check``, ``oracle_check_padded``: fused ids and scores against the
  host-exact numpy oracle at N = 65,536.
- ``adversarial_1m``: columns sorted ascending by score, the worst case for a
  running merge.
- ``graph_match_10m``, ``minilm_encode``, ``[tenm_]ivf<nprobe>[bq<bq>]_<bf16|int8>_q<Q>``
  (``tenm_``: 4,883 cells of 2048, built with ``free_source=True`` from the
  only reference to the corpus, recall against the full probe).
- ``sharded_fused_1dev``, ``sharded_attrib_1dev``: the fused kernel through
  ``parallel.sharded.sharded_cosine_topk`` on a one-shard mesh against the
  direct call (N = 1M bf16, Q = 64, k = 10, both at the fast precision):
  device times, and the host time per call of each.
"""

from __future__ import annotations

import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from ragfin_tpu_torch.ops import topk as T
from ragfin_tpu_torch.ops.ceiling import ceiling
from ragfin_tpu_torch.ops.quantize import quantize_corpus_t
from ragfin_tpu_torch.utils.profiling import card, device_ms
from ragfin_tpu_torch.utils.synthetic import normal_bf16, unit_corpus_t, unit_queries

D, K = 384, 10
LOG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "probe_results_h100.log")
DEV = "cuda"


def log(line: str) -> str:
    line = f"{line} [{card()}]"
    with open(LOG, "a") as f:
        f.write(line + "\n")
    print(line)
    return line


def _gen(seed: int) -> torch.Generator:
    return torch.Generator(device=DEV).manual_seed(seed)


def ceiling_inputs(kind: str, n: int = 1_000_000):
    """(queries, corpus, scales, block_n, n_valid) of one probe family: the
    shapes and distributions of the TPU probes."""
    if kind == "q128":
        bn = 2048
        npad = -(-n // bn) * bn
        return normal_bf16((128, D), 1), normal_bf16((D, npad), 0), None, bn, None
    if kind == "q64":
        bn = 6144
        npad = -(-n // bn) * bn
        return normal_bf16((64, D), 1), normal_bf16((D, npad), 0), None, bn, n
    bn = 8192
    npad = -(-n // bn) * bn
    c8, cs = quantize_corpus_t(normal_bf16((D, npad), 0).float())
    q8 = torch.randint(-127, 127, (1024, D), generator=_gen(1), device=DEV, dtype=torch.int8)
    return q8, c8, cs, bn, n


def ceiling_probe(name: str) -> None:
    tiled = name == "ceiling_tiled_1m"
    if name in ("ceiling_1m", "ceiling_tiled_1m"):
        kind, stage, bn_override = "q128", "rowmax", None
    else:
        m = re.match(r"ceiling_(q64|q1024)_([a-z]+?)(\d+)?$", name) or re.match(
            r"ceiling_()([a-z]+?)(\d+)?_1m$", name
        )
        if not m:
            raise SystemExit(f"unknown ceiling probe: {name}")
        kind, stage = m.group(1) or "q128", m.group(2)
        bn_override = int(m.group(3)) if m.group(3) else None
    q, ct, cs, bn, n_valid = ceiling_inputs(kind)
    if bn_override:
        bn = bn_override
        if ct.shape[1] % bn:
            ct = ct[:, : ct.shape[1] // bn * bn].contiguous()
            cs = None if cs is None else cs[:, : ct.shape[1]].contiguous()
    if tiled:
        ct, bn = T.tile_corpus_t(ct, block_n=bn), None
    ms = device_ms(lambda: ceiling(q, ct, stage, bn, n_valid=n_valid, scales=cs))
    gbs = ct.numel() * ct.element_size() / ms / 1e6
    log(
        f"{name} {str(ct.dtype).replace('torch.', '')} Q={q.shape[0]} "
        f"bn={bn or ct.shape[2]}{' tile-major' if tiled else ''}: {ms:.4f} ms/batch "
        f"({gbs:,.0f} GB/s of one corpus read)"
    )


def fused_inputs(dtype: str, n: int, seed: int = 0):
    ct = unit_corpus_t(n, seed)
    if dtype == "int8":
        return quantize_corpus_t(ct.float())
    return (ct.float() if dtype == "f32" else ct), None


def fused_call(dtype: str, qs, corpus, scales, k: int, n_valid=None):
    if dtype == "int8":
        return T.cosine_topk_fused_int8(qs, corpus, scales, k, n_valid=n_valid)
    precision = "exact" if dtype == "f32" else "fast"
    return T.cosine_topk_fused(qs, corpus, k, n_valid=n_valid, precision=precision)


def fused_probe(name: str) -> None:
    m = re.match(r"(tenm_|canary_)?fused_(f32|bf16|int8)(?:_q(\d+))?$", name)
    if not m:
        raise SystemExit(f"unknown fused probe: {name}")
    scale, dtype, q = m.group(1), m.group(2), int(m.group(3) or 8)
    n = {"tenm_": 10_000_000, "canary_": 65_536, None: 1_000_000}[scale]
    corpus, scales = fused_inputs(dtype, n)
    qs = unit_queries((q, D))
    ms = device_ms(lambda: fused_call(dtype, qs, corpus, scales, K, n_valid=n))
    log(f"{name} N={n}: {ms:.4f} ms/batch ({q / ms * 1e3:,.0f} QPS)")


def numpy_oracle(q: np.ndarray, ct: np.ndarray, k: int, n_valid: int):
    """Host-exact top-k: f64 scores, stable descending sort (lowest id on a tie)."""
    scores = q.astype(np.float64) @ ct[:, :n_valid].astype(np.float64)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, order, axis=1), order


def oracle_check(padded: bool) -> None:
    n, q, k = 65_536, 64, 10
    n_valid = n - 1234 if padded else n
    ct = unit_corpus_t(n, 3).float()
    qs = unit_queries((q, D), 4)
    s, i = T.cosine_topk_fused(qs, ct, k, n_valid=n_valid, precision="exact")
    so, io = numpy_oracle(qs.cpu().numpy(), ct.cpu().numpy(), k, n_valid)
    ids_match = bool((i.cpu().numpy() == io).all())
    err = float(np.abs(s.cpu().numpy() - so).max())
    extra = ""
    if padded:
        c8, cs = quantize_corpus_t(ct)
        s8, i8 = T.cosine_topk_fused_int8(qs, c8, cs, k, n_valid=n_valid)
        s8p, i8p = T.fused_topk_int8_plain(qs, c8, cs, k, n_valid=n_valid)
        extra = (
            f" int8_ids_match={bool((i8 == i8p).all())}"
            f" int8_score_err={float((s8 - s8p).abs().max()):.2e}"
        )
        assert int(i.max()) < n_valid and int(i8.max()) < n_valid
    log(
        f"{'oracle_check_padded' if padded else 'oracle_check'} N={n}: "
        f"ids_match={ids_match} max_score_err={err:.2e}{extra}"
    )
    assert ids_match


def adversarial_1m() -> None:
    n, q = 1_000_000, 64
    d0 = torch.randn(D, generator=_gen(9), device=DEV)
    d0 = d0 / torch.linalg.vector_norm(d0)
    x = unit_corpus_t(n)
    order = torch.argsort(d0.to(torch.bfloat16).float() @ x.float())  # ascending: later ids improve
    ct = x[:, order].contiguous()
    qs = d0[None, :] + 0.1 * torch.randn((q, D), generator=_gen(2), device=DEV)
    qs = qs / torch.linalg.vector_norm(qs, dim=1, keepdim=True)
    ms = device_ms(lambda: T.cosine_topk_fused(qs, ct, K, precision="fast"))
    base = device_ms(lambda: T.cosine_topk_fused(qs, x, K, precision="fast"))
    log(f"adversarial_1m ascending-order bf16: {ms:.4f} ms/batch (Q=64; unsorted {base:.4f} ms)")


def graph_match_10m() -> None:
    from ragfin_tpu_torch.index.graph_index import METRIC, GraphIndex

    n = 10_000_000
    g = GraphIndex(device=DEV)
    rng = np.random.default_rng(0)
    quarters = [f"Q{q}_FY{y}" for y in range(2018, 2025) for q in range(1, 5)]
    qv = g.intern_quarters(quarters)
    ev = g.intern_entities([f"Metric {i}" for i in range(512)])
    g.add_facts_bulk(
        quarter_ids=qv[rng.integers(0, len(qv), n)],
        entity_ids=ev[rng.integers(0, len(ev), n)],
        type_ids=rng.integers(0, 4, n).astype(np.int32),
        values=rng.uniform(1, 1e5, n).astype(np.float32),
    )
    t0 = time.perf_counter()
    g._pack()
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    out = g.match(quarters=["Q1_FY2024"], names=["Metric 7"], types=[METRIC], limit=30)
    assert out, "match returned nothing"
    reps = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        g.match(quarters=[f"Q{1 + i % 4}_FY2023"], names=[f"Metric {i}"], types=[METRIC], limit=30)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    agg = g.aggregate(names=["Metric 3"], field="value")
    log(
        f"graph_match_10m pack={pack_s:.1f}s match={dt * 1e3:.3f} ms "
        f"(whole call, host included), aggregate_count={agg['count']}"
    )


def minilm_encode() -> None:
    """MiniLM-L6 batch-encode throughput: random weights from a seed (the
    same work as pretrained ones), B = 256 texts of S = 128 tokens, bf16."""
    from ragfin_tpu_torch.models.minilm import MiniLMConfig, MiniLMEncoder

    cfg = MiniLMConfig()
    b, s = 256, 128
    torch.manual_seed(0)
    enc = MiniLMEncoder(cfg).to(DEV).eval()
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size, (b, s))).to(DEV)
    mask = torch.ones((b, s), dtype=torch.int32, device=DEV)
    with torch.inference_mode():
        ms = device_ms(lambda: enc(ids, mask))
    log(f"minilm_encode B={b} S={s} bf16: {ms:.3f} ms/batch ({b / ms * 1e3:,.0f} chunks/s)")


def ivf_probe(name: str) -> None:
    from ragfin_tpu_torch.ops.ivf import build_ivf, ivf_topk

    m = re.match(r"(tenm_)?ivf(\d+)(?:bq(\d+))?_(bf16|int8)_q(\d+)$", name)
    if not m:
        raise SystemExit(f"unknown ivf probe: {name}")
    tenm, dtype = m.group(1), m.group(4)
    nprobe, bq, q = int(m.group(2)), int(m.group(3) or 128), int(m.group(5))
    # Cell-aligned at 10M, so that the build makes no padded copy.
    n, k = (4883 * 2048 if tenm else 1_000_000), 10
    g = _gen(0)
    centers = torch.randn((256, D), generator=g, device=DEV)
    which = torch.randint(0, 256, (n,), generator=g, device=DEV)
    x = centers.T.to(torch.bfloat16)[:, which] * 4.0 + normal_bf16((D, n), 7)
    nrm = torch.linalg.vector_norm(x.float(), dim=0, keepdim=True).clamp_min(1e-12)
    ct = (x.float() / nrm).to(torch.bfloat16)
    picks = torch.randint(0, n, (q,), generator=_gen(5), device=DEV)
    qs = ct[:, picks].T.float() + 0.1 * torch.randn((q, D), generator=_gen(6), device=DEV)
    qs = qs / torch.linalg.vector_norm(qs, dim=1, keepdim=True)
    del x, nrm
    if tenm:
        # Hand build_ivf the only reference (list.pop), so free_source frees
        # the corpus before the final layout; the recall oracle is then the
        # full probe, which equals the exact search over the same corpus.
        holder = [ct]
        ct = None
        idx = build_ivf(holder.pop(), cell=2048, iters=3, quantize=(dtype == "int8"), free_source=True)
        _, io = ivf_topk(qs, idx, k, nprobe=idx.n_cells, block_q=bq)
    else:
        idx = build_ivf(ct, cell=2048, iters=3, quantize=(dtype == "int8"))
        _, io = T.cosine_topk_fused(qs, ct, k, precision="fast")
    _, ii = ivf_topk(qs, idx, k, nprobe=nprobe, block_q=bq)
    io, ii = io.cpu().numpy(), ii.cpu().numpy()
    recall = float(np.mean([len(set(ii[r]) & set(io[r])) / k for r in range(q)]))
    ms = device_ms(lambda: ivf_topk(qs, idx, k, nprobe=nprobe, block_q=bq))
    log(
        f"{name} N={n}: {ms:.4f} ms/batch ({q / ms * 1e3:,.0f} QPS) "
        f"recall@10={recall:.4f} nprobe={nprobe}/{idx.n_cells}"
    )


def sharded_probe(name: str) -> None:
    """The fused kernel through the sharded program on a one-shard mesh
    against the direct call: device ms (CUDA events) and host ms per call
    (host clock over 20 calls, one synchronize after the last)."""
    from ragfin_tpu_torch.parallel.mesh import make_mesh, shard
    from ragfin_tpu_torch.parallel.sharded import sharded_cosine_topk

    n, q = 1_000_000, 64
    ct = normal_bf16((D, n), 0)
    qs = torch.randn((q, D), generator=_gen(1), device=DEV)
    mesh = make_mesh(("data",), devices=[DEV])
    parts = shard(mesh, "data", ct, 1)
    direct = lambda: T.cosine_topk_fused(qs, ct, K, n_valid=n, precision="fast")
    sharded = lambda: sharded_cosine_topk(mesh, "data", qs, parts, K, n_valid=n, method="fused",
                                          precision="fast")
    for a, b in zip(direct(), sharded()):
        if not torch.equal(a, b):
            raise SystemExit("the sharded program on one shard differs from the direct call")

    def host_ms(fn, reps: int = 20) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    a, b = device_ms(direct), device_ms(sharded)
    if name == "sharded_fused_1dev":
        log(f"{name} N={n} bf16 Q={q} k={K}: sharded {b:.4f} ms/batch (direct {a:.4f})")
        return
    ha, hb = host_ms(direct), host_ms(sharded)
    log(f"{name} N={n} bf16 Q={q} k={K}: device direct={a:.4f} sharded={b:.4f} ms "
        f"(wrapper {b - a:+.4f}); host per call direct={ha:.4f} sharded={hb:.4f} ms ({hb - ha:+.4f})")


def main(name: str) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe_torch.py: no CUDA device; the probes time the card")
    if name.startswith("ceiling_"):
        return ceiling_probe(name)
    if name in ("sharded_fused_1dev", "sharded_attrib_1dev"):
        return sharded_probe(name)
    if "fused_" in name:
        return fused_probe(name)
    if name in ("oracle_check", "oracle_check_padded"):
        return oracle_check(padded=name.endswith("padded"))
    if name == "adversarial_1m":
        return adversarial_1m()
    if name == "graph_match_10m":
        return graph_match_10m()
    if name == "minilm_encode":
        return minilm_encode()
    if name.startswith(("ivf", "tenm_ivf")):
        return ivf_probe(name)
    raise SystemExit(f"unknown experiment: {name}")


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1])
