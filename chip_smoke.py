#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (ragfin_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # the full check, as a release gate
    python3 chip_smoke.py --kernels  # phases 1 and 2 only (build, kernel checks)

Phases (any failure exits nonzero, and no phase carries on past one):

1. Device and build: the card's name and power limit from nvidia-smi, then
   every kernel in ragfin_tpu_torch/csrc/ built with nvcc (one process per
   source, all started together).
2. Kernels against their plain PyTorch versions, on seeded unit embeddings
   at D = 384, N = 1,000,000, n_valid not a multiple of any tile, for
   Q in {1, 8, 64} and k in {3, 64, 70}: f32 "exact", bf16 "fast", int8.
   Duplicated corpus columns make exact ties, which must come back lowest
   id first. f32/bf16 scores agree within 1e-5 (the kernel and cuBLAS sum in
   different orders); int8 scores are bitwise equal (the integer dot is
   exact). Ids must be equal wherever neighbouring scores differ by more
   than the tolerance. Each kernel is timed with CUDA events (median of 20
   runs after warm-up) beside its plain version, torch.matmul + torch.topk
   (a yardstick only), and the card's bound for the same work.
3. Main path: RagFinEngine (trained encoder, f32 index) over 131,072
   generated filings answers questions through VectorRAG.search and
   search_and_answer, some concurrently through the batcher. The filings
   are of the seven banks other than the pipeline's default company, so a
   question that names no bank falls through the company tiers to the
   unscoped search, which is the fused kernel's path. The kernels' launch
   counters are set to 0 just before and read just after; the hits are held
   against the same searches with method="dense". Then an int8 index over
   the same embeddings answers one request set through the int8 kernel.

The last line is {"ok": true, "device": {...}}; the line before it is the
kernel table as JSON.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import statistics
import subprocess
import sys
import threading
import time

D = 384
N_KERNEL = 1_000_000
N_MAIN = 131_072
SEED = 0
F32_TOL = 1e-5
# Served (batched) against single searches: the bf16 encoder's output moves
# by ~1e-4 with the padded shape of the batch a query was encoded in.
BATCH_TOL = 1e-3
# H100 SXM peaks (NVIDIA data sheet, dense): FP32 cores, bf16 and int8
# tensor cores, HBM3.
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def bound(q: int, n: int, k: int, corpus: str, ops_type: str) -> tuple[float, str]:
    """Least time for one fused top-k call on an H100 SXM: the larger of its
    bytes (corpus, int8 scales, queries, outputs, each once) over the memory
    rate and its 2*Q*N*D operations over the peak rate of their type."""
    item = {"float32": 4, "bfloat16": 2, "int8": 1}[corpus]
    nbytes = D * n * item + (4 * n if corpus == "int8" else 0) + q * D * 4 + q * k * 8
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = 2.0 * q * n * D / PEAK_OPS[ops_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, runs: int = 20, warmup: int = 3) -> float:
    """Median of ``runs`` CUDA-event timings of fn() after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ids_agree(ref_s, ref_i, got_i, tol: float) -> bool:
    """Ids equal wherever the reference score differs from both neighbours
    by more than ``tol`` (inside a band of closer scores, two float sums may
    order ids differently). ``ref_s`` may carry one extra column (the k+1th
    score) for the last position's gap."""
    import numpy as np

    k = got_i.shape[1]
    s = ref_s.astype(np.float64)
    with np.errstate(invalid="ignore"):
        gaps = np.abs(np.diff(s, axis=1))  # [Q, width - 1]
    gaps = np.where(np.isnan(gaps), 0.0, gaps)
    prev = np.concatenate([np.full((s.shape[0], 1), np.inf), gaps], axis=1)[:, :k]
    nxt = np.concatenate([gaps, np.full((s.shape[0], 1), np.inf)], axis=1)[:, :k]
    strict = (prev > tol) & (nxt > tol)
    return bool(np.array_equal(ref_i[:, :k][strict], got_i[strict]))


# --- phase 2 -------------------------------------------------------------


def kernel_phase(torch, topk) -> dict:
    import numpy as np

    dev = torch.device("cuda")
    n = N_KERNEL
    n_valid = n - 63  # 999,937 at 1M: prime, not a multiple of any tile width
    gen = torch.Generator(device=dev).manual_seed(SEED)
    corpus = torch.randn((n, D), generator=gen, device=dev)
    # Exact ties: 64 source rows, each copied to 7 other places spread over
    # the corpus (different chunks of the kernel's grid).
    src = torch.arange(64, device=dev) * 97
    for rep in range(1, 8):
        corpus[src + rep * (n // 8) + 11] = corpus[src]
    corpus = corpus / torch.linalg.vector_norm(corpus, dim=1, keepdim=True)
    ct32 = corpus.T.contiguous()
    del corpus
    ct16 = ct32.to(torch.bfloat16)
    from ragfin_tpu_torch.ops.quantize import quantize_corpus_t

    ct8, sc8 = quantize_corpus_t(ct32)
    tiled = topk.tile_corpus_t(ct32, 2048)
    qgen = torch.Generator(device=dev).manual_seed(SEED + 1)
    q_all = torch.randn((64, D), generator=qgen, device=dev)
    q_all = q_all / torch.linalg.vector_norm(q_all, dim=1, keepdim=True)
    q_all[:8] = ct32[:, src[:8]].T  # tie-heavy rows: each matches 8 equal columns
    q_all[8] = 0.0  # all-zero row: every score 0, lowest ids first

    cases = [(1, 3), (8, 64), (64, 64), (64, 70)]
    errs = {"fused_topk": 0.0, "fused_topk_int8": 0.0}
    f32 = topk.cosine_topk_fused
    i8 = topk.cosine_topk_fused_int8
    for q_n, k in cases:
        q = q_all[:q_n].contiguous()
        variants = [
            ("f32 exact", lambda: f32(q, ct32, k, n_valid=n_valid),
             lambda kk: topk.fused_topk_plain(q, ct32, kk, n_valid=n_valid)),
            ("f32 tile-major", lambda: f32(q, tiled, k, n_valid=n_valid),
             lambda kk: topk.fused_topk_plain(q, tiled, kk, n_valid=n_valid)),
            ("bf16 fast", lambda: f32(q, ct16, k, n_valid=n_valid, precision="fast"),
             lambda kk: topk.fused_topk_plain(q, ct16, kk, n_valid=n_valid, precision="fast")),
        ]
        for label, run, plain in variants:
            s, i = run()
            torch.cuda.synchronize()
            ps, pi = plain(k + 1)
            s, i, ps, pi = (x.cpu().numpy() for x in (s, i, ps, pi))
            if s.shape != (q_n, k) or not np.isfinite(s[:, : min(k, n_valid)]).all():
                raise AssertionError(f"{label} Q={q_n} k={k}: bad output {s.shape}")
            err = float(np.max(np.abs(s - ps[:, :k])))
            errs["fused_topk"] = max(errs["fused_topk"], err)
            if err > F32_TOL:
                raise AssertionError(f"{label} Q={q_n} k={k}: max |score err| {err} > {F32_TOL}")
            if not ids_agree(ps, pi, i, F32_TOL):
                raise AssertionError(f"{label} Q={q_n} k={k}: ids differ outside tie bands")
            check_ties(np, label, q_n, k, s, i, src, n)
        s, i = i8(q, ct8, sc8, k, n_valid=n_valid)
        torch.cuda.synchronize()
        ps, pi = topk.fused_topk_int8_plain(q, ct8, sc8, k, n_valid=n_valid)
        s, i, ps, pi = (x.cpu().numpy() for x in (s, i, ps, pi))
        if not (np.array_equal(s, ps) and np.array_equal(i, pi)):
            raise AssertionError(f"int8 Q={q_n} k={k}: not bitwise equal to the plain version")
        check_ties(np, "int8", q_n, k, s, i, src, n)
        print(f"kernel check Q={q_n} k={k}: f32/tile-major/bf16 within {F32_TOL}, "
              f"int8 bitwise equal", flush=True)

    # Timing at the main path's widths: k = 64 (f32) and 70 (int8 shortlist).
    rows = {}
    for q_n in (1, 8, 64):
        q = q_all[:q_n].contiguous()
        for name, corpus_dtype, ops_type, k, run, plain, lib in (
            ("fused_topk", "float32", "float32", 64,
             lambda: f32(q, ct32, 64, n_valid=n_valid),
             lambda: topk.fused_topk_plain(q, ct32, 64, n_valid=n_valid),
             lambda: torch.topk(torch.matmul(q, ct32), 64)),
            ("fused_topk[bf16 fast]", "bfloat16", "bfloat16", 64,
             lambda: f32(q, ct16, 64, n_valid=n_valid, precision="fast"),
             lambda: topk.fused_topk_plain(q, ct16, 64, n_valid=n_valid, precision="fast"),
             lambda: torch.topk(torch.matmul(q.to(torch.bfloat16), ct16), 64)),
            ("fused_topk_int8", "int8", "int8", 70,
             lambda: i8(q, ct8, sc8, 70, n_valid=n_valid),
             lambda: topk.fused_topk_int8_plain(q, ct8, sc8, 70, n_valid=n_valid),
             None),
        ):
            ms = time_ms(torch, run)
            plain_ms = time_ms(torch, plain)
            lib_ms = time_ms(torch, lib) if lib is not None else None
            b_ms, b_by = bound(q_n, n, k, corpus_dtype, ops_type)
            rows[(name, q_n)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                     bound_ms=b_ms, bound_by=b_by, k=k)
            print(f"kernel {name} Q={q_n} N={n} k={k}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
                  f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of bound", flush=True)
    for q_n, label, fn in (
        (1, "fused_topk f32", lambda q: f32(q, ct32, 64, n_valid=n_valid)),
        (64, "fused_topk f32", lambda q: f32(q, ct32, 64, n_valid=n_valid)),
        (64, "fused_topk_int8", lambda q: i8(q, ct8, sc8, 70, n_valid=n_valid)),
    ):
        profile_breakdown(torch, label, q_n, lambda: fn(q_all[:q_n].contiguous()))
    # The dispatcher's threshold (topk.FUSED_MIN_N): fused kernel against
    # the dense tier (cuBLAS f32 product + stable sort) around it.
    for n_cut in (16384, 65536, 131072, 262144):
        c = ct32[:, :n_cut].contiguous()
        line = []
        for q_n in (1, 8, 64):
            q = q_all[:q_n].contiguous()
            fused_ms = time_ms(torch, lambda: f32(q, c, 64))
            dense_ms = time_ms(torch, lambda: topk.cosine_topk_dense(q, c, 64))
            line.append(f"Q={q_n} fused {fused_ms:.4f} ms dense {dense_ms:.4f} ms")
        print(f"threshold N={n_cut} k=64: " + "; ".join(line), flush=True)
    f32.launches = 0
    i8.launches = 0
    return {"rows": rows, "errs": errs, "n": n}


def profiled(torch, fn, reps: int) -> tuple[list[tuple[float, str]], float]:
    """Run fn() ``reps`` times under torch.profiler: (device ms per call of
    each CUDA kernel and copy, largest first; host wall ms per call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    parts = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        # Host-side entries (aten ops, CUDA runtime calls) also carry their
        # kernels' device time; only the kernels and copies are counted.
        if dev_us and ev.key and not ev.key.startswith(("cuda", "aten::")):
            parts.append((dev_us / reps / 1e3, ev.key.split("(")[0][:60]))
    parts.sort(reverse=True)
    return parts, wall_ms


def profile_breakdown(torch, label: str, q_n: int, fn, reps: int = 10) -> None:
    """Device time per CUDA kernel of one call, from torch.profiler."""
    parts, _ = profiled(torch, fn, reps)
    parts = [p for p in parts if not p[1].startswith("Memcpy")]
    text = ", ".join(f"{name} {ms:.4f} ms" for ms, name in parts[:6]) or "no device time seen"
    print(f"profile {label} Q={q_n} (per call): {text}", flush=True)


def request_breakdown(torch, rag, question: str, reps: int = 5) -> dict:
    """One request, alone, under torch.profiler: host wall time beside the
    device time of the kernels it launched; the rest is the device's idle
    share (tokenising, filter planning, host post-processing, launches)."""
    parts, wall_ms = profiled(torch, lambda: rag.search(question, top_k=3), reps)
    busy_ms = sum(ms for ms, _ in parts)
    top = ", ".join(f"{name} {ms:.3f} ms" for ms, name in parts[:6]) or "no device time seen"
    print(f"request {question!r} alone: wall {wall_ms:.2f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.1%}; kernels: {top}", flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms}


def check_ties(np, label, q_n, k, s, i, src, n):
    """Rows 0..7 are copies of corpus column src[r], which has 7 exact
    duplicates: the top 8 must be those 8 columns, ascending, equal scores.
    Row 8 is all zeros: all scores 0, ids 0..k-1."""
    for r in range(min(q_n, 8)):
        want = np.sort([int(src[r]) + rep * (n // 8) + (11 if rep else 0) for rep in range(8)])
        got = i[r, :8] if k >= 8 else i[r, :k]
        if not np.array_equal(got, want[: len(got)]):
            raise AssertionError(f"{label} Q={q_n} k={k}: tie row {r} ids {got} != {want}")
        if k >= 8 and len(set(s[r, :8].tolist())) != 1:
            raise AssertionError(f"{label} Q={q_n} k={k}: tied scores differ {s[r, :8]}")
    if q_n > 8 and not (np.array_equal(i[8], np.arange(k)) and (s[8] == 0).all()):
        raise AssertionError(f"{label} Q={q_n} k={k}: zero row gave {i[8][:5]} {s[8][:5]}")


# --- phase 3 -------------------------------------------------------------


def questions(chunks) -> tuple[list[str], list[str]]:
    """Scoped questions (a bank and period in the corpus) and unscoped ones
    (no bank named: the default company has no filings here)."""
    scoped, seen = [], set()
    templates = {
        "profitability_analysis": "What was {bank}'s net profit in {q} {fy}?",
        "balance_sheet_analysis": "What were {bank}'s total customer deposits in {q} {fy}?",
        "financial_ratios": "What was the basic EPS of {bank} for {q} {fy}?",
        "segment_analysis": "How did {bank}'s treasury segment revenue do in {q} {fy}?",
    }
    for c in chunks[::997]:
        key = (c.company, c.period, c.chunk_type)
        if key in seen:
            continue
        seen.add(key)
        q, fy = c.period.split("_")
        scoped.append(templates[c.chunk_type].format(bank=c.company, q=q, fy=fy))
        if len(scoped) == 12:
            break
    unscoped = [
        "What was the net profit?",
        "How did the bottom line move this quarter?",
        "What were total customer deposits and advances?",
        "Which segment had the highest revenue?",
        "What was the basic EPS growth?",
        "Net profit in Q1 FY2024",
        "What were the provisions and cost ratio?",
        "Total assets and borrowings",
        "Operating profit margin",
        "How large was the life insurance segment result?",
        "Compare interest income and other income",
        "What was diluted EPS per share?",
    ]
    return scoped, unscoped


def hits_agree(a: list[dict], b: list[dict], tol: float) -> bool:
    """Two hit lists agree: same length, scores within ``tol`` rank by rank,
    and ids equal except inside tie bands (see ids_agree)."""
    import numpy as np

    if len(a) != len(b):
        return False
    if not a:
        return True
    sa = np.array([[h["score"] for h in a]])
    sb = np.array([[h["score"] for h in b]])
    if np.max(np.abs(sa - sb)) > tol:
        return False
    ids = {h["id"]: j for j, h in enumerate(a + b)}
    ia = np.array([[ids[h["id"]] for h in a]])
    ib = np.array([[ids[h["id"]] for h in b]])
    # The last rank's successor is unknown: compare its score only.
    return ids_agree(sa, ia, ib[:, :-1], tol)


def main_path_phase(torch, topk) -> dict:
    import numpy as np

    from ragfin_tpu_torch.config.settings import Settings
    from ragfin_tpu_torch.eval.distractors import generate_distractors
    from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex
    from ragfin_tpu_torch.serving.engine import RagFinEngine

    n_main = N_MAIN
    t0 = time.perf_counter()
    pool = generate_distractors(int(n_main * 1.16), seed=SEED)
    chunks = [c for c in pool if c.company != "ICICI Bank"][:n_main]
    if len(chunks) != n_main:
        raise AssertionError(f"generated {len(chunks)} chunks, wanted {n_main}")
    gen_s = time.perf_counter() - t0
    settings = Settings(embed_backend="trained", index_dtype="float32", batch_queries=True)
    t0 = time.perf_counter()
    engine = RagFinEngine(settings=settings, chunks=chunks)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    index = engine.vector_index
    if index.n != n_main or index.dtype != torch.float32 or not index.matrix_t.is_cuda:
        raise AssertionError(f"unexpected index {index.stats()}")
    health = engine.health()
    print(f"main path: {n_main} chunks generated in {gen_s:.1f} s; engine built "
          f"(tokenise + encode + pack) in {build_s:.1f} s = {n_main / build_s:.0f} chunks/s; "
          f"health {json.dumps(health)}", flush=True)
    # Encoder alone on the card: pre-tokenised 4,096 chunks.
    emb = index.embedder
    texts = [c.text for c in chunks[:4096]]
    ids, mask = emb.tokenizer.encode_batch(texts, pad_multiple=emb.pad_multiple)
    ids_t = torch.from_numpy(ids.astype(np.int64)).to(index.device)
    mask_t = torch.from_numpy(mask).to(index.device)

    def encode_only():
        with torch.inference_mode():
            for s in range(0, len(texts), emb.batch_size):
                emb.model(ids_t[s : s + emb.batch_size], mask_t[s : s + emb.batch_size])

    enc_ms = time_ms(torch, encode_only, runs=3, warmup=1)
    print(f"encoder forward on the card: {len(texts)} chunks x {ids.shape[1]} tokens in "
          f"{enc_ms:.1f} ms = {len(texts) / enc_ms * 1e3:.0f} chunks/s", flush=True)

    engine.warmup()
    scoped, unscoped = questions(chunks)
    rag = engine.vector_rag
    torch.cuda.synchronize()

    # ---- the driven run: counters 0 just before, read just after -------
    topk.cosine_topk_fused.launches = 0
    topk.cosine_topk_fused_int8.launches = 0
    latencies: list[float] = []
    results: dict[str, list[dict]] = {}
    answers: dict[str, dict] = {}
    lock = threading.Lock()

    def ask(q: str) -> None:
        t = time.perf_counter()
        hits = rag.search(q, top_k=3)
        dt = time.perf_counter() - t
        with lock:
            latencies.append(dt)
            results[q] = hits

    for q in scoped[:4] + unscoped[:4]:  # one at a time
        ask(q)
    sequential = list(latencies)
    threads = [threading.Thread(target=ask, args=(q,)) for q in scoped[4:] + unscoped[4:]]
    for th in threads:  # concurrent: the batcher groups them
        th.start()
    for th in threads:
        th.join()

    async def answer_all(qs):
        async def one(q):
            t = time.perf_counter()
            r = await rag.search_and_answer(q, top_k=3)
            latencies.append(time.perf_counter() - t)
            answers[q] = r
        await asyncio.gather(*(one(q) for q in qs))

    asyncio.run(answer_all(scoped[:6] + unscoped[:6]))
    torch.cuda.synchronize()
    launches = {
        "fused_topk": topk.cosine_topk_fused.launches,
        "fused_topk_int8": topk.cosine_topk_fused_int8.launches,
    }
    # --------------------------------------------------------------------
    n_requests = len(results) + len(answers)
    if n_requests < 16 or len(results) != len(scoped) + len(unscoped):
        raise AssertionError(f"only {n_requests} requests answered")
    if launches["fused_topk"] < 1:
        raise AssertionError("the main path never launched the fused f32 kernel")
    for q, hits in results.items():
        if not hits or not all(np.isfinite(h["score"]) for h in hits):
            raise AssertionError(f"no finite hits for {q!r}")
    for q, r in answers.items():
        if r.get("answer_mode") not in ("extractive", "conflict") or not r.get("answer"):
            raise AssertionError(f"no answer for {q!r}: {r}")
    # The same searches with the dense tier (plain torch on the card).
    searcher = rag._searcher
    wide = rag._detection_fetch(3)
    mismatched = []
    for q in scoped + unscoped:
        fused = [h.to_dict(False) for h in searcher.search_texts([q], top_k=wide)[0]]
        dense = [h.to_dict(False) for h in searcher.search_texts([q], top_k=wide, method="dense")[0]]
        # Served hits came from batched encodes: a query's bf16 embedding
        # moves by ~1e-4 with its batch's padded shape, hence BATCH_TOL.
        if not (hits_agree(dense, fused, F32_TOL) and hits_agree(fused[:3], results[q], BATCH_TOL)):
            mismatched.append(q)
            for label, hits in (("dense", dense), ("fused", fused), ("served", results[q])):
                print(f"  {label}: {[(h['id'], h['score']) for h in hits[:8]]}", file=sys.stderr)
    if mismatched:
        raise AssertionError(f"fused and dense hits differ for {mismatched}")
    p50 = statistics.median(latencies) * 1e3
    p50_alone = statistics.median(sequential) * 1e3
    print(f"main path: {n_requests} requests, p50 latency {p50:.2f} ms "
          f"(one at a time: {p50_alone:.2f} ms), launches {launches}, "
          f"hits equal to method='dense' for all {len(scoped) + len(unscoped)} questions",
          flush=True)
    sample = answers[unscoped[0]]
    print(f"sample answer ({unscoped[0]!r}): {sample['answer'][:160]!r}", flush=True)
    for q in (unscoped[0], scoped[0]):
        request_breakdown(torch, rag, q)

    # ---- int8 index over the same embeddings ---------------------------
    emb_rows = index.matrix_t[:, : index.n].T.contiguous()
    idx8 = DeviceVectorIndex(emb_rows, chunks, dtype="int8", normalize=False)
    idx8.embedder = index.embedder
    engine8 = RagFinEngine(settings=Settings(embed_backend="trained", index_dtype="int8"),
                           vector_index=idx8)
    request_set = unscoped + scoped[:4]
    engine8.vector_rag.search(request_set[0], top_k=3)  # first call pays one-time costs
    topk.cosine_topk_fused.launches = 0
    topk.cosine_topk_fused_int8.launches = 0
    hits8 = {q: engine8.vector_rag.search(q, top_k=3) for q in request_set}
    torch.cuda.synchronize()
    launches8 = topk.cosine_topk_fused_int8.launches
    if launches8 < 1:
        raise AssertionError("the int8 request set never launched the int8 kernel")
    # After the host re-score the int8 tier's order is exact f32: it must
    # agree with the f32 engine's hits (tie bands aside).
    diff8 = [q for q in request_set if not hits_agree(results[q], hits8[q], BATCH_TOL)]
    if diff8:
        raise AssertionError(f"int8 engine hits differ from the f32 engine's for {diff8}")
    print(f"int8 index: {len(request_set)} requests, int8 kernel launches {launches8}, "
          f"hits equal to the f32 engine's", flush=True)
    engine8.close()
    engine.close()
    launches["fused_topk_int8"] = launches8
    return {"launches": launches, "p50_ms": p50}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true",
                    help="build, check and time the kernels only (phases 1 and 2)")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this check runs only on the card")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from ragfin_tpu_torch.ops import _cuda, topk
    except ImportError as e:
        return fail(f"the ragfin_tpu_torch package is not beside this script ({e})")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    logs = _cuda.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line.lower():
                print(f"ptxas {name}: {line.strip()}", flush=True)

    kern = kernel_phase(torch, topk)
    if args.kernels:
        return 0
    main_path = main_path_phase(torch, topk)

    rows = kern["rows"]
    table = []
    for name, src, replaces in (
        ("fused_topk", "ragfin_tpu_torch/csrc/fused_topk.cu",
         "ragfin_tpu/ops/topk.py:752"),
        ("fused_topk_int8", "ragfin_tpu_torch/csrc/fused_topk_int8.cu",
         "ragfin_tpu/ops/topk.py:1024"),
    ):
        r = rows[(name, 64)]
        table.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": main_path["launches"][name],
            "max_abs_err": kern["errs"][name],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": {"Q": 64, "N": kern["n"], "D": D, "k": r["k"]},
        })
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
