#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (ragfin_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # the full check, as a release gate
    python3 chip_smoke.py --kernels  # phases 1, 2, 4, 6 and 7 only (build, kernels alone)
    python3 chip_smoke.py --graph    # phases 1, 4 and 5 only (build, first-k, graph store)
    python3 chip_smoke.py --sweep    # also the IVF and int8 grid-rule and first-k span sweeps
    python3 chip_smoke.py --parallel # phases 1 and 10 only (build, the parallel layer)
    python3 chip_smoke.py --drivers  # phases 1 and 11 only (build, the drivers outside the package)

Phases (any failure exits nonzero, and no phase carries on past one):

1. Device and build: the card's name and power limit from nvidia-smi, then
   every kernel in ragfin_tpu_torch/csrc/ built with nvcc (one process per
   source, all started together), and the ptxas line (registers, spills) of
   every pass-1 instantiation (f32, bf16, int8: the selection and every
   ceiling stage), of pass 2 and of every merge case; any spill fails. Then
   the merge cases, the selection's primitives (the nine Pallas bisect
   cases, and the queue push, bitonic sort, bitonic merge and bound filter
   of the queue selection): scripts/mosaic_bisect_torch.py as a user runs
   it, with the kernel's counter at 0 just before and read just after, and
   each case bitwise against its plain version, timed.
2. Kernels against their plain PyTorch versions, on seeded unit embeddings
   at D = 384, N = 1,000,000, n_valid not a multiple of any tile, for
   Q in {1, 8, 64, 1024} and k in {3, 64, 70}: f32 "exact", bf16 "exact"
   (f32 queries), bf16 "fast", int8 (flat and tile-major). The ids of every path must also
   equal those of an f64 oracle on the same inputs outside tie bands (int8: the
   exact int dot times the scales in f64).
   Duplicated corpus columns make exact ties, which must come back lowest
   id first. f32/bf16 scores agree within 1e-5 (the kernel and cuBLAS sum in
   different orders); int8 scores are bitwise equal (the integer dot is
   exact). Ids must be equal wherever neighbouring scores differ by more
   than the tolerance. Each kernel is timed with CUDA events (median of 20
   runs after warm-up) beside its plain version, torch.matmul + torch.topk
   (int8: torch._int_mm + torch.topk, the queries padded to 32 rows where
   _int_mm needs more than 16; a yardstick only), and the card's bound for
   the same work, at Q = 1, 8 and 64 (int8 also 1024); pass 1 and pass 2
   apart from torch.profiler; and the stage ladder of pass 1 (the ceiling
   stages at the fused grid beside pass 1, pass 2 and the whole call) at
   Q = 64 and, f32 and bf16, Q = 8.
3. Main path: RagFinEngine (trained encoder, f32 index) over 131,072
   generated filings answers questions through VectorRAG.search and
   search_and_answer, some concurrently through the batcher. The filings
   are of the seven banks other than the pipeline's default company, so a
   question that names no bank falls through the company tiers to the
   unscoped search, which is the fused kernel's path. The kernels' launch
   counters are set to 0 just before and read just after; the hits are held
   against the same searches with method="dense". Then an int8 index over
   the same embeddings answers one request set through the int8 kernel.

   Hybrid, on the same engine: its graph store is built from the vector
   index by rule-based extraction (about 7 facts a filing, so the fact table
   is past the 2^18 rows from which match() takes the first-k kernel), then
   questions go through graph_builder.query, hybrid.graph_search and
   hybrid.hybrid_query with the fused top-k and first-k counters at 0 just
   before. Each graph search equals the same search with the first-k route
   forced to its plain version; fused chunks are vector hits first, then
   graph-only chunks, no repeats. IVF engine: Settings(index_type="ivf") over
   the same filings (64 cells, nprobe 32) answers questions through the
   pruned kernel; at nprobe = n_cells its hits equal the flat engine's, and
   at nprobe 32 the kernel is held against its plain version on the engine's
   own cells and probe table.
   Integrity (3b): Settings(integrity_weight=0.5) over the generated
   statements' 16 ICICI FY2024 chunks and 8,192 in-scope tampered copies
   (eval/distractors.generate_inscope_distractors); warmup must compute the
   integrity column. Weighted searches on the card (f32 and int8 indexes,
   strict and smooth, weights 0.5 and 0.95, unscoped, period-scoped, tier
   groups, VectorRAG) must equal the same searches by the port on the CPU
   over the same embeddings (ids outside 1e-5 tie bands, scores within
   1e-5), and every tampered copy that fails a check must rank below its
   source where the source passes all of its checks.
   Hashed (3c): the hashed backend (native featurizer on the host, bag
   encoder on the card) over 524,288 generated filings plus the generated
   statements' 16 ICICI chunks, engine from Settings(embed_backend="hashed")
   through get_engine: the native featurizer must be loaded; 4,096 sampled
   rows bag-encoded on the card within 2e-6 of the plain CPU encode, and rows
   with equal feature multisets bitwise equal in the served matrix; the
   fused kernel's ids for 64 queries against a host f64 oracle; six scoped
   and six unscoped questions through VectorRAG.search (FilteredSearch,
   rerank 64, query expansion) and the engine's hybrid search, counters at
   0 just before, hits equal to the dense tiers'; an int8 index loaded from
   the f32 index's persisted matrix (no second featurize), its hits equal
   with the int8 kernel's plain version in its place; an IVF index
   clustered from the f32 one (nprobe 32) through the pruned kernel, equal
   to the flat index at full probe; persist and reload of all three, equal
   hits; integrity weight 0.5 over the first 131,072 filings and the gold: a
   scoped bucket of at most exact_bucket_max rows answered on the host with
   no CUDA kernel (torch.profiler) and no launch, a larger bucket on the
   device tiers. Minilm (3d): a synthetic HF checkpoint at the
   all-MiniLM-L6-v2 widths (seeded weights, written as model.safetensors
   and pytorch_model.bin, equal when loaded), an engine with
   embed_backend="minilm" over 131,072 generated filings, the card's bf16
   forward against the CPU f32 forward (per-row cosine >= 0.999 on 256
   chunks), six questions through the fused kernel.
   Train (3e): (a) the bag encoder fine-tuned at the hashed backend's width
   (table 65,536 x 384 f32; featurizer fitted on 131,072 generated filings,
   512 of them gold filings of distinct scope cells, plus the 16 generated
   ICICI chunks; 512 generated questions whose expected ids are the gold
   filings'): finetune_and_evaluate with JAX's defaults (20 epochs, batch
   16, lr 3e-3, temperature 0.1) as `cli train` runs it, the fused kernel's
   counter at 0 just before (its launches are the two evaluations'); recall
   must not fall and the loss must; the first epoch on the card against the
   port on the CPU from the same init_table (loss within 1e-4 relative);
   steps/s over 20 epochs and one step's device time and idle share
   (torch.profiler). (b) The domain encoder warm-started from
   checkpoints/domain_encoder (50 steps of 256 pairs, query 64 and document
   192 tokens, chunks of 25) into the work directory: host seconds per chunk
   apart from device seconds, ms per step, tokens/s, peak memory, first and
   last chunk loss; the first step's loss (the parent on the first batch)
   on the card against the CPU, bf16 both (DOMAIN_LOSS_TOL); the written
   params.npz has the committed one's keys, shapes and f16; then an engine
   from Settings(embed_backend="trained", trained_checkpoint=<it>) through
   get_engine over the main path's 131,072 filings answers six unscoped
   questions through the fused kernel, hits equal to the dense tier. The
   phase writes only into the run's temporary work directory.
4. First-k alone: hit [10,000,000] int8 at hit rates 1e-3, 1.0 and 0, with
   three hits in the last rows, hits in the last span only, one hit at 0,
   k = 1, k = the hit count, a bool ragged and an unaligned vector, k = 30
   and 5,000; then 31 calls on other vectors and k with no sync between
   them, and the same on two streams at once: ids and count equal to the
   plain version. The device time of one call per rate from torch.profiler,
   which must show the first-k kernel alone, once for each launch the
   wrapper counted; the wrapper call (median of 200 CUDA-event timings)
   beside torch.nonzero(hit)[:k] and the bytes bound. With --sweep the
   kernel is also built at spans of 4-64 KB, checked and timed.
5. Graph store at scale: 10,000,000 facts through add_facts_bulk; match,
   aggregate and expand(hops=2) against a numpy oracle over the packed host
   columns; match must launch the first-k kernel.
6. IVF alone: 1,000,000 unit vectors clustered on the card by build_ivf
   (cell 2048, 489 cells, the default 4 Lloyd iterations), Q in {1, 8, 64},
   block_q 8, k 64,
   nprobe 32: the pruned kernel against its plain version for f32 "exact",
   bf16 "fast" (within 1e-5, ids equal outside tie bands) and int8
   (bitwise), every tier's ids against an f64 oracle of its probed cells
   outside tie bands, and at nprobe = n_cells against the exact fused tier; timed
   beside a gather of the probed cells + torch.matmul + torch.topk (int8:
   torch._int_mm per query tile). With
   --sweep the wrapper's grid rule (blocks per probed cell) is timed against
   fixed values.
7. Ceiling kernel alone (ops/ceiling.py, pass 1 of the fused kernels without
   the selection): at N = 1,000,000 every stage of the three probe families
   (bf16 Q = 128 block_n 2048 flat and tile-major; bf16 Q = 64 block_n 6144
   with the n_valid mask and an arg-max tie built on purpose; int8 Q = 1024
   block_n 8192, with torch._int_mm beside mmint) against ceiling_plain on
   the card: int stages bitwise, float
   stages within 1e-4 of the largest sum; the dma stage's loads are checked
   by the XOR of the loaded words; then timed. The same for the bench path's
   own call (bf16 Q = 64, N = 1,000,000 not padded, block_n the fused kernel's
   chunk), which phase 9 counts. Phase 2 prints the stage ladder (block read,
   + product, + mask, + row max, + arg-max, pass 1, pass 2, whole kernel) for
   f32, bf16 and int8 at Q = 64 (f32 and bf16 also at Q = 8) on its own corpus
   (n_valid = N - 63, ragged last tile), every stage held against
   ceiling_plain before it is timed. The row-max and arg-max stages keep
   each lane's best in registers across the probe tile, as the selection's
   gate keeps its thresholds.
8. Served: a chunk snapshot of 131,072 generated filings on disk, the engine
   from Settings(chunks_snapshot, index_dir) through get_engine, launch() of
   all seven services on ephemeral ports, and over HTTP /health on each,
   /search and /answer on the vector adapter (MCP client and server between),
   tools/call for search_vectors, answer_question, hybrid_query,
   query_financial_graph and compare_quarters, /api/v1/query and /api/v1/build
   on the graph service, with the fused top-k and first-k counters at 0 just
   before the first request and read just after the last; only then the same
   calls on the engine object, which must give equal results. Then persist,
   reset_engine, a second engine from index_dir alone, the same requests,
   equal hits.
9. Command line: python -m ragfin_tpu_torch.cli chunk / build-index / query
   --mode hybrid as subprocesses on a small generated extract_data tree, then
   the bench subcommand (bench_torch.py, BENCH_N = 1,000,000, BENCH_Q = 64) in
   this process with the ceiling kernel's counter at 0 just before.

10. Parallel (ragfin_tpu_torch/parallel), after phase 3's main path, on
   meshes that list cuda:0 as often as they have shards, with the kernels'
   counters at 0 just before (a) and read after (d): (a) ShardedVectorIndex.
   from_dense over the main path's f32 and int8 indexes (131,072 filings),
   1 and 2 shards (65,536 columns a shard: the fused kernels), its questions
   through search_texts: f32 hits equal to the flat index's (1e-5), int8
   bitwise equal to the same program with fused_topk_int8_plain in the
   kernel's place; (b) 4,000,037 seeded unit vectors, f32 and int8, 1 and 4
   shards, Q in {1, 64}, k = 64: f32 ids against an f64 oracle outside tie
   bands, int8 bitwise against the plain-version program, each call timed
   beside the direct fused call; a negative-similarity corpus with 98 %
   padding over 8 shards (method="fused"), and both kernels on a pure-pad
   shard (limit 0) returning empty lists; (c) phase 5's 10M-fact store over
   1 and 4 shards: nine matches (test_sharded_graph.py's cases and company
   scopes), rows and hit counts equal to GraphIndex.match and a numpy count,
   two first-k launches a shard per match; (d) phase 6's IVF (489 cells
   padded to 492) over 4 shards, Q = 64, k 64: at full probe f32 equal to the
   exact fused tier and int8 to its dequantized cells, recall@10 at nprobe 32
   beside the pruned kernel's, timed beside it; (e) build_ivf on phase 6's
   corpus with free_source off and on: equal indexes, the peak (above the
   caller's memory) lower by at least the source's bytes; (f) the committed
   domain encoder on 64 of the main path's chunks at 192 tokens, pp = 2 (M =
   4) and sp = 4 against the single-device forward (bf16 cosine >= 0.999, f32
   within 1e-5), one pp train step's loss against a replay (1e-5) with every
   layer updated, and the residual-MLP pipeline (L = 8, d = 384, M = 8, B =
   64, pp 2 and 4) against sequential_forward; (g) case (b) again through a
   one-rank NCCL process group, equal to the in-process results; (h)
   dryrun_multichip(4), stages 1-6 (stage 1: the dp x tp step at (2, 2));
   (i) the dp x tp InfoNCE step (parallel/minilm_tp.py) of the committed
   domain encoder on the trainer's first batch (256 pairs, 64 + 192
   tokens): f32 at (2, 2) and (1, 4) against the single-device step (loss
   and accuracy within 1e-5, post-step global norm within 1e-5 relative),
   bf16 step times (median of 10), idle share (torch.profiler) and peak
   memory at (1, 1), (2, 2) and (1, 4); then 10 bf16 steps at (2, 2),
   gathered, saved with save_encoder_checkpoint and served over 65,536
   filings, the fused kernel's counter at 0 just before the requests and
   read just after (the dp_tp_launches of row 1), fused hits equal to the
   dense tier's.
11. The drivers outside the package, after phase 9. (a) Concurrent load
   (scripts/serving_concurrent_torch.py's stack and measuring loop) at the
   end of phase 3, on its engine (131,072 filings of seven banks, the
   trained encoder, f32, batcher on; with --drivers that engine is built
   for it), with the vector MCP server and adapter launched over it as the
   script launches them. Phase 8's engine comes from a chunk snapshot, which
   keeps no company (the reference's snapshot shape), so every /search
   question there is scoped to the latest fiscal year and never reaches the
   unscoped search; phase 3's corpus leaves out the default company, so a
   question that names no bank does. A warm pass of phase 3's 24 questions
   one at a time over HTTP, every hit equal to the engine object's and to
   the dense tier's (plain torch on the card) outside 1e-5 tie bands; then
   C = 8 and 32 clients for 10 s each through the vector adapter, the fused
   counters at 0 just before a level and read just after, every response
   of the level held against the dense tier's (within 1e-3: served
   questions are encoded in batches), one line per level (QPS, p50/p95,
   batch mean/p50/p90, the card); a request that errs fails. (b)
   scripts/trained_eval_torch.py (ARMS=pipeline,raw,ivf) and
   scripts/distractor_eval_torch.py (ARMS=base,ivf) at DISTRACTOR_N = 65,536
   (+ 16 generated ICICI chunks; N >= FUSED_MIN_N, so the raw arms run
   row 1), then the trained eval's pipeline and raw arms at
   TRAINED_DTYPE=int8 (row 2), all in this process, each dtype into its own
   directory of the work directory, with rows 1-3's counters at 0 just
   before and read just after. Each arm's searches run again on the
   script's index, through the arm's route and with the dense tier (f32) or
   the int8 kernel's plain version (int8) in the kernel's place: hits equal
   outside 1e-5 tie bands, and the route's hits give the summary the script
   reported. Each arm's recall@k printed, the IVF agreement by nprobe, and
   at full probe the trained IVF equal to the host-exact oracle. (c)
   examples/demo_torch.py as a subprocess, exit 0.
   (d) parallel/dryrun.py:entry()'s bf16 forward on the card against the f32
   forward on the CPU from the same init_params, cosine >= 0.999 per row.

The last line is {"ok": true, "device": {...}}; the line before it is the
kernel table as JSON (rows 1-3 also carry the hashed phase's launches and
phase 11's eval launches, row 1 the minilm and train phases', phase 10 (i)'s
and phase 11 (a)'s, rows 1, 2 and first_k the parallel phase's).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import io
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
N_GRAPH = 10_000_000
FIRST_K = 30
IVF_CELL, IVF_NPROBE, IVF_K, IVF_BLOCK_Q = 2048, 32, 64, 8
SEED = 0
F32_TOL = 1e-5
# Served (batched) against single searches: the bf16 encoder's output moves
# by ~1e-4 with the padded shape of the batch a query was encoded in.
BATCH_TOL = 1e-3
# H100 SXM peaks (NVIDIA data sheet, dense): FP32 cores, bf16, TF32 and int8
# tensor cores, HBM3. "tf32x3" is the f32-accurate product of the f32/bf16
# pass 1: three TF32 products per multiply-add.
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12, "tf32x3": 495e12 / 3}
PEAK_BYTES = 3.35e12
# The card's name and power limit (nvidia-smi), printed beside every time.
CARD = "card not read"


def int_mm_row_major(torch, device) -> bool:
    """Whether torch._int_mm takes a row-major [K, N] int8 second operand on
    this card (cuBLASLt may want it column-major)."""
    a = torch.zeros((32, 64), dtype=torch.int8, device=device)
    try:
        torch._int_mm(a, torch.zeros((64, 64), dtype=torch.int8, device=device))
    except RuntimeError:
        return False
    return True


def int_mm_operand(torch, ct8):
    """The [D, N] int8 operand of the torch._int_mm yardstick and its layout:
    the corpus as stored where _int_mm takes it, else a column-major copy
    made here, outside any timed region."""
    if int_mm_row_major(torch, ct8.device):
        return ct8, "the corpus as stored, row-major [D, N]"
    return ct8.T.contiguous().T, "a column-major copy of the corpus"


def int_mm(torch, q8, b):
    """torch._int_mm(q8, b) with q8 padded to 32 rows where it has 16 or
    fewer (_int_mm needs more than 16); the padding is inside the call, so
    its time counts. Returns the [Q, N] int32 product."""
    q_n = q8.shape[0]
    if q_n <= 16:
        q8 = torch.nn.functional.pad(q8, (0, 0, 0, 32 - q_n))
    return torch._int_mm(q8, b)[:q_n]


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
    """Median of ``runs`` CUDA-event timings of fn() after warm-up (the
    port's one timer, utils/profiling.device_ms)."""
    from ragfin_tpu_torch.utils.profiling import device_ms

    return device_ms(fn, runs=runs, warmup=warmup)


def stream_ms(torch, fn, runs: int = 20, warmup: int = 3) -> float:
    """Mean time of ``runs`` calls of fn() issued back to back, with one pair
    of CUDA events around them all: the device's time per call once the
    host runs ahead, without the enqueue latency that time_ms, one call at a
    time, includes."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


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


def score_err(got, ref) -> float:
    """Largest |got - ref|; equal entries (empty slots at -inf too) count 0."""
    import numpy as np

    with np.errstate(invalid="ignore"):
        return float(np.max(np.abs(np.where(got == ref, 0.0, got - ref))))


# --- phase 2 -------------------------------------------------------------


def f64_oracle(torch, q, corpus_t, k, n_valid, bf16_queries=False):
    """Top k by f64 scores of the same inputs (queries rounded to bf16 for
    the fast tier), columns >= n_valid masked; [Q, k] numpy scores and ids.
    Ties come back in any order: compare ids outside tie bands only."""
    qd = (q.to(torch.bfloat16) if bf16_queries else q).double()
    best_s, best_i = None, None
    for c0 in range(0, n_valid, 1 << 18):
        c1 = min(n_valid, c0 + (1 << 18))
        sc = qd @ corpus_t[:, c0:c1].double()
        s, i = torch.topk(sc, min(k, c1 - c0), dim=1)
        i = i + c0
        if best_s is not None:
            s, sel = torch.topk(torch.cat([best_s, s], 1), k, dim=1)
            i = torch.gather(torch.cat([best_i, i], 1), 1, sel)
        best_s, best_i = s, i
    return best_s.float().cpu().numpy(), best_i.cpu().numpy()


def int8_f64_oracle(torch, q, ct8, sc8, k, n_valid):
    """Top k by f64 scores of the int8 route's inputs: the exact int dot of
    the quantised queries and columns times the column scale and the row
    scale, columns >= n_valid masked; [Q, k] numpy scores and ids (ties in
    any order: compare ids outside tie bands only)."""
    from ragfin_tpu_torch.ops.quantize import quantize_queries

    q8, qscale = quantize_queries(q)
    qd, rs = q8.double(), qscale.double().reshape(-1, 1)
    best_s, best_i = None, None
    for c0 in range(0, n_valid, 1 << 17):
        c1 = min(n_valid, c0 + (1 << 17))
        sc = (qd @ ct8[:, c0:c1].double()) * sc8.reshape(1, -1)[:, c0:c1].double() * rs
        s, i = torch.topk(sc, min(k, c1 - c0), dim=1)
        i = i + c0
        if best_s is not None:
            s, sel = torch.topk(torch.cat([best_s, s], 1), k, dim=1)
            i = torch.gather(torch.cat([best_i, i], 1), 1, sel)
        best_s, best_i = s, i
    return best_s.float().cpu().numpy(), best_i.cpu().numpy()


def kernel_phase(torch, topk, sweep: bool = False) -> dict:
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
    from ragfin_tpu_torch.ops.quantize import quantize_corpus_t, quantize_queries

    ct8, sc8 = quantize_corpus_t(ct32)
    tiled = topk.tile_corpus_t(ct32, 2048)
    tiled8, tiled_sc8 = topk.tile_corpus_t(ct8, 2048), topk.tile_scales(sc8, 2048)
    b8, b8_layout = int_mm_operand(torch, ct8)
    qgen = torch.Generator(device=dev).manual_seed(SEED + 1)
    q_all = torch.randn((1024, D), generator=qgen, device=dev)
    q_all = q_all / torch.linalg.vector_norm(q_all, dim=1, keepdim=True)
    q_all[:8] = ct32[:, src[:8]].T  # tie-heavy rows: each matches 8 equal columns
    q_all[8] = 0.0  # all-zero row: every score 0, lowest ids first

    cases = [(1, 3), (8, 64), (64, 64), (64, 70), (1024, 64)]
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
            ("bf16 exact", lambda: f32(q, ct16, k, n_valid=n_valid),
             lambda kk: topk.fused_topk_plain(q, ct16, kk, n_valid=n_valid)),
            ("bf16 fast", lambda: f32(q, ct16, k, n_valid=n_valid, precision="fast"),
             lambda kk: topk.fused_topk_plain(q, ct16, kk, n_valid=n_valid, precision="fast")),
        ]
        for label, run, plain in variants:
            s, i = run()
            torch.cuda.synchronize()
            if label != "f32 tile-major":
                # Ids against the f64 oracle of the same inputs, outside tie bands.
                os_, oi = f64_oracle(torch, q, ct16 if "bf16" in label else ct32, k + 1, n_valid,
                                     bf16_queries=label == "bf16 fast")
                if not ids_agree(os_, oi, i.cpu().numpy(), F32_TOL):
                    raise AssertionError(f"{label} Q={q_n} k={k}: ids differ from the f64 oracle")
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
        # The int8 route's ids against the f64 oracle of its own inputs.
        os8, oi8 = int8_f64_oracle(torch, q, ct8, sc8, k + 1, n_valid)
        for label, c8, s8 in (("int8", ct8, sc8), ("int8 tile-major", tiled8, tiled_sc8)):
            s, i = i8(q, c8, s8, k, n_valid=n_valid)
            torch.cuda.synchronize()
            if not ids_agree(os8, oi8, i.cpu().numpy(), F32_TOL):
                raise AssertionError(f"{label} Q={q_n} k={k}: ids differ from the f64 oracle")
            ps, pi = topk.fused_topk_int8_plain(q, c8, s8, k, n_valid=n_valid)
            s, i, ps, pi = (x.cpu().numpy() for x in (s, i, ps, pi))
            errs["fused_topk_int8"] = max(errs["fused_topk_int8"], score_err(s, ps))
            if not (np.array_equal(s, ps) and np.array_equal(i, pi)):
                raise AssertionError(f"{label} Q={q_n} k={k}: not bitwise equal to the plain version")
            check_ties(np, label, q_n, k, s, i, src, n)
        print(f"kernel check Q={q_n} k={k}: f32/tile-major/bf16 exact/bf16 fast within {F32_TOL} "
              f"of plain, int8 flat and tile-major bitwise equal, ids of every path equal to "
              f"the f64 oracle outside tie bands", flush=True)

    # Timing at the main path's widths: k = 64 (f32) and 70 (int8 shortlist);
    # int8 also at Q = 1024, where its 64-row blocks run.
    print(f"int8 library call: torch._int_mm on {b8_layout}", flush=True)
    rows = {}
    for q_n in (1, 8, 64, 1024):
        q = q_all[:q_n].contiguous()
        int8_library = lambda: torch.topk(  # noqa: E731
            int_mm(torch, quantize_queries(q)[0], b8).float() * sc8, 70)
        for name, corpus_dtype, ops_type, k, run, plain, lib in (
            ("fused_topk", "float32", "tf32x3", 64,
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
             int8_library),
        ):
            if q_n == 1024 and name != "fused_topk_int8":
                continue
            ms = time_ms(torch, run)
            plain_ms = time_ms(torch, plain)
            lib_ms = time_ms(torch, lib) if lib is not None else None
            back_ms, lib_back_ms = stream_ms(torch, run), stream_ms(torch, lib)
            b_ms, b_by = bound(q_n, n, k, corpus_dtype, ops_type)
            rows[(name, q_n)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                     bound_ms=b_ms, bound_by=b_by, k=k, back_to_back_ms=back_ms,
                                     library_back_to_back_ms=lib_back_ms)
            print(f"kernel {name} Q={q_n} N={n} k={k}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
                  f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of bound; back to back "
                  f"{back_ms:.4f} ms, library {lib_back_ms:.4f} ms [{CARD}]", flush=True)
    # Pass 1 and pass 2 apart at Q = 1 (the stage ladders below give them at
    # Q = 8 and 64), and int8's quantisation kernels beside them.
    for label, fn in (
        ("fused_topk f32", lambda q: f32(q, ct32, 64, n_valid=n_valid)),
        ("fused_topk bf16 fast", lambda q: f32(q, ct16, 64, n_valid=n_valid, precision="fast")),
        ("fused_topk_int8", lambda q: i8(q, ct8, sc8, 70, n_valid=n_valid)),
    ):
        profile_breakdown(torch, label, 1, lambda: fn(q_all[:1].contiguous()))
    if sweep:
        # The int8 wrapper's rows per block (topk._tile) against the other
        # choice, in turns (rule, other, other, rule); equal outputs.
        rule = topk._tile
        try:
            for q_n in (64, 128, 1024):
                q = q_all[:q_n].contiguous()
                want = i8(q, ct8, sc8, 70, n_valid=n_valid)
                picked = rule(q_n, D, 1)
                other = 64 if picked == 32 else 32
                times = {picked: [], other: []}
                for rows_per_block in (picked, other, other, picked):
                    topk._tile = lambda *a, rows=rows_per_block, **kw: rows
                    got = i8(q, ct8, sc8, 70, n_valid=n_valid)
                    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                        raise AssertionError(f"int8 Q={q_n}: {rows_per_block} rows a block give "
                                             "another result")
                    times[rows_per_block].append(
                        time_ms(torch, lambda: i8(q, ct8, sc8, 70, n_valid=n_valid)))
                topk._tile = rule
                print(f"fused_topk_int8 Q={q_n} k=70 by rows per block (the wrapper picks "
                      f"{picked}): " + ", ".join(f"{w}: " + " / ".join(f"{t:.4f}" for t in ts) + " ms"
                                                for w, ts in times.items()) + f" [{CARD}]", flush=True)
        finally:
            topk._tile = rule
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
    # Stage ladder: pass 1 of each fused kernel with the selection replaced
    # by the ceiling stages (same grid: the probe tile is the kernel's chunk),
    # at Q = 64 and, for the f32/bf16 kernels, Q = 8.
    ladders = {}
    for q_n in (64, 8):
        qq = q_all[:q_n].contiguous()
        for label, corpus, scales, probe_q, run in (
            ("f32", ct32, None, qq, lambda: f32(qq, ct32, 64, n_valid=n_valid)),
            ("bf16", ct16, None, qq.to(torch.bfloat16),
             lambda: f32(qq, ct16, 64, n_valid=n_valid, precision="fast")),
            ("int8", ct8, sc8, quantize_queries(qq)[0].contiguous(),
             lambda: i8(qq, ct8, sc8, 70, n_valid=n_valid)),
        ):
            if q_n == 8 and label == "int8":
                continue
            key = label if q_n == 64 else f"{label} Q={q_n}"
            ladders[key] = stage_ladder(torch, label, probe_q, corpus, scales, n_valid, run)
    f32.launches = 0
    i8.launches = 0
    return {"rows": rows, "errs": errs, "n": n, "ladders": ladders}


CEIL_RTOL = 1e-4


def ceiling_check(torch, label, q, corpus, stage, block_n, n_valid, scales) -> tuple[float, float]:
    """One ceiling stage on the card against ceiling_plain on the same
    inputs: bitwise where the sums are integers, else |difference| <=
    CEIL_RTOL * the largest |sum| of the call (the kernel sums f32 products
    in another order, inside a dot product and over tiles; the bound is
    relative to the size of the sums, not to a row whose terms happen to
    cancel). Returns (largest |difference|, largest |sum|)."""
    from ragfin_tpu_torch.ops import ceiling as C

    got = C.ceiling(q, corpus, stage, block_n, n_valid=n_valid, scales=scales)
    torch.cuda.synchronize()
    want = C.ceiling_plain(q, corpus, stage, block_n, n_valid=n_valid, scales=scales)
    if got.shape != (q.shape[0],) or not torch.isfinite(got).all():
        raise AssertionError(f"ceiling {label} {stage}: bad output")
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    if C.is_exact(corpus.dtype, stage):
        if not torch.equal(got, want):
            raise AssertionError(f"ceiling {label} {stage}: not bitwise equal to plain")
    elif err > CEIL_RTOL * scale:
        raise AssertionError(f"ceiling {label} {stage}: |err| {err} > {CEIL_RTOL} * {scale}")
    return err, scale


def stage_ladder(torch, label, probe_q, corpus, scales, n_valid, run) -> dict:
    """On one corpus, every ceiling stage (block read, + product, + mask,
    + row max, + arg-max) first held against ceiling_plain at the fused
    kernel's own grid (block_n = its chunk, the last 128-column tile ragged),
    then timed back to back beside pass 1 and pass 2 of the fused kernel
    (their device times under torch.profiler) and the whole fused call (back
    to back, and one call at a time)."""
    from ragfin_tpu_torch.ops import ceiling as C

    q_n, n = probe_q.shape[0], corpus.shape[-1]
    block_n = C.fused_chunk_columns(q_n, n, corpus.device, corpus.dtype, D)
    stages = C.ladder_stages(corpus.dtype)
    err = max(ceiling_check(torch, f"ladder {label}", probe_q, corpus, stage, block_n,
                            n_valid, scales)[0] for stage in stages)
    # Back to back, so that each stage's time is the device's and not the
    # wrapper's host latency, as pass 1 and pass 2 are from the profiler.
    out = {
        stage: stream_ms(torch, lambda: C.ceiling(probe_q, corpus, stage, block_n,
                                                  n_valid=n_valid, scales=scales), runs=10)
        for stage in stages
    }
    out["pass1"], out["pass2"] = kernel_ms(torch, run, "pass1", "merge_bound")
    out["kernel"] = stream_ms(torch, run, runs=10)
    out["kernel one call"] = time_ms(torch, run, runs=10)
    C.ceiling.launches = 0
    print(f"stage ladder {label} Q={q_n} N={n} n_valid={n_valid} block_n={block_n} "
          f"(every stage equal to plain, max |err| {err:.3g}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items()) + f" [{CARD}]", flush=True)
    out["max_abs_err"] = err
    return out


# --- phase 7: the ceiling kernel alone ---------------------------------------


def ceiling_bound(q: int, n: int, corpus: str, stage: str) -> tuple[float, str]:
    """Least time for one ceiling call: the larger of its bytes (corpus, the
    int8 scales where the stage dequantises, queries, output, each once) over
    the memory rate and, from the product on, 2*Q*N*D operations over the peak
    rate of the product's type (3xTF32 for an f32 corpus)."""
    item = {"float32": 4, "bfloat16": 2, "int8": 1}[corpus]
    scales = 4 * n if corpus == "int8" and stage not in ("dma", "mmint", "rowmaxint") else 0
    nbytes = D * n * item + scales + (0 if stage == "dma" else q * D * item) + 4 * q
    t_bytes = nbytes / PEAK_BYTES * 1e3
    rate = PEAK_OPS["tf32x3" if corpus == "float32" else corpus]
    t_ops = 0.0 if stage == "dma" else 2.0 * q * n * D / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ceiling_phase(torch, topk) -> dict:
    """Every stage of the TPU probes' three families, and of the bench
    path's shape, at N = 1,000,000 against ceiling_plain on the card
    (ceiling_check), then timed."""
    from ragfin_tpu_torch.ops import ceiling as C
    from ragfin_tpu_torch.ops.quantize import quantize_corpus_t
    from ragfin_tpu_torch.utils.synthetic import normal_bf16, unit_corpus_t, unit_queries

    dev = torch.device("cuda")
    n = N_KERNEL
    results, max_err = {}, 0.0

    def run_family(family, q, corpus, scales, block_n, n_valid, stages, lib_stage=None,
                   library=None):
        nonlocal max_err
        dtype = str(corpus.dtype).replace("torch.", "")
        width = corpus.shape[-1] * (corpus.shape[0] if corpus.dim() == 3 else 1)
        for stage in stages:
            call = lambda: C.ceiling(q, corpus, stage, block_n, n_valid=n_valid, scales=scales)
            plain = lambda: C.ceiling_plain(q, corpus, stage, block_n, n_valid=n_valid, scales=scales)
            err, scale = ceiling_check(torch, family, q, corpus, stage, block_n, n_valid, scales)
            exact = C.is_exact(corpus.dtype, stage)
            max_err = max(max_err, err)
            ms = time_ms(torch, call)
            plain_ms = time_ms(torch, plain, runs=3, warmup=1)
            lib_ms = None
            if stage == lib_stage and library is not None:
                lib_ms = time_ms(torch, library)
            elif stage == lib_stage:
                flat = topk._untile(corpus)
                lib_ms = time_ms(torch, lambda: torch.matmul(q, flat))
            b_ms, b_by = ceiling_bound(q.shape[0], width, dtype, stage)
            results[(family, stage)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                            bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
            read_gbs = corpus.numel() * corpus.element_size() / ms / 1e6
            print(f"kernel ceiling {family} {stage}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound {b_ms:.4f} ms "
                  f"({b_by}), {b_ms / ms:.1%} of bound, one corpus read per call = "
                  f"{read_gbs:.0f} GB/s, |err| {err:.3g} of {scale:.3g}"
                  f"{' (bitwise)' if exact else ''} [{CARD}]", flush=True)

    def read_check(family, q, corpus, block_n):
        # The dma stage's loads are live: the XOR of the words its blocks
        # loaded is the XOR of the corpus, and it cannot beat the memory.
        _, seen = C.ceiling(q, corpus, "dma", block_n, read_check=True)
        if seen != C.corpus_xor(corpus):
            raise AssertionError(f"ceiling {family}: the dma stage did not read the whole corpus")
        gbs = corpus.numel() * corpus.element_size() / results[(family, "dma")]["ms"] / 1e6
        if gbs > PEAK_BYTES / 1e9:
            raise AssertionError(f"ceiling {family}: dma reads {gbs:.0f} GB/s, above the card's rate")
        print(f"ceiling {family}: dma loads checked (XOR of loaded words equals the corpus's)",
              flush=True)

    # ceiling_parts_1m / ceiling_1m / ceiling_tiled_1m: Q = 128, block_n 2048.
    bn = 2048
    ct = normal_bf16((D, -(-n // bn) * bn), SEED + 7, dev)
    q = normal_bf16((128, D), SEED + 8, dev)
    run_family("bf16 Q=128 bn=2048 flat", q, ct, None, bn, None, ("dma", "matmul", "rowmax"),
               lib_stage="matmul")
    read_check("bf16 Q=128 bn=2048 flat", q, ct, bn)
    tiles = topk.tile_corpus_t(ct, bn)
    run_family("bf16 Q=128 bn=2048 tile-major", q, tiles, None, None, None, ("dma", "rowmax"))
    read_check("bf16 Q=128 bn=2048 tile-major", q, tiles, None)
    del ct, tiles
    # ceiling_q64: Q = 64, block_n 6144, n_valid mask; an arg-max tie built
    # on purpose: three equal columns, far above every other score, in two
    # 128-column sub-tiles of one probe tile.
    bn = 6144
    ct = normal_bf16((D, -(-n // bn) * bn), SEED + 9, dev)
    q = normal_bf16((64, D), SEED + 10, dev)
    q[:, 0] = q[:, 0].abs() + 1
    for col in (5 * bn + 130, 5 * bn + 135, 5 * bn + 4000):
        ct[:, col] = 0
        ct[0, col] = 1000.0
    run_family("bf16 Q=64 bn=6144", q, ct, None, bn, n, ("mm", "mask", "rowmax", "prologue"),
               lib_stage="mm")
    # The tied tile alone: prologue - rowmax is its arg-maximum, which must
    # be the lowest of the three equal columns, for every row.
    tied = ct[:, 5 * bn : 6 * bn].contiguous()
    arg = C.ceiling(q, tied, "prologue", bn) - C.ceiling(q, tied, "rowmax", bn)
    if float((arg - 130).abs().max()) > 0.01:
        raise AssertionError(f"ceiling prologue: arg-max of a tie {arg.tolist()[:4]} != 130 "
                             "(a tie must take the lowest column)")
    print("ceiling prologue: an arg-max tie takes the lowest column", flush=True)
    del ct
    # ceiling_q1024: int8, Q = 1024, block_n 8192.
    bn = 8192
    c8, cs = quantize_corpus_t(normal_bf16((D, -(-n // bn) * bn), SEED + 11, dev).float())
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    q8 = torch.randint(-127, 127, (1024, D), generator=gen, device=dev, dtype=torch.int8)
    b8, b8_layout = int_mm_operand(torch, c8)
    want = int_mm(torch, q8, b8)[:, ::bn].sum(dim=1, dtype=torch.int32)
    if not torch.equal(want.float(), C.ceiling_plain(q8, c8, "mmint", bn, n_valid=n)):
        raise AssertionError("torch._int_mm does not compute the mmint stage's products")
    print(f"ceiling int8 library call: torch._int_mm on {b8_layout} (its column 0 of each "
          "probe tile summed equals the mmint stage)", flush=True)
    run_family("int8 Q=1024 bn=8192", q8, c8, cs, bn, n,
               ("dma", "mmint", "rowmaxint", "mm", "rowmax", "prologue"), lib_stage="mmint",
               library=lambda: torch._int_mm(q8, b8))
    del b8, want
    read_check("int8 Q=1024 bn=8192", q8, c8, bn)
    del c8, cs, q8
    # The bench path's call (bench_torch.py at BENCH_Q = 64, bf16, which phase
    # 9 drives and counts): its corpus and queries, N = 1,000,000 not padded,
    # so the last 128-column tile is ragged, n_valid = N, block_n the fused
    # kernel's chunk.
    ct = unit_corpus_t(n, seed=0, device=dev, d=D)
    q = unit_queries((64, D), seed=1, device=dev).to(torch.bfloat16)
    bn = C.fused_chunk_columns(64, n, dev, ct.dtype, D)
    family = f"bf16 Q=64 bn={bn} bench shape"
    run_family(family, q, ct, None, bn, n, C.ladder_stages(ct.dtype))
    read_check(family, q, ct, bn)
    del ct
    C.ceiling.launches = 0
    return {"rows": results, "max_abs_err": max_err, "n": n}


def kernel_profile(torch, fn, reps: int) -> tuple[dict[str, tuple[int, float]], float, dict[str, int]]:
    """Run fn() once, then ``reps`` times under torch.profiler: ({CUDA kernel
    or copy: (events, device ms in all)}, host wall ms per call, {CUDA
    runtime call: count})."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels, runtime = {}, {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if ev.key and ev.key.startswith("cuda"):
            runtime[ev.key] = ev.count
        # Host-side entries (aten ops, CUDA runtime calls) also carry their
        # kernels' device time; only the kernels and copies are counted.
        if dev_us and ev.key and not ev.key.startswith(("cuda", "aten::")):
            kernels[ev.key.split("(")[0][:60]] = (ev.count, dev_us / 1e3)
    return kernels, wall_ms, runtime


def profiled(torch, fn, reps: int) -> tuple[list[tuple[float, str]], float]:
    """Run fn() ``reps`` times under torch.profiler: (device ms per call of
    each CUDA kernel and copy, largest first; host wall ms per call)."""
    kernels, wall_ms, _ = kernel_profile(torch, fn, reps)
    return sorted(((ms / reps, name) for name, (_, ms) in kernels.items()), reverse=True), wall_ms


def kernel_ms(torch, fn, *names: str, reps: int = 5) -> list[float]:
    """Device ms of one launch of each kernel named (by a part of its name),
    from torch.profiler over ``reps`` calls of fn(): its device time in all
    over its number of records, so that a profile that lost some records
    still gives the time of one launch. Tried again (FIRST_K_PROFILES times
    in all) until every name has records."""
    for _ in range(FIRST_K_PROFILES):
        kernels, _, _ = kernel_profile(torch, fn, reps)
        found = [next(((ms, count) for kernel, (count, ms) in kernels.items() if name in kernel),
                      None) for name in names]
        if all(found):
            return [ms / count for ms, count in found]
    raise AssertionError(f"no {names} kernels in {FIRST_K_PROFILES} profiles: {list(kernels)[:4]}")


def profile_breakdown(torch, label: str, q_n: int, fn, reps: int = 10) -> None:
    """Device time of one launch of each CUDA kernel of a call that launches
    each once, from torch.profiler (time in all over records)."""
    kernels, _, _ = kernel_profile(torch, fn, reps)
    parts = sorted(((ms / count, name) for name, (count, ms) in kernels.items()
                    if not name.startswith("Memcpy")), reverse=True)
    text = ", ".join(f"{name} {ms:.4f} ms" for ms, name in parts[:6]) or "no device time seen"
    print(f"profile {label} Q={q_n} (per launch): {text}", flush=True)


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


# --- phase 1: the merge cases ----------------------------------------------

# One case's bytes: a [64, 256] f32 tile in, a [64, 128] f32 tile out.
MERGE_BYTES = 64 * 256 * 4 + 64 * 128 * 4


def merge_phase(torch, here: str) -> dict:
    """The selection's primitives on the card: the script a user
    runs (scripts/mosaic_bisect_torch.py) with the kernel's counter at 0 just
    before and read just after, then each case bitwise against its plain
    version on the same tile and timed beside it."""
    from ragfin_tpu_torch.ops import merge_cases as M

    sys.path.insert(0, os.path.join(here, "scripts"))
    import mosaic_bisect_torch as bisect

    M.merge_case.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bisect.main([])
    torch.cuda.synchronize()
    launches = M.merge_case.launches
    print(buf.getvalue(), end="", flush=True)
    if rc != 0 or launches < len(M.CASES):
        raise AssertionError(f"mosaic_bisect_torch.py exited {rc} after {launches} launches")
    x_cpu = bisect.tiles()["uniform"]
    x = x_cpu.cuda()
    cases, err = {}, 0.0
    for name in M.CASES:
        got = M.merge_case(name, x)
        torch.cuda.synchronize()
        want = M.merge_case_plain(name, x_cpu)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"merge case {name}: not bitwise equal to the plain version")
        err = max(err, score_err(got.cpu().numpy(), want.numpy()))
        cases[name] = dict(ms=time_ms(torch, lambda: M.merge_case(name, x)),
                           plain_ms=time_ms(torch, lambda: M.merge_case_plain(name, x), runs=5,
                                            warmup=1))
    M.merge_case.launches = 0
    b_ms = MERGE_BYTES / PEAK_BYTES * 1e3
    print("merge cases (bitwise equal to plain): " + ", ".join(
        f"{name} {c['ms']:.4f} ms (plain {c['plain_ms']:.4f})" for name, c in cases.items())
        + f"; bound {b_ms:.6f} ms (bytes)", flush=True)
    whole = cases["nested_while"]
    return dict(launches=launches, max_abs_err=err, ms=whole["ms"], plain_ms=whole["plain_ms"],
                bound_ms=b_ms, bound_by="bytes", library_ms=None, cases=cases)


def pass1_ptxas(_cuda) -> None:
    """The ptxas line of every pass-1 instantiation (f32, bf16, int8; the
    selection and every ceiling stage), of pass 2 (merge_bound) and of every
    merge case; any spill fails."""
    import re

    bad = []
    for name in _cuda.KERNELS:
        report = _cuda.ptxas_report(_cuda.build_log(name))
        spilled = set(_cuda.spills(report))
        for kernel, summary in report:
            if not any(part in kernel for part in ("fused_topk_pass1<", "merge_case_kernel",
                                                   "merge_bound<")):
                continue
            short = re.sub(r"\([^()]*\)$", "", kernel)  # without the parameter list
            print(f"ptxas {name}: {short}: {summary}", flush=True)
            if kernel in spilled:
                bad.append(short)
    if bad:
        raise AssertionError(f"instantiations spill registers: {bad}")


# --- phase 4: first-k alone ------------------------------------------------


FIRST_K_RUNS = 200  # the wrapper call is host-bound and spreads: a median of many
# --sweep: other spans, in 4 KB rounds a block (the committed build reads 8).
FIRST_K_SWEEP_ITERS = (1, 2, 4, 8, 16)
FIRST_K_PROFILES = 3  # tries at a profile that holds kernel records


def first_k_device_ms(torch, fn, reps: int = 50, counter=None) -> float:
    """Device ms of one first-k call from torch.profiler. Fails unless the
    ``reps`` calls made exactly ``reps`` kernel launches (cudaLaunchKernel
    calls in the profile and, where ``counter`` (the wrapper) is given, as
    many launches counted by it, with kernel_profile's call before), no copy
    or memset, and the device ran no kernel but first-k. The time is the mean
    of the kernel records the trace delivers: on the card it has lost some
    or all of them (49 of 50; 0 of 50) while keeping every launch call, so
    up to FIRST_K_PROFILES profiles are taken until one holds records."""
    for _ in range(FIRST_K_PROFILES):
        before = counter.launches if counter is not None else 0
        kernels, _, runtime = kernel_profile(torch, fn, reps)
        counted = counter.launches - before - 1 if counter is not None else reps
        launch_calls = {key: n for key, n in runtime.items()
                        if key.startswith(("cudaLaunch", "cudaMemset", "cudaMemcpy"))}
        names = list(kernels)
        if launch_calls != {"cudaLaunchKernel": reps} or counted != reps or len(names) > 1 \
                or (names and ("first_k_kernel" not in names[0] or kernels[names[0]][0] > reps)):
            raise AssertionError(f"{reps} first-k calls made {launch_calls} (the wrapper counted {counted}) "
                                 f"and ran {kernels}: not one first-k kernel each")
        if names:
            events, ms = kernels[names[0]]
            if events < reps:
                print(f"first_k profile: the trace kept {events} of {reps} kernel records", flush=True)
            return ms / events
    raise AssertionError(f"{FIRST_K_PROFILES} profiles of {reps} first-k calls held no kernel record")


def first_k_phase(torch, graph_index, sweep: bool = False) -> dict:
    dev = torch.device("cuda")
    n, k = N_GRAPH, FIRST_K
    span = graph_index.FIRST_K_SPAN
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    sparse = (torch.rand((n,), generator=gen, device=dev) < 1e-3).to(torch.int8)
    last = torch.zeros((n,), dtype=torch.int8, device=dev)
    last[-3:] = 1
    last_span = torch.zeros((n,), dtype=torch.int8, device=dev)  # hits in the last span only
    last_span[(n - 1) // span * span:: 97] = 1
    single = torch.zeros((n,), dtype=torch.int8, device=dev)
    single[0] = 1
    cases = {
        "rate 1e-3": (sparse, k),
        "rate 1.0": (torch.ones((n,), dtype=torch.int8, device=dev), k),
        "no hits": (torch.zeros((n,), dtype=torch.int8, device=dev), k),
        "three hits in the last rows": (last, k),
        "hits in the last span only": (last_span, k),
        "a single hit at 0": (single, k),
        "k = 1": (sparse, 1),
        "k = hits": (last_span, int(last_span.count_nonzero())),
        "bool, ragged length": (sparse[: n - 12_345].bool(), k),
        "unaligned view": (sparse[3:], k),
        "rate 1e-3, k=5000": (sparse, 5000),  # k above a span's hits and the head's
    }
    kernel, plain = graph_index.masked_first_k, graph_index.masked_first_k_plain
    max_err = 0  # largest |id difference| or |count difference| seen, kernel against plain

    def check(label, hit, kk, got):
        nonlocal max_err
        ids, cnt = got
        pids, pcnt = plain(hit, kk)
        max_err = max(max_err, int((ids.long() - pids.long()).abs().max()),
                      abs(int(cnt) - int(pcnt)))
        if not (torch.equal(ids, pids) and int(cnt) == int(pcnt)):
            raise AssertionError(f"first-k {label}: kernel {ids.tolist()[:40]} count {int(cnt)} != "
                                 f"plain {pids.tolist()[:40]} count {int(pcnt)}")

    for label, (hit, kk) in cases.items():
        got = kernel(hit, kk)
        torch.cuda.synchronize()
        check(label, hit, kk, got)
    # Twenty calls on other vectors and k, no sync between them, then two
    # streams at once: no call may see another's scratch state.
    rng = torch.Generator(device="cpu").manual_seed(SEED + 3)
    batch = []
    for i in range(20):
        rate = 10.0 ** (-6.5 + 6.5 * torch.rand((), generator=rng).item())
        kk = int(torch.randint(1, 3000, (), generator=rng))
        m = n - int(torch.randint(0, 100_000, (), generator=rng))
        batch.append(((torch.rand((m,), generator=gen, device=dev) < rate).to(torch.int8), kk))
    batch += list(cases.values())
    torch.cuda.synchronize()
    got = [kernel(hit, kk) for hit, kk in batch]
    torch.cuda.synchronize()
    for i, ((hit, kk), out) in enumerate(zip(batch, got)):
        check(f"back-to-back call {i}", hit, kk, out)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = []
    for i, (hit, kk) in enumerate(batch):
        with torch.cuda.stream(streams[i % 2]):
            got.append(kernel(hit, kk))
    torch.cuda.synchronize()
    for i, ((hit, kk), out) in enumerate(zip(batch, got)):
        check(f"two streams, call {i}", hit, kk, out)
    keys = {key for key in graph_index._first_k_scratch if key[1] in {st.cuda_stream for st in streams}}
    if len(keys) != 2:
        raise AssertionError(f"two streams shared first-k scratch: {keys}")
    print(f"first-k check N={n} k={k}: {len(cases)} cases, "
          f"{len(batch)} back-to-back calls without a sync and the same on two streams at once, "
          f"all equal to the plain version (ids and count, max difference {max_err})", flush=True)

    # Device time (torch.profiler: one kernel per call, checked).
    timed = {"rate 1e-3": sparse, "rate 1.0": cases["rate 1.0"][0], "no hits": cases["no hits"][0]}
    dev_ms = {label: first_k_device_ms(torch, lambda h=h: kernel(h, k), counter=kernel)
              for label, h in timed.items()}
    print(f"first_k device ms, span {span} bytes ({-(-n // span)} blocks): "
          + ", ".join(f"{label} {ms:.4f}" for label, ms in dev_ms.items()), flush=True)
    # One block alone (N = one span, no hit): the fixed cost of a block's
    # chain (ticket, read, publish, look-back, finish), whatever N.
    one_block = first_k_device_ms(torch, lambda: kernel(cases["no hits"][0][:span], k), counter=kernel)
    print(f"first_k device ms of one block (N = {span}, no hit): {one_block:.4f}", flush=True)
    by_span = first_k_span_sweep(torch, graph_index, cases, timed, check) if sweep else None

    # The wrapper call (host included) at the default span, beside the plain
    # version and torch.nonzero, in turns.
    ms = {label: time_ms(torch, lambda h=h: kernel(h, k), runs=FIRST_K_RUNS, warmup=10)
          for label, h in timed.items()}
    lib_ms = time_ms(torch, lambda: torch.nonzero(sparse)[:k], runs=FIRST_K_RUNS, warmup=10)
    plain_ms = time_ms(torch, lambda: plain(sparse, k), runs=FIRST_K_RUNS, warmup=10)
    again = time_ms(torch, lambda: kernel(sparse, k), runs=FIRST_K_RUNS, warmup=10)
    lib_again = time_ms(torch, lambda: torch.nonzero(sparse)[:k], runs=FIRST_K_RUNS, warmup=10)
    # Bytes the work needs: the sparse call must read up to its k-th hit;
    # with no hit it reads all N. Each writes k + 1 ints.
    kth = int(torch.nonzero(sparse)[k - 1])
    b_ms = (kth + 1 + 4 * (k + 1)) / PEAK_BYTES * 1e3
    b_none = (n + 4 * (k + 1)) / PEAK_BYTES * 1e3

    def host_us(fn, calls=1000):
        """Host time per call of ``calls`` calls enqueued back to back."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        spent = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return spent

    host = {"wrapper": host_us(lambda: kernel(sparse, k)),
            "torch.empty(k + 1)": host_us(lambda: torch.empty((k + 1,), dtype=torch.int32, device=dev)),
            "torch.nonzero(hit)[:k]": host_us(lambda: torch.nonzero(sparse)[:k])}
    print("first_k host time per call (1000 calls enqueued back to back): "
          + ", ".join(f"{label} {us:.1f} us" for label, us in host.items()), flush=True)
    print(f"kernel first_k N={n} k={k} span {span}: wrapper call (median of {FIRST_K_RUNS}) rate 1e-3 "
          f"{ms['rate 1e-3']:.4f} ms (again {again:.4f}), rate 1.0 {ms['rate 1.0']:.4f}, no hits "
          f"{ms['no hits']:.4f}; device rate 1e-3 {dev_ms['rate 1e-3']:.4f} ms, rate 1.0 "
          f"{dev_ms['rate 1.0']:.4f}, no hits {dev_ms['no hits']:.4f}; plain {plain_ms:.4f} ms, "
          f"library torch.nonzero {lib_ms:.4f} ms (again {lib_again:.4f}); bound (bytes) rate 1e-3 "
          f"{b_ms:.6f} ms (k-th hit at byte {kth}), no hits {b_none:.4f} ms; one kernel per call",
          flush=True)
    kernel.launches = 0
    return dict(ms=ms["rate 1e-3"], plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by="bytes", max_abs_err=float(max_err),
                shape={"N": n, "k": k, "hit_rate": 1e-3, "span": span},
                dense_ms=ms["rate 1.0"], no_hit_ms=ms["no hits"], no_hit_bound_ms=b_none,
                device_ms=dev_ms, device_ms_by_span=by_span, host_us=host,
                one_block_device_ms=one_block)


def first_k_span_sweep(torch, graph_index, cases, timed, check) -> dict:
    """csrc/first_k.cu built with other spans (RAGFIN_FK_ITERS rounds of 4 KB
    a block), called on their own scratch: every case equal to the plain
    version, then the device ms of each timed case."""
    from ragfin_tpu_torch.ops import _cuda

    dev, k = torch.device("cuda"), FIRST_K
    stream = torch.cuda.current_stream().cuda_stream
    by_span = {}
    for iters in FIRST_K_SWEEP_ITERS:
        fn = _cuda.kernel("first_k", (f"RAGFIN_FK_ITERS={iters}",))
        n_status = -(-N_GRAPH // (4096 * iters))
        scratch = torch.zeros((graph_index._FIRST_K_HEADER + n_status,), dtype=torch.int64, device=dev)

        def call(hit, kk):
            out = torch.empty((kk + 1,), dtype=torch.int32, device=dev)
            _cuda.check(fn(hit.data_ptr(), hit.shape[0], kk, scratch.data_ptr(), n_status,
                           out.data_ptr(), stream), "first_k")
            return out[:kk], out[kk]

        for label, (hit, kk) in cases.items():
            got = call(hit, kk)
            torch.cuda.synchronize()
            check(f"{label}, span {4096 * iters}", hit, kk, got)
        by_span[str(4096 * iters)] = row = {
            label: first_k_device_ms(torch, lambda h=h: call(h, k)) for label, h in timed.items()}
        print(f"first_k device ms by span {4096 * iters} bytes ({n_status} blocks): "
              + ", ".join(f"{label} {ms:.4f}" for label, ms in row.items()), flush=True)
    return by_span


# --- phase 5: graph store at scale -------------------------------------------


def scale_graph(graph_index):
    """The 10,000,000-fact store of phase 5 (seeded), packed on the card."""
    import numpy as np

    g = graph_index.GraphIndex()
    rng = np.random.default_rng(SEED)
    n = N_GRAPH
    quarters = [f"Q{q}_FY{y}" for y in range(2018, 2031) for q in range(1, 5)]
    qv = g.intern_quarters(quarters)
    ev = g.intern_entities([f"Metric {i}" for i in range(200)] + ["Net Profit"])
    g.add_facts_bulk(
        quarter_ids=qv[rng.integers(0, len(qv), n - 5)],
        entity_ids=ev[rng.integers(0, len(ev), n - 5)],
        type_ids=rng.integers(0, 4, n - 5).astype(np.int32),
        values=rng.uniform(1, 1e5, n - 5).astype(np.float32),
        dataset_id="synthetic",
    )
    # Two late quarters that only three rare entities touch: A and B share
    # Q3_FY2031, B and C share Q4_FY2031 (the table's last rows).
    g.add_facts_bulk(
        quarter_ids=g.intern_quarters(["Q3_FY2031", "Q3_FY2031", "Q4_FY2031", "Q4_FY2031", "Q4_FY2031"]),
        entity_ids=g.intern_entities(["Rare A", "Rare B", "Rare B", "Rare C", "Rare C"]),
        type_ids=np.array([graph_index.METRIC] * 5, np.int32),
        values=np.array([1.0, 2.0, 3.0, 777.0, 4.0], np.float32),
        dataset_id="rare", company="Rare Bank",
    )
    g._pack()
    return g


def graph_scale_phase(torch, graph_index):
    import numpy as np

    t0 = time.perf_counter()
    g = scale_graph(graph_index)
    n = N_GRAPH
    packed = g._pack()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    host, total = packed["host"], int(packed["quarter_ids"].shape[0])
    if not packed["quarter_ids"].is_cuda or g.n_facts != n or total < graph_index.FIRST_K_MIN_ROWS:
        raise AssertionError("the 10M-fact store is not on the card at full size")

    def values_of(rows):
        return [r.get("value", r.get("revenue")) for r in rows]

    graph_index.masked_first_k.launches = 0
    checks = 0
    for names, types, limit in (
        (["Metric 7"], [graph_index.SEGMENT], 25),
        (["Net Profit"], None, 30),
        (["Rare C"], [graph_index.METRIC], 30),  # hits in the last rows only
        (["Metric 3", "Metric 150"], [graph_index.RATIO, graph_index.BALANCE], 30),
    ):
        sel = np.isin(host["entity_ids"], [g._entity_id[x] for x in names])
        if types is not None:
            sel &= np.isin(host["type_ids"], types)
        want = [float(v) for v in host["value"][np.nonzero(sel)[0][:limit]]]
        got = values_of(g.match(names=names, types=types, limit=limit))
        if got != want:
            raise AssertionError(f"graph match {names} {types}: {got[:5]} != oracle {want[:5]}")
        checks += 1
    scoped = g.match(names=["Rare B"], companies=["Rare Bank"])
    if values_of(scoped) != [2.0, 3.0] or [r["quarter"] for r in scoped] != ["Q3_FY2031", "Q4_FY2031"]:
        raise AssertionError(f"company-scoped match gave {scoped}")
    launches = graph_index.masked_first_k.launches
    if launches != checks + 1:
        raise AssertionError(f"{checks + 1} matches at {total} rows made {launches} first-k launches")

    e7 = g._entity_id["Metric 7"]
    sel = (host["entity_ids"] == e7) & (host["type_ids"] == graph_index.RATIO)
    vals = host["value"][sel].astype(np.float64)
    agg = g.aggregate(names=["Metric 7"], types=[graph_index.RATIO])
    rows = np.nonzero(sel)[0]
    if (agg["count"] != int(sel.sum()) or abs(agg["mean"] - vals.mean()) > 1e-3 * vals.mean()
            or agg["max"]["value"] != float(host["value"][rows[np.argmax(host["value"][rows])]])
            or agg["min"]["value"] != float(host["value"][rows[np.argmin(host["value"][rows])]])):
        raise AssertionError(f"graph aggregate {agg} differs from the numpy oracle")

    def khop_oracle(seed_names, hops, limit):
        e_mask = np.zeros(len(g.entities), bool)
        e_mask[[g._entity_id[x] for x in seed_names]] = True
        q_mask = np.zeros(len(g.quarters), bool)
        for _ in range(hops):
            q_mask[np.unique(host["quarter_ids"][e_mask[host["entity_ids"]]])] = True
            e_mask[np.unique(host["entity_ids"][q_mask[host["quarter_ids"]]])] = True
        return [float(v) for v in host["value"][np.nonzero(q_mask[host["quarter_ids"]])[0][:limit]]]

    for hops, want_n in ((1, 2), (2, 5)):
        got = values_of(g.expand(["Rare A"], limit=30, hops=hops))
        if got != khop_oracle(["Rare A"], hops, 30) or len(got) != want_n:
            raise AssertionError(f"graph expand hops={hops}: {got}")
    if values_of(g.expand(["Metric 7"], limit=30, hops=2)) != khop_oracle(["Metric 7"], 2, 30):
        raise AssertionError("graph expand from a common entity differs from the oracle")

    match_ms = time_ms(torch, lambda: g.match(names=["Metric 7"], types=[graph_index.SEGMENT]), runs=10)
    agg_ms = time_ms(torch, lambda: g.aggregate(names=["Metric 7"]), runs=10)
    hop_ms = time_ms(torch, lambda: g.expand(["Rare A"], hops=2), runs=10)
    print(f"graph store: {n} facts packed onto the card in {build_s:.1f} s ({total} padded rows); "
          f"match, aggregate, expand(hops=2) equal to the numpy oracle; {launches} first-k "
          f"launches; whole calls (host included): match {match_ms:.3f} ms, aggregate "
          f"{agg_ms:.3f} ms, expand(hops=2) {hop_ms:.3f} ms", flush=True)
    profile_breakdown(torch, "graph match 10M", 1,
                      lambda: g.match(names=["Metric 7"], types=[graph_index.SEGMENT]))
    profile_breakdown(torch, "graph expand(hops=2) 10M", 1, lambda: g.expand(["Rare A"], hops=2))
    graph_index.masked_first_k.launches = 0
    return g


# --- phase 6: IVF alone --------------------------------------------------------


def ivf_bound(qp: int, nprobe: int, cell: int, corpus: str, ops_type: str) -> tuple[float, str]:
    """Least time for one pruned top-k call: the probed cells read once per
    query tile over the memory rate, or 2*Qp*nprobe*cell*D operations over
    the peak rate of their type, whichever is larger."""
    item = {"float32": 4, "bfloat16": 2, "int8": 1}[corpus]
    t_bytes = (qp // IVF_BLOCK_Q) * nprobe * cell * D * item / PEAK_BYTES * 1e3
    t_ops = 2.0 * qp * nprobe * cell * D / PEAK_OPS[ops_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ivf_inputs(torch, ivf):
    """Phase 6's inputs: ``(ct32 [D, N] f32, q_all [64, D], idx32, idx8,
    build seconds)``, the f32 index clustered on the card and an int8 index
    over the same cells."""
    from ragfin_tpu_torch.ops.quantize import quantize_corpus_t

    dev = torch.device("cuda")
    n = N_KERNEL
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    # Clustered unit vectors (240 centres, about two cells each), so that
    # probing has structure.
    centres = torch.randn((240, D), generator=gen, device=dev)
    which = torch.randint(0, 240, (n,), generator=gen, device=dev)
    x = centres[which] + 0.7 * torch.randn((n, D), generator=gen, device=dev)
    x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    ct32 = x.T.contiguous()
    q_all = x[torch.randint(0, n, (64,), generator=gen, device=dev)]
    q_all = q_all + 0.3 * torch.randn((64, D), generator=gen, device=dev)
    q_all = (q_all / torch.linalg.vector_norm(q_all, dim=1, keepdim=True)).contiguous()
    del x, centres
    t0 = time.perf_counter()
    idx32 = ivf.build_ivf(ct32, cell=IVF_CELL, seed=SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_cells = idx32.n_cells
    flat = idx32.cells.permute(1, 0, 2).reshape(D, -1)
    c8, sc8 = quantize_corpus_t(flat)
    tiles = lambda t, rows: t.reshape(rows, n_cells, IVF_CELL).permute(1, 0, 2).contiguous()
    idx8 = idx32._replace(cells=tiles(c8, D), scales=tiles(sc8, 1))
    return ct32, q_all, idx32, idx8, build_s


def ivf_f64_oracle(torch, qin, qs, index, probe, k):
    """Top k by f64 scores over each query tile's probed cells (int8 cells:
    the exact int dot times the row and the column scale), permuted ids at
    or past n_valid masked; [Qp, k] numpy scores and permuted ids."""
    cell = index.cells.shape[2]
    out_s, out_i = [], []
    for t, pr in enumerate(probe.long()):
        rows_t = slice(t * IVF_BLOCK_Q, (t + 1) * IVF_BLOCK_Q)
        cells = index.cells[pr].double()  # [nprobe, D, cell]
        qt = qin[rows_t].double()
        if index.scales is not None:
            cells = cells * index.scales[pr].double()
            qt = qt * qs[rows_t].double().reshape(-1, 1)
        sc = torch.einsum("qd,pdc->qpc", qt, cells).reshape(qt.shape[0], -1)
        pid = (pr[:, None] * cell + torch.arange(cell, device=pr.device)).reshape(-1)
        sc = sc.masked_fill(pid[None, :] >= index.n_valid, float("-inf"))
        s, j = torch.topk(sc, k, dim=1)
        out_s.append(s)
        out_i.append(pid[j])
    return torch.cat(out_s).float().cpu().numpy(), torch.cat(out_i).cpu().numpy()


def ivf_phase(torch, topk, ivf, sweep: bool = False) -> dict:
    import numpy as np

    dev = torch.device("cuda")
    n = N_KERNEL
    ct32, q_all, idx32, idx8, build_s = ivf_inputs(torch, ivf)
    n_cells = idx32.n_cells
    ids = idx32.orig_ids.cpu().numpy()
    if (idx32.n_valid != n or n_cells != -(-n // IVF_CELL) or (ids[:n] == topk.INT32_MAX).any()
            or not (ids[n:] == topk.INT32_MAX).all()
            or not np.array_equal(np.sort(ids[:n]), np.arange(n))):
        raise AssertionError("build_ivf: cells are not a balanced permutation with pads last")
    print(f"IVF build: N={n} D={D} cell={IVF_CELL} -> {n_cells} cells, 4 Lloyd iterations, "
          f"{build_s:.1f} s (device scoring and the host assignment)", flush=True)
    idx16 = idx32._replace(cells=idx32.cells.to(torch.bfloat16))

    ivf_row_major = int_mm_row_major(torch, dev)
    tiers = (("f32 exact", idx32, "exact", "float32", "tf32x3"),
             ("bf16 fast", idx16, "fast", "bfloat16", "bfloat16"),
             ("int8", idx8, "fast", "int8", "int8"))
    rows, max_err = {}, 0.0
    for q_n in (1, 8, 64):
        q = q_all[:q_n].contiguous()
        for label, index, precision, corpus_dtype, ops_type in tiers:
            qin, qs, probe, _ = ivf.stage_queries(q, index, IVF_NPROBE, IVF_BLOCK_Q, precision)
            args = (qin, qs, index.cells, index.scales, probe, index.n_valid)
            s, i = ivf.pruned_topk(*args, IVF_K, IVF_BLOCK_Q)
            torch.cuda.synchronize()
            ps, pi = ivf.pruned_topk_plain(*args, IVF_K + 1, IVF_BLOCK_Q)
            s, i, ps, pi = (t.cpu().numpy() for t in (s, i, ps, pi))
            os_, oi = ivf_f64_oracle(torch, qin, qs, index, probe, IVF_K + 1)
            if not ids_agree(os_, oi, i, F32_TOL):
                raise AssertionError(f"IVF {label} Q={q_n}: ids differ from the f64 oracle")
            if index.scales is not None:
                ref = ps[:, :IVF_K]
                max_err = max(max_err, score_err(s, ref))
                if not (np.array_equal(s, ref) and np.array_equal(i, pi[:, :IVF_K])):
                    raise AssertionError(f"IVF {label} Q={q_n}: not bitwise equal to the plain version")
            else:
                err = float(np.max(np.abs(s - ps[:, :IVF_K])))
                max_err = max(max_err, err)
                if err > F32_TOL or not ids_agree(ps, pi, i, F32_TOL):
                    raise AssertionError(f"IVF {label} Q={q_n}: err {err}, or ids differ outside tie bands")
            # The whole function: original ids, finite scores, real rows only.
            ws, wi = ivf.ivf_topk(q, index, IVF_K, nprobe=IVF_NPROBE, block_q=IVF_BLOCK_Q,
                                  precision=precision)
            wi = wi.cpu().numpy()
            if ws.shape != (q_n, IVF_K) or not torch.isfinite(ws).all() or wi.max() >= n or wi.min() < 0:
                raise AssertionError(f"IVF {label} Q={q_n}: bad ivf_topk output")
            ms = time_ms(torch, lambda: ivf.pruned_topk(*args, IVF_K, IVF_BLOCK_Q))
            plain_ms = time_ms(torch, lambda: ivf.pruned_topk_plain(*args, IVF_K, IVF_BLOCK_Q),
                               runs=5, warmup=1)
            if index.scales is None:
                qt = qin.to(index.cells.dtype).reshape(-1, 1, IVF_BLOCK_Q, D)

                def library():
                    sc = torch.matmul(qt, index.cells[probe.long()])  # [tiles, nprobe, block_q, cell]
                    return torch.topk(sc.permute(0, 2, 1, 3).reshape(qin.shape[0], -1), IVF_K)
            else:
                def library():
                    # Per query tile: gather the probed cells into the [D, n]
                    # operand (the layout int_mm_operand found), one _int_mm,
                    # the row then the column scale, torch.topk.
                    out = []
                    for t, pr in enumerate(probe.long()):
                        rows_t = slice(t * IVF_BLOCK_Q, (t + 1) * IVF_BLOCK_Q)
                        cells = index.cells[pr]  # [nprobe, D, cell]
                        b = (cells.permute(1, 0, 2).reshape(D, -1) if ivf_row_major
                             else cells.permute(0, 2, 1).reshape(-1, D).T)
                        sc = int_mm(torch, qin[rows_t], b).float() * qs[rows_t] * \
                            index.scales[pr].reshape(1, -1)
                        out.append(torch.topk(sc, IVF_K))
                    return out
            lib_ms = time_ms(torch, library, runs=5, warmup=1)
            b_ms, b_by = ivf_bound(qin.shape[0], IVF_NPROBE, IVF_CELL, corpus_dtype, ops_type)
            rows[(label, q_n)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                                      bound_by=b_by)
            print(f"kernel ivf_topk[{label}] Q={q_n} N={n} nprobe={IVF_NPROBE} k={IVF_K}: "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of bound [{CARD}]", flush=True)
        print(f"IVF check Q={q_n}: f32 and bf16 within {F32_TOL} of the plain version, "
              f"int8 bitwise equal, ids of every tier equal to the f64 oracle outside tie "
              f"bands", flush=True)

    # The grid rule of the wrapper (ivf._splits: blocks per probed cell)
    # against fixed values: equal outputs, and the time of each.
    if sweep:
        rule = ivf._splits
        try:
            for label, index, precision in (("f32 exact", idx32, "exact"), ("int8", idx8, "fast")):
                for q_n in (1, 8, 64):
                    qin, qs, probe, _ = ivf.stage_queries(q_all[:q_n].contiguous(), index, IVF_NPROBE,
                                                          IVF_BLOCK_Q, precision)
                    args = (qin, qs, index.cells, index.scales, probe, index.n_valid, IVF_K, IVF_BLOCK_Q)
                    chosen = rule(qin.shape[0] // 8, IVF_NPROBE, IVF_CELL // 128, dev)
                    want = ivf.pruned_topk(*args)
                    line = []
                    for fixed in (1, 2, 4, 8, 16):
                        ivf._splits = lambda *a, fixed=fixed: fixed
                        got = ivf.pruned_topk(*args)
                        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                            raise AssertionError(f"IVF {label} Q={q_n}: splits={fixed} gives another result")
                        line.append(f"{fixed}: {time_ms(torch, lambda: ivf.pruned_topk(*args)):.4f} ms")
                    ivf._splits = rule
                    print(f"ivf_topk[{label}] Q={q_n} by splits (the wrapper picks {chosen}): "
                          + ", ".join(line), flush=True)
        finally:
            ivf._splits = rule

    # Full probe equals the exact fused tier over the same vectors.
    q = q_all[:8].contiguous()
    ws, wi = ivf.ivf_topk(q, idx32, IVF_K, nprobe=n_cells, block_q=IVF_BLOCK_Q, precision="exact")
    es, ei = topk.cosine_topk_fused(q, ct32, IVF_K + 1)
    ws, wi, es, ei = (t.cpu().numpy() for t in (ws, wi, es, ei))
    err = float(np.max(np.abs(ws - es[:, :IVF_K])))
    if err > F32_TOL or not ids_agree(es, ei, wi, F32_TOL):
        raise AssertionError(f"IVF full probe differs from the exact fused tier (err {err})")
    approx = ivf.ivf_topk(q, idx32, 10, nprobe=IVF_NPROBE, block_q=IVF_BLOCK_Q, precision="exact")[1]
    recall = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(approx.cpu().numpy(), ei[:, :10])]))
    print(f"IVF full probe (nprobe={n_cells}) equals the exact fused tier within {F32_TOL}; "
          f"recall@10 at nprobe={IVF_NPROBE}: {recall:.3f}", flush=True)
    qin, qs, probe, _ = ivf.stage_queries(q_all, idx32, IVF_NPROBE, IVF_BLOCK_Q, "exact")
    profile_breakdown(torch, "ivf_topk f32", 64,
                      lambda: ivf.pruned_topk(qin, qs, idx32.cells, None, probe, n, IVF_K, IVF_BLOCK_Q))
    ivf.pruned_topk.launches = 0
    topk.cosine_topk_fused.launches = 0
    return {"rows": rows, "max_abs_err": max_err, "n": n, "n_cells": n_cells,
            "inputs": (ct32, q_all, idx32, idx8)}


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


def hybrid_phase(torch, topk, engine, chunks) -> dict:
    """Graph build from the vector index, then graph and hybrid questions on
    the main-path engine, counters at 0 just before."""
    from ragfin_tpu_torch.index import graph_index

    t0 = time.perf_counter()
    built = engine.graph_builder.build_from_vector_index(engine.vector_index)
    packed = engine.graph._pack()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    facts, total = engine.graph.n_facts, int(packed["quarter_ids"].shape[0])
    print(f"graph build: {built['chunks_processed']} chunks processed, {built['chunks_failed']} "
          f"failed, {facts} facts ({facts / len(chunks):.2f} per chunk) in {build_s:.1f} s = "
          f"{len(chunks) / build_s:.0f} chunks/s (rule-based extraction on the host, then one "
          f"pack onto the card)", flush=True)
    if built["chunks_processed"] != len(chunks) or built["chunks_failed"]:
        raise AssertionError(f"graph build did not process every chunk: {built}")
    if total < graph_index.FIRST_K_MIN_ROWS or not packed["quarter_ids"].is_cuda:
        raise AssertionError(f"{total} fact rows: the graph path would not reach the first-k kernel")
    if engine.health()["graph"]["facts"] != facts:
        raise AssertionError("health() does not report the graph's facts")
    engine.warmup()

    banks = sorted({c.company for c in chunks})
    fy24 = next(c for c in chunks if c.period.endswith("FY2024") and c.chunk_type == "profitability_analysis")
    quarter = fy24.period.split("_")[0]
    qs = [
        f"What was {fy24.company}'s net profit in {quarter} FY2024?",      # single quarter
        f"How did {banks[0]}'s net profit evolve across all quarters?",    # all quarters
        f"How did the retail segment of {banks[1]} do?",                   # segment
        f"Which quarter did {banks[2]}'s net profit peak?",                # extremum (max)
        f"Which quarter had the lowest cost ratio for {banks[3]}?",        # extremum (min)
        f"What were {banks[4]}'s deposits and advances trend?",            # company-scoped trend
    ]
    hybrid, graph_builder = engine.hybrid, engine.graph_builder
    torch.cuda.synchronize()

    # ---- the driven run: counters 0 just before, read just after -------
    topk.cosine_topk_fused.launches = 0
    graph_index.masked_first_k.launches = 0
    planned = {q: asyncio.run(graph_builder.query(q, limit=10)) for q in qs}
    searched = {q: asyncio.run(hybrid.graph_search(q)) for q in qs}
    fused = {q: asyncio.run(hybrid.hybrid_query(q, vector_k=10, k_out=20)) for q in qs}
    torch.cuda.synchronize()
    launches = {"fused_topk": topk.cosine_topk_fused.launches,
                "first_k": graph_index.masked_first_k.launches}
    # --------------------------------------------------------------------
    if launches["fused_topk"] < len(qs) or launches["first_k"] < 2 * len(qs):
        raise AssertionError(f"the hybrid path did not go through both kernels: {launches}")
    strategies = {searched[q]["strategy"] for q in qs}
    for q in qs:
        if not planned[q] or not searched[q]["results"]:
            raise AssertionError(f"no graph results for {q!r} ({searched[q]['strategy']})")
        out = fused[q]
        sources = [c["source"] for c in out["chunks"]]
        n_vec = sources.count("vector")
        ids = [c["id"] for c in out["chunks"]]
        if (n_vec != out["vector_hits"] or sources[:n_vec] != ["vector"] * n_vec
                or set(sources[n_vec:]) - {"graph"} or len(set(ids)) != len(ids)
                or any(c["score"] != 1.0 for c in out["chunks"][n_vec:])
                or not all(c["score"] == c["score"] for c in out["chunks"])):
            raise AssertionError(f"hybrid chunks out of order for {q!r}: {sources}")
        if out["graph_results"] != searched[q]["results"]:
            raise AssertionError(f"hybrid and graph_search disagree for {q!r}")
    if not any("graph" in [c["source"] for c in fused[q]["chunks"]] for q in qs):
        raise AssertionError("no question brought a graph-only chunk into the fused list")
    # The same graph searches with the first-k route forced to its plain version.
    kernel = graph_index.masked_first_k
    graph_index.masked_first_k = graph_index.masked_first_k_plain
    try:
        for q in qs:
            if asyncio.run(hybrid.graph_search(q)) != searched[q]:
                raise AssertionError(f"first-k kernel and plain version give other matches for {q!r}")
    finally:
        graph_index.masked_first_k = kernel
    n_graph_only = sum(sources.count("graph") for sources in
                       ([c["source"] for c in fused[q]["chunks"]] for q in qs))
    print(f"hybrid path: {3 * len(qs)} requests over {facts} facts, strategies {sorted(strategies)}, "
          f"{n_graph_only} graph-only chunks fused, launches {launches}, every match equal to the "
          f"plain first-k route", flush=True)
    parts, wall_ms = profiled(torch, lambda: hybrid.hybrid_query_simple(qs[3]), 5)
    busy_ms = sum(ms for ms, _ in parts)
    top = ", ".join(f"{name} {ms:.3f} ms" for ms, name in parts[:6]) or "no device time seen"
    print(f"hybrid request {qs[3]!r} alone: wall {wall_ms:.2f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.1%}; kernels: {top}", flush=True)
    return launches


def ivf_engine_phase(torch, topk, flat_engine, chunks, unscoped, scoped) -> tuple[int, float]:
    """Settings(index_type="ivf") over the same filings: requests through
    the pruned kernel, then full probe against the flat engine."""
    import numpy as np

    from ragfin_tpu_torch.config.settings import Settings
    from ragfin_tpu_torch.ops import ivf
    from ragfin_tpu_torch.serving.engine import RagFinEngine

    t0 = time.perf_counter()
    engine = RagFinEngine(settings=Settings(embed_backend="trained", index_type="ivf",
                                            ivf_nprobe=IVF_NPROBE, index_dir=""), chunks=chunks)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    index = engine.vector_index
    stats = index.stats()
    if (stats["index_type"] != "IVF_BALANCED" or stats["n_cells"] != len(chunks) // IVF_CELL
            or stats["nprobe"] != min(IVF_NPROBE, stats["n_cells"]) or not index.ivf.cells.is_cuda
            or engine.vector_rag._searcher is not None):
        raise AssertionError(f"unexpected IVF engine {stats}")
    print(f"IVF engine: {len(chunks)} chunks encoded and clustered in {build_s:.1f} s; "
          f"stats {json.dumps(stats)}", flush=True)
    request_set = unscoped[:8] + scoped[:4]
    engine.vector_rag.search(request_set[0], top_k=3)  # first call pays one-time costs
    torch.cuda.synchronize()

    # ---- the driven run: counters 0 just before, read just after -------
    ivf.pruned_topk.launches = 0
    hits = {q: engine.vector_rag.search(q, top_k=3) for q in request_set}
    answer = asyncio.run(engine.vector_rag.search_and_answer(request_set[0], top_k=3))
    torch.cuda.synchronize()
    launches = ivf.pruned_topk.launches
    # --------------------------------------------------------------------
    if launches < len(request_set):
        raise AssertionError(f"{len(request_set)} IVF requests made {launches} pruned-kernel launches")
    if not answer.get("answer") or any(len(h) != 3 for h in hits.values()):
        raise AssertionError("the IVF engine did not answer every request")
    # Full probe + the exact host re-score equals the flat engine's raw search.
    a = flat_engine.vector_index.search_texts(request_set, top_k=10)
    b = index.search_texts(request_set, top_k=10, nprobe=stats["n_cells"])
    bad = [q for q, ha, hb in zip(request_set, a, b)
           if not hits_agree([h.to_dict(False) for h in ha], [h.to_dict(False) for h in hb], F32_TOL)]
    if bad:
        raise AssertionError(f"IVF full probe differs from the flat index for {bad}")
    part = index.search_texts(request_set, top_k=10)
    # The pruned kernel against its plain version on this engine's inputs:
    # its cells, its probe table at nprobe 32 and the repair's shortlist width.
    emb = index.embedder.encode_texts(request_set)
    emb = torch.as_tensor(emb).to(index.ivf.cells.device, torch.float32)
    precision = "exact" if index.ivf.cells.dtype == torch.float32 else "fast"
    qin, qs, probe, _ = ivf.stage_queries(emb, index.ivf, stats["nprobe"], IVF_BLOCK_Q, precision)
    args = (qin, qs, index.ivf.cells, index.ivf.scales, probe, index.ivf.n_valid)
    s, i = ivf.pruned_topk(*args, IVF_K, IVF_BLOCK_Q)
    ps, pi = ivf.pruned_topk_plain(*args, IVF_K + 1, IVF_BLOCK_Q)
    s, i, ps, pi = (t.cpu().numpy() for t in (s, i, ps, pi))
    err = float(np.max(np.abs(s - ps[:, :IVF_K])))
    if err > F32_TOL or not ids_agree(ps, pi, i, F32_TOL):
        raise AssertionError(f"IVF engine: kernel differs from its plain version (err {err})")
    kernel = ivf.pruned_topk
    ivf.pruned_topk = ivf.pruned_topk_plain
    try:
        part_plain = index.search_texts(request_set, top_k=10)
    finally:
        ivf.pruned_topk = kernel
    bad = [q for q, ha, hb in zip(request_set, part_plain, part)
           if not hits_agree([h.to_dict(False) for h in ha], [h.to_dict(False) for h in hb], F32_TOL)]
    if bad:
        raise AssertionError(f"IVF engine at nprobe={stats['nprobe']}: hits through the kernel and "
                             f"through its plain version differ for {bad}")
    recall = statistics.mean(len({h.id for h in ha} & {h.id for h in hb}) / 10 for ha, hb in zip(a, part))
    print(f"IVF engine: {len(request_set) + 1} requests, pruned kernel launches {launches}; "
          f"nprobe={stats['n_cells']} hits equal to the flat index's; at nprobe={IVF_NPROBE} "
          f"the kernel is within {F32_TOL} of its plain version on the engine's inputs (max "
          f"{err:.3g}) and the hits are equal with the plain version in its place; recall@10: "
          f"{recall:.3f}", flush=True)
    request_breakdown(torch, engine.vector_rag, request_set[0])
    engine.close()
    return launches, err


def main_chunks():
    """The main path's 131,072 generated filings (seven banks, seed 0)."""
    from ragfin_tpu_torch.eval.distractors import generate_distractors

    pool = generate_distractors(int(N_MAIN * 1.16), seed=SEED)
    chunks = [c for c in pool if c.company != "ICICI Bank"][:N_MAIN]
    if len(chunks) != N_MAIN:
        raise AssertionError(f"generated {len(chunks)} chunks, wanted {N_MAIN}")
    return chunks


def main_engine(chunks):
    """The main path's engine: the trained encoder, an f32 flat index."""
    from ragfin_tpu_torch.config.settings import Settings
    from ragfin_tpu_torch.serving.engine import RagFinEngine

    settings = Settings(embed_backend="trained", index_dtype="float32", batch_queries=True)
    return RagFinEngine(settings=settings, chunks=chunks)


def int8_index(index, chunks):
    """An int8 index over the f32 index's embeddings (the main path's)."""
    from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex

    emb_rows = index.matrix_t[:, : index.n].T.contiguous()
    idx8 = DeviceVectorIndex(emb_rows, chunks, dtype="int8", normalize=False)
    idx8.embedder = index.embedder
    return idx8


def main_path_phase(torch, topk, here: str) -> dict:
    import numpy as np

    from ragfin_tpu_torch.config.settings import Settings
    from ragfin_tpu_torch.serving.engine import RagFinEngine

    n_main = N_MAIN
    t0 = time.perf_counter()
    chunks = main_chunks()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = main_engine(chunks)
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

    hybrid_launches = hybrid_phase(torch, topk, engine, chunks)
    ivf_launches, ivf_err = ivf_engine_phase(torch, topk, engine, chunks, unscoped, scoped)

    # ---- int8 index over the same embeddings ---------------------------
    idx8 = int8_index(index, chunks)
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
    concurrent = concurrent_phase(torch, topk, engine, chunks, here)
    engine.close()
    launches["fused_topk_int8"] = launches8
    launches["first_k"] = hybrid_launches["first_k"]
    launches["ivf_topk"] = ivf_launches
    return {"launches": launches, "p50_ms": p50, "p50_alone_ms": p50_alone,
            "ivf_engine_err": ivf_err, "inputs": (index, idx8, scoped + unscoped),
            "concurrent": concurrent}


# --- phase 3b: integrity-weighted retrieval -----------------------------------

INTEGRITY_COPIES = 8192
INTEGRITY_TOPICS = {
    "profitability_analysis": "net profit",
    "balance_sheet_analysis": "total customer deposits",
    "financial_ratios": "basic EPS",
    "segment_analysis": "retail banking segment revenue",
}


def integrity_phase(torch, work_dir: str) -> dict:
    """Settings(integrity_weight=0.5) over a figure-tampered corpus: the
    generated statements' 16 ICICI FY2024 chunks and 8,192 in-scope tampered
    copies of them. Searches on the card (f32 and int8, strict and smooth)
    against the same searches by the port on the CPU over the same
    embeddings; then the tampered copies against their sources."""
    import numpy as np

    from ragfin_tpu_torch.config.settings import Settings
    from ragfin_tpu_torch.data.loader import build_corpus
    from ragfin_tpu_torch.eval.distractors import generate_inscope_distractors
    from ragfin_tpu_torch.eval.statements import write_extract_data
    from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex
    from ragfin_tpu_torch.retrieval.vector_rag import VectorRAG
    from ragfin_tpu_torch.serving.engine import RagFinEngine

    real = build_corpus(write_extract_data(os.path.join(work_dir, "integrity_data"), seed=44))
    copies = generate_inscope_distractors(real, INTEGRITY_COPIES, seed=SEED + 3,
                                          tiers=("reword", "dupe"))
    chunks = real + copies
    engine = RagFinEngine(Settings(embed_backend="trained", index_dtype="float32",
                                   integrity_weight=0.5, batch_queries=False), chunks=chunks)
    card = engine.vector_index
    t0 = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t0
    col = getattr(card, "_integrity_col", None)
    if col is None or col.shape != (card.matrix_t.shape[1],) or not card.matrix_t.is_cuda:
        raise AssertionError("warmup did not compute the integrity column on a card index")
    emb = card.matrix_t[:, : card.n].T.contiguous()
    indexes = {}
    for dtype in ("float32", "int8"):
        pair = []
        for dev in ("cuda", "cpu"):
            if dtype == "float32" and dev == "cuda":
                idx = card
            else:
                idx = DeviceVectorIndex(emb.to(dev), chunks, dtype=dtype, normalize=False, device=dev)
                idx.embedder = card.embedder
            pair.append(idx)
        indexes[dtype] = pair
    by_period = {}
    for c in real:
        q, fy = c.period.split("_")
        by_period.setdefault(c.period, []).append(
            (c, f"What was ICICI Bank's {INTEGRITY_TOPICS[c.chunk_type]} in {q} {fy}?"))
    unscoped = ["What was the net profit in Q2 FY2024?", "What was the net profit?",
                "Total assets and borrowings", "How did retail banking segment revenue do?"]

    def dicts(hits):
        return [{"id": h.id, "score": h.score} for h in hits]

    compared = 0
    for dtype, (on_card, on_cpu) in indexes.items():
        for strict in (True, False):
            for weight in (0.5, 0.95):
                kw = dict(top_k=10, consistency_weight=weight, consistency_strict=strict)
                runs = [(unscoped + [q for pairs in by_period.values() for _, q in pairs], {})]
                runs += [([q for _, q in pairs], {"period": p}) for p, pairs in by_period.items()]
                for qs, scope in runs:
                    a = on_card.search_texts(qs, **kw, **scope)
                    b = on_cpu.search_texts(qs, **kw, **scope)
                    for q, ha, hb in zip(qs, a, b):
                        if not ha or not hits_agree(dicts(hb), dicts(ha), F32_TOL):
                            raise AssertionError(f"integrity {dtype} strict={strict} w={weight} "
                                                 f"{scope} {q!r}: card {dicts(ha)[:4]} != cpu {dicts(hb)[:4]}")
                        compared += 1
                for p, pairs in by_period.items():
                    tiers = [{"period": p, "company": "ICICI Bank"}, {"period": p}, {}]
                    qs = [q for _, q in pairs]
                    a = on_card.search_texts_tiers(qs, tiers, **kw)
                    b = on_cpu.search_texts_tiers(qs, tiers, **kw)
                    for ta, tb in zip(a, b):
                        for q, ha, hb in zip(qs, ta, tb):
                            if not hits_agree(dicts(hb), dicts(ha), F32_TOL):
                                raise AssertionError(f"integrity tiers {dtype} {p} {q!r} differ")
                            compared += 1
        rag_card = VectorRAG(on_card, integrity_weight=0.5)
        rag_cpu = VectorRAG(on_cpu, integrity_weight=0.5)
        for q in unscoped + [q for pairs in by_period.values() for _, q in pairs]:
            a, b = rag_card.search(q, top_k=5), rag_cpu.search(q, top_k=5)
            if not a or not hits_agree(b, a, F32_TOL):
                raise AssertionError(f"integrity VectorRAG {dtype} {q!r}: {a[:3]} != {b[:3]}")
            compared += 1

    # Tampered copies that fail a check against their source, where the
    # source passes all of its checks, over the whole ranking of the
    # source's period: weighted, every such copy must rank below its source.
    row = {c.id: i for i, c in enumerate(chunks)}
    below = above_unweighted = n_sources = 0
    for p, pairs in by_period.items():
        qs = [q for _, q in pairs]
        weighted = card.search_texts(qs, top_k=card.n, consistency_weight=0.5, period=p)
        plain = card.search_texts(qs, top_k=card.n, period=p)
        for (src, q), hw, hp in zip(pairs, weighted, plain):
            if col[row[src.id]] < 1.0:
                continue
            n_sources += 1
            for hits, weigh in ((hw, True), (hp, False)):
                ids = [h.id for h in hits]
                if src.id not in ids:
                    raise AssertionError(f"source {src.id} not ranked for {q!r} (weighted {weigh})")
                at = ids.index(src.id)
                bad = [j for j, i in enumerate(ids)
                       if i.startswith("inscope_") and i.endswith(src.id) and col[row[i]] < 1.0]
                if weigh:
                    if any(j < at for j in bad):
                        raise AssertionError(f"a failing copy outranks {src.id} for {q!r} weighted")
                    below += len(bad)
                else:
                    above_unweighted += sum(j < at for j in bad)
    if n_sources == 0 or below == 0:
        raise AssertionError("no failing copy was ranked against a passing source")
    n_fail = int(np.sum(col[len(real): card.n] < 1.0))
    print(f"integrity: {card.n} chunks ({len(real)} sources, {len(copies)} tampered copies, "
          f"{n_fail} failing a check), warmup with the integrity column {warm_s:.1f} s; "
          f"{compared} searches on the card (f32 and int8, strict and smooth, weights 0.5 and "
          f"0.95, unscoped, period-scoped, tier groups, VectorRAG) equal to the port on the CPU; "
          f"{below} failing copies of {n_sources} passing sources all rank below their source "
          f"(unweighted, {above_unweighted} of them ranked above it)", flush=True)
    engine.close()
    return {"compared": compared, "below": below, "above_unweighted": above_unweighted}


# --- phase 3c: the hashed backend at 1M chunks -------------------------------

N_HASHED = 524_288  # cut from 1,048,576 to keep the run within half its limit
HASHED_SAMPLE = 4096
HASHED_ORACLE_Q = 64
# The card's bag encode against the port's plain CPU encode (f32 sums in
# another order).
BAG_TOL = 2e-6
# An IVF index persists its repair rows as f16 (the JAX format): reloaded
# scores move by about 1e-4.
F16_TOL = 1e-3


def hashed_questions(chunks) -> tuple[list[str], list[str]]:
    """Six scoped questions (a bank, period and type in the corpus) and six
    that name no bank or period."""
    scoped, unscoped = questions([c for c in chunks if c.company != "ICICI Bank"])
    return scoped[:6], unscoped[:6]


def equal_multiset_groups(featurizer, texts, batch: int = 1024) -> list[list[int]]:
    """Groups of rows (two or more) whose canonical features and weights are
    equal, from encodes in batches of ``batch`` (so each group's rows were
    encoded at different padded widths where they span batches)."""
    groups: dict[bytes, list[int]] = {}
    for s in range(0, len(texts), batch):
        ids, wts = featurizer.encode_batch(texts[s : s + batch])
        nnz = (wts != 0).sum(axis=1)
        for r in range(ids.shape[0]):
            n = int(nnz[r])
            groups.setdefault(ids[r, :n].tobytes() + wts[r, :n].tobytes(), []).append(s + r)
    return [g for g in groups.values() if len(g) > 1]


def hashed_phase(torch, topk, work_dir: str) -> dict:
    """The hashed backend (featurizer on the host, bag encoder on the card)
    at 524,288 generated filings plus the 16 generated ICICI statements:
    f32, int8 and IVF indexes through the engine, every check failing the
    run."""
    import numpy as np

    from ragfin_tpu_torch.config.settings import Settings
    from ragfin_tpu_torch.data.loader import build_corpus
    from ragfin_tpu_torch.eval.distractors import generate_distractors
    from ragfin_tpu_torch.eval.statements import write_extract_data
    from ragfin_tpu_torch.index.ivf_index import IVFVectorIndex
    from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex, SearchHit
    from ragfin_tpu_torch.models import fasthash
    from ragfin_tpu_torch.models.bag_encoder import bag_encode
    from ragfin_tpu_torch.models.embedder import HashedEmbedder
    from ragfin_tpu_torch.models.featurizer import HashedFeaturizer
    from ragfin_tpu_torch.models.synonyms import expand_query
    from ragfin_tpu_torch.ops import ivf
    from ragfin_tpu_torch.retrieval.vector_rag import VectorRAG
    from ragfin_tpu_torch.serving.engine import RagFinEngine, get_engine, reset_engine

    # 1. The native featurizer, the port's own build of native/fasthash.cpp.
    if not fasthash.available():
        raise AssertionError(f"the native featurizer did not load ({fasthash.LIB_PATH})")
    t0 = time.perf_counter()
    gold = build_corpus(write_extract_data(os.path.join(work_dir, "hashed_data"), seed=44))
    chunks = generate_distractors(N_HASHED, seed=SEED + 2) + gold
    texts = [c.text for c in chunks]
    gen_s = time.perf_counter() - t0
    sample = texts[:N_MAIN]
    t0 = time.perf_counter()
    HashedFeaturizer().fit(sample)
    fit_rate = len(sample) / (time.perf_counter() - t0)

    # The engine as a user builds it: Settings(embed_backend="hashed").
    reset_engine()
    f32_dir = os.path.join(work_dir, "hashed_f32")
    settings = Settings(embed_backend="hashed", index_dtype="float32", index_dir=f32_dir)
    t0 = time.perf_counter()
    engine = get_engine(settings=settings, chunks=chunks)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    index = engine.vector_index
    if (index.n != len(chunks) or index.dtype != torch.float32 or not index.matrix_t.is_cuda
            or not isinstance(index.embedder, HashedEmbedder) or not index.encoder.table.is_cuda):
        raise AssertionError(f"unexpected hashed index {index.stats()}")
    feat, enc = index.featurizer, index.encoder
    t0 = time.perf_counter()
    groups = equal_multiset_groups(feat, sample)
    encode_rate = len(sample) / (time.perf_counter() - t0)
    print(f"hashed: {len(chunks)} chunks ({len(gold)} gold) generated in {gen_s:.1f} s; native "
          f"featurizer {fasthash.LIB_PATH}; fit {fit_rate:.0f} chunks/s, encode {encode_rate:.0f} "
          f"chunks/s (host, {len(sample)} chunks); engine built (featurize + bag encode + pack) in "
          f"{build_s:.1f} s = {len(chunks) / build_s:.0f} chunks/s; {CARD}", flush=True)

    # 2. The bag encode on the card against the port's plain CPU encode, and
    # equal feature multisets bitwise equal in the served matrix.
    rng = np.random.default_rng(SEED)
    rows = np.sort(rng.choice(len(chunks), HASHED_SAMPLE, replace=False))
    ids, wts = feat.encode_batch([texts[r] for r in rows])
    on_card = enc.encode(ids, wts)
    plain = bag_encode(enc.table.cpu(), torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(wts))
    bag_err = float((on_card.cpu() - plain).abs().max())
    served = index.matrix_t[:, torch.as_tensor(rows, device=index.device)].T.cpu()
    served_err = float((served - plain).abs().max())
    if bag_err > BAG_TOL or served_err > BAG_TOL:
        raise AssertionError(f"bag encode on the card differs from the plain CPU encode by "
                             f"{bag_err:.3g} (served rows {served_err:.3g}) > {BAG_TOL}")
    cross = [g for g in groups if len({r // 1024 for r in g}) > 1]
    if not cross:
        raise AssertionError("no equal-multiset group spans two encode batches")
    first = torch.as_tensor([g[0] for g in groups for _ in g[1:]], device=index.device)
    other = torch.as_tensor([r for g in groups for r in g[1:]], device=index.device)
    if not bool((index.matrix_t[:, first] == index.matrix_t[:, other]).all()):
        raise AssertionError("rows with equal feature multisets differ in the served matrix")
    n_bag = min(len(sample), 64 * 1024)
    batch = [feat.encode_batch(sample[s : s + 1024]) for s in range(0, n_bag, 1024)]
    batch = [(torch.as_tensor(i.astype(np.int64)).to(index.device),
              torch.as_tensor(w).to(index.device)) for i, w in batch]

    def bag_only():
        for i, w in batch:
            bag_encode(enc.table, i, w)

    bag_ms = time_ms(torch, bag_only, runs=5, warmup=1)
    print(f"hashed bag encode: {HASHED_SAMPLE} sampled rows on the card within {bag_err:.3g} of "
          f"the plain CPU encode (served rows {served_err:.3g}); {len(groups)} equal-multiset "
          f"groups in the first {len(sample)} chunks ({len(cross)} across encode batches, "
          f"largest {max(map(len, groups))}) bitwise equal in the served matrix; bag encode on "
          f"the card {n_bag / bag_ms * 1e3:.0f} chunks/s ({n_bag} chunks, "
          f"{batch[0][0].shape[1]} slots; {CARD})", flush=True)

    # 3. The fused kernel's ids against a host f64 oracle over the served matrix.
    scoped, unscoped = hashed_questions(chunks)
    qtexts = [expand_query(q) for q in scoped + unscoped]
    qtexts += [texts[r][:240] for r in rows[: HASHED_ORACLE_Q - len(qtexts)]]
    q = torch.as_tensor(index.embedder.encode_texts(qtexts)).to(index.device)
    s, i = index.search_embeddings(q, top_k=10)
    ref_s, ref_i = f64_oracle(torch, q, index.matrix_t, 11, index.n)
    oracle_err = score_err(s.cpu().numpy(), ref_s[:, :10])
    if oracle_err > F32_TOL or not ids_agree(ref_s, ref_i, i.cpu().numpy(), F32_TOL):
        raise AssertionError(f"hashed: fused ids differ from the f64 oracle (err {oracle_err:.3g})")

    engine.warmup()
    rag = engine.vector_rag
    asked = scoped + unscoped

    def drive(eng) -> tuple[dict, dict]:
        """Each question through VectorRAG.search (FilteredSearch, rerank 64,
        query expansion) and the engine's hybrid search (its vector half is
        the unfiltered search: the fused kernel)."""
        served = {q: eng.vector_rag.search(q, top_k=3) for q in asked}
        hybrid = {q: asyncio.run(eng.hybrid.hybrid_query(q, vector_k=10)) for q in asked}
        torch.cuda.synchronize()
        return served, hybrid

    # ---- the driven run (f32): counters 0 just before, read just after ----
    topk.cosine_topk_fused.launches = 0
    topk.cosine_topk_fused_int8.launches = 0
    served32, hybrid32 = drive(engine)
    launches = {"fused_topk": topk.cosine_topk_fused.launches,
                "fused_topk_int8": topk.cosine_topk_fused_int8.launches}
    # ------------------------------------------------------------------------
    if launches["fused_topk"] < len(asked):
        raise AssertionError(f"{len(asked)} hashed hybrid requests made {launches} fused launches")

    # 4. Served hits against the same searches on the dense tiers.
    def against_dense(idx, served: dict, label: str) -> None:
        searcher = VectorRAG(idx, integrity_weight=0.0)._searcher
        wide = rag._detection_fetch(3)
        bad = []
        for q in asked:
            plan = [h.to_dict(False) for h in searcher.search_texts([q], top_k=wide)[0]]
            dense = [h.to_dict(False) for h in searcher.search_texts([q], top_k=wide, method="dense")[0]]
            flat = [h.to_dict(False) for h in idx.search_texts([q], top_k=10)[0]]
            flat_dense = [h.to_dict(False) for h in idx.search_texts([q], top_k=10, method="dense")[0]]
            if not (served[q] and hits_agree(dense, plan, F32_TOL)
                    and hits_agree(plan[:3], served[q], F32_TOL)
                    and hits_agree(flat_dense, flat, F32_TOL)):
                bad.append(q)
        if bad:
            raise AssertionError(f"hashed {label}: served hits differ from the dense tiers for {bad}")

    against_dense(index, served32, "f32")
    breakdown = request_breakdown(torch, rag, unscoped[0])
    shortlist = index.search_texts([expand_query(unscoped[0])], top_k=64)[0]

    def rerank_once():
        index._sparse_rerank(expand_query(unscoped[0]),
                             [SearchHit(h.score, h.record, h.rank) for h in shortlist], 3)

    t0 = time.perf_counter()
    for _ in range(10):
        rerank_once()
    rerank_ms = (time.perf_counter() - t0) * 100
    print(f"hashed f32: {2 * len(asked)} requests ({len(scoped)} scoped and {len(unscoped)} "
          f"unscoped questions through VectorRAG.search and hybrid_query), launches {launches}; "
          f"fused ids equal to the f64 oracle for {len(qtexts)} queries (max err "
          f"{oracle_err:.3g}); served hits equal to the dense tiers; _sparse_rerank of 64 "
          f"hits {rerank_ms:.2f} ms on the host", flush=True)

    # 7. Persist and reload the f32 index.
    t0 = time.perf_counter()
    engine.persist()
    persist_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = DeviceVectorIndex.load(f32_dir)
    torch.cuda.synchronize()
    reload_s = time.perf_counter() - t0

    def same_hits(a, b, label: str, tol: float = F32_TOL) -> None:
        for kw in ({"rerank": 64}, {}):
            ha, hb = a.search_texts(asked, top_k=10, **kw), b.search_texts(asked, top_k=10, **kw)
            bad = [q for q, x, y in zip(asked, ha, hb)
                   if not x or not hits_agree([h.to_dict(False) for h in x],
                                              [h.to_dict(False) for h in y], tol)]
            if bad:
                raise AssertionError(f"hashed {label}: reloaded hits differ ({kw}) for {bad}")

    same_hits(index, again, "f32")

    # The int8 index from the reloaded f32 index's matrix (the persisted
    # one: the corpus is featurized once), with its featurizer and encoder.
    t0 = time.perf_counter()
    idx8 = DeviceVectorIndex(again.matrix_t[:, : again.n].T, again.records, dtype="int8",
                             normalize=False)
    idx8._attach(again.embedder)
    torch.cuda.synchronize()
    build8_s = time.perf_counter() - t0
    del again
    engine8 = RagFinEngine(Settings(embed_backend="hashed", index_dtype="int8", index_dir=""),
                           vector_index=idx8)
    engine8.warmup()
    topk.cosine_topk_fused.launches = 0
    topk.cosine_topk_fused_int8.launches = 0
    served8, hybrid8 = drive(engine8)
    launches8 = topk.cosine_topk_fused_int8.launches
    if launches8 < len(asked):
        raise AssertionError(f"{len(asked)} hashed int8 hybrid requests made {launches8} int8 launches")
    launches["fused_topk_int8"] = launches8
    against_dense(idx8, served8, "int8")
    # The int8 shortlist (16 wide, then the exact host re-score) need not
    # hold the f32 top 10 of a hashed corpus, so the int8 hits are held to
    # the same requests with the kernel's plain version in its place.
    with index_int8_plain(topk):
        plain8, plain_hybrid8 = drive(engine8)
    diff8 = [q for q in asked if not hits_agree(plain8[q], served8[q], F32_TOL)
             or not hits_agree(plain_hybrid8[q]["chunks"], hybrid8[q]["chunks"], F32_TOL)]
    if diff8:
        raise AssertionError(f"hashed int8: hits through the kernel and through its plain "
                             f"version differ for {diff8}")
    int8_dir = os.path.join(work_dir, "hashed_int8")
    t0 = time.perf_counter()
    idx8.save(int8_dir)
    persist8_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again8 = DeviceVectorIndex.load(int8_dir)
    reload8_s = time.perf_counter() - t0
    if not again8.quantized:
        raise AssertionError("the int8 index reloaded as another dtype")
    same_hits(idx8, again8, "int8")
    del again8
    engine8.close()
    print(f"hashed int8: quantized from the reloaded f32 index's matrix in {build8_s:.1f} s; "
          f"{2 * len(asked)} requests, int8 kernel launches {launches8}, hits equal to the same "
          f"requests through the kernel's plain version", flush=True)

    # 5. The IVF index from the f32 one, requests through the pruned kernel.
    t0 = time.perf_counter()
    ivf_index = IVFVectorIndex.from_dense(index, nprobe=IVF_NPROBE)
    torch.cuda.synchronize()
    ivf_build_s = time.perf_counter() - t0
    engine_ivf = RagFinEngine(Settings(embed_backend="hashed", index_type="ivf", index_dir=""),
                              vector_index=ivf_index)
    engine_ivf.vector_rag.search(asked[0], top_k=3)  # first call pays one-time costs
    torch.cuda.synchronize()
    ivf.pruned_topk.launches = 0
    served_ivf = {q: engine_ivf.vector_rag.search(q, top_k=3) for q in asked}
    torch.cuda.synchronize()
    launches["ivf_topk"] = ivf.pruned_topk.launches
    if launches["ivf_topk"] < len(asked) or not all(served_ivf.values()):
        raise AssertionError(f"{len(asked)} hashed IVF requests made {launches['ivf_topk']} launches")
    n_cells = ivf_index.ivf.n_cells
    full = ivf_index.search_texts(asked, top_k=10, nprobe=n_cells)
    flat = index.search_texts(asked, top_k=10)
    bad = [q for q, a, b in zip(asked, full, flat)
           if not hits_agree([h.to_dict(False) for h in b], [h.to_dict(False) for h in a], F32_TOL)]
    if bad:
        raise AssertionError(f"hashed IVF at full probe differs from the flat index for {bad}")
    ivf_dir = os.path.join(work_dir, "hashed_ivf")
    t0 = time.perf_counter()
    ivf_index.save(ivf_dir)
    persist_ivf_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again_ivf = IVFVectorIndex.load(ivf_dir)
    reload_ivf_s = time.perf_counter() - t0
    if not isinstance(again_ivf.embedder, HashedEmbedder):
        raise AssertionError("the reloaded IVF index lost its hashed embedder")
    ha, hb = ivf_index.search_texts(asked, top_k=10), again_ivf.search_texts(asked, top_k=10)
    bad = [q for q, x, y in zip(asked, ha, hb)
           if not hits_agree([h.to_dict(False) for h in x], [h.to_dict(False) for h in y], F16_TOL)]
    if bad:
        raise AssertionError(f"hashed IVF: reloaded hits differ for {bad}")
    del again_ivf
    engine_ivf.close()
    print(f"hashed IVF: {n_cells} cells clustered from the f32 index in {ivf_build_s:.1f} s; "
          f"{len(asked)} requests, pruned kernel launches {launches['ivf_topk']}; full probe "
          f"equal to the flat index", flush=True)
    print(f"hashed persist / reload seconds: f32 {persist_s:.1f} / {reload_s:.1f}, int8 "
          f"{persist8_s:.1f} / {reload8_s:.1f}, IVF {persist_ivf_s:.1f} / {reload_ivf_s:.1f}; "
          f"reloaded hits equal (IVF's f16 repair rows within {F16_TOL})", flush=True)

    # 6. Integrity mode on the card: a scoped bucket of at most
    # exact_bucket_max rows is scored exactly on the host, with no device
    # work; a larger one goes to the device tiers. On the first N_MAIN chunks
    # (and the gold): the integrity column is host work at ~10k chunks/s.
    sub = list(range(N_MAIN)) + list(range(N_HASHED, len(chunks)))
    sub_t = torch.as_tensor(sub, device=index.device)
    small = DeviceVectorIndex(index.matrix_t[:, sub_t].T, [chunks[r] for r in sub], normalize=False)
    small.embedder, small.featurizer, small.encoder = index.embedder, feat, enc
    t0 = time.perf_counter()
    small.integrity_column()
    column_s = time.perf_counter() - t0
    weighted = VectorRAG(small, integrity_weight=0.5)
    searcher = weighted._searcher
    q0 = scoped[0]
    plan = searcher._tier_groups(q0, *searcher._vocab())[0]
    sizes = [int(small._filter_mask(None, f.get("chunk_type"), None, periods=f.get("periods"),
                                    company=f.get("company"))[: small.n].sum()) for f in plan]
    if not sizes or max(sizes) > small.exact_bucket_max or min(sizes) < 1:
        raise AssertionError(f"scoped buckets {sizes} for {q0!r}")
    counters = (topk.cosine_topk_fused, topk.cosine_topk_fused_int8, ivf.pruned_topk)
    for c in counters:
        c.launches = 0
    exact_kernels, exact_wall, _ = kernel_profile(torch, lambda: weighted.search(q0, top_k=3), 3)
    exact_hits = weighted.search(q0, top_k=3)
    if exact_kernels or any(c.launches for c in counters) or not exact_hits:
        raise AssertionError(f"the exact-bucket path ran device work: {exact_kernels}")
    company = plan[0].get("company")
    big = int(small._filter_mask(periods=sorted({c.period for c in small.records}))[: small.n].sum())
    big_kernels, _, _ = kernel_profile(torch, lambda: small.search_texts(
        [q0], top_k=3, periods=sorted({c.period for c in small.records}),
        consistency_weight=0.5), 3)
    if big <= small.exact_bucket_max or not big_kernels:
        raise AssertionError(f"a {big}-row bucket did not go to the device tiers")
    print(f"hashed integrity (weight 0.5, {small.n} chunks, column {column_s:.1f} s): {q0!r} "
          f"(company {company!r}) has buckets of {sizes} rows <= {small.exact_bucket_max}: "
          f"exact host path, no CUDA kernel and no launch, {exact_wall:.2f} ms a request; a "
          f"{big}-row bucket ran {sum(n for n, _ in big_kernels.values())} CUDA kernels on the "
          f"device tiers", flush=True)
    engine.close()
    reset_engine()
    return {"launches": launches, "breakdown": breakdown, "rerank_ms": rerank_ms}


# --- phase 3d: the minilm backend ------------------------------------------------

MINILM_COS = 0.999
MINILM_CHECK_ROWS = 256


def minilm_phase(torch, topk, work_dir: str) -> dict:
    """A synthetic HF-layout checkpoint at the public all-MiniLM-L6-v2
    widths (seeded weights, written here; nothing is downloaded), loaded from
    both formats; an engine with embed_backend="minilm" over N_MAIN
    generated filings; the card's bf16 forward against the port's f32 CPU
    forward; six questions through the fused kernel."""
    import dataclasses

    import numpy as np

    from ragfin_tpu_torch.config.settings import Settings
    from ragfin_tpu_torch.eval.distractors import generate_distractors
    from ragfin_tpu_torch.models import minilm
    from ragfin_tpu_torch.models.embedder import MiniLMEmbedder
    from ragfin_tpu_torch.serving.engine import RagFinEngine
    from ragfin_tpu_torch.utils.synthetic import wordpiece_vocab

    pool = generate_distractors(int(N_MAIN * 1.16), seed=SEED + 4)
    chunks = [c for c in pool if c.company != "ICICI Bank"][:N_MAIN]
    words = sorted({w.strip(".,?:;()%'") for c in chunks[:4096] for w in c.text.lower().split()})
    config = minilm.MiniLMConfig()
    state = minilm.init_params(config, seed=SEED + 4)
    vocab = wordpiece_vocab([w for w in words if w], config.vocab_size)
    ckpt = os.path.join(work_dir, "minilm_ckpt")
    t0 = time.perf_counter()
    minilm.save_hf_weights(ckpt, state, vocab=vocab)
    write_s = time.perf_counter() - t0
    only = {}
    for fmt, name in (("safetensors", "model.safetensors"), ("bin", "pytorch_model.bin")):
        d = os.path.join(work_dir, f"minilm_{fmt}")
        os.makedirs(d, exist_ok=True)
        os.link(os.path.join(ckpt, name), os.path.join(d, name))
        only[fmt] = minilm.load_hf_weights(d, config)
    if set(only["safetensors"]) != set(state) or any(
            not torch.equal(only["safetensors"][k], only["bin"][k])
            or not torch.equal(only["bin"][k], state[k]) for k in state):
        raise AssertionError("model.safetensors and pytorch_model.bin load different weights")

    t0 = time.perf_counter()
    engine = RagFinEngine(Settings(embed_backend="minilm", minilm_checkpoint=ckpt, index_dir=""),
                          chunks=chunks)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    index = engine.vector_index
    emb = index.embedder
    if (not isinstance(emb, MiniLMEmbedder) or not emb.pretrained or index.n != len(chunks)
            or not index.matrix_t.is_cuda or engine.settings.validate()):
        raise AssertionError(f"unexpected minilm engine: {emb.state_dict()} {index.stats()}")
    texts = [c.text for c in chunks[:MINILM_CHECK_ROWS]]
    card = emb.encode_texts(texts)
    cpu = minilm.MiniLMEncoder(dataclasses.replace(config, dtype=torch.float32))
    cpu.load_state_dict(state)
    ids, mask = emb.tokenizer.encode_batch(texts)
    with torch.inference_mode():
        ref = cpu.eval()(torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask)).numpy()
    cos = float((card * ref).sum(1).min())
    if cos < MINILM_COS:
        raise AssertionError(f"minilm: card bf16 against CPU f32 forward, min cosine {cos:.5f}")
    ids_t = torch.from_numpy(ids.astype(np.int64)).to(index.device)
    mask_t = torch.from_numpy(mask).to(index.device)
    reps = 16

    def encode_only():
        with torch.inference_mode():
            for _ in range(reps):
                emb.model(ids_t, mask_t)

    enc_ms = time_ms(torch, encode_only, runs=3, warmup=1)
    engine.warmup()
    _, unscoped = questions(chunks)
    asked = unscoped[:6]
    rag = engine.vector_rag
    rag.search(asked[0], top_k=3)
    torch.cuda.synchronize()
    # ---- the driven run: counters 0 just before, read just after -----------
    topk.cosine_topk_fused.launches = 0
    served = {q: rag.search(q, top_k=3) for q in asked}
    torch.cuda.synchronize()
    launches = topk.cosine_topk_fused.launches
    # ------------------------------------------------------------------------
    if launches < len(asked) or not all(served.values()):
        raise AssertionError(f"{len(asked)} minilm requests made {launches} fused launches")
    searcher = rag._searcher
    bad = [q for q in asked
           if not hits_agree([h.to_dict(False) for h in searcher.search_texts([q], top_k=3, method="dense")[0]],
                             served[q], BATCH_TOL)]
    if bad:
        raise AssertionError(f"minilm served hits differ from the dense tier for {bad}")
    print(f"minilm: checkpoint ({config.num_layers} layers, hidden {config.hidden_size}, vocab "
          f"{config.vocab_size}) written in {write_s:.1f} s, safetensors and pytorch_model.bin "
          f"load equal weights; engine over {len(chunks)} chunks built in {build_s:.1f} s = "
          f"{len(chunks) / build_s:.0f} chunks/s (encoder forward alone "
          f"{reps * len(texts) / enc_ms * 1e3:.0f} chunks/s at {ids.shape[1]} tokens); card bf16 "
          f"against CPU f32 forward on {len(texts)} chunks: min cosine {cos:.5f}; {len(asked)} "
          f"requests, fused launches {launches}, hits equal to the dense tier; {CARD}", flush=True)
    breakdown = request_breakdown(torch, rag, asked[0])
    engine.close()
    return {"launches": launches, "breakdown": breakdown, "cos": cos}


# --- phase 3e: training ---------------------------------------------------------

TRAIN_QUESTIONS = 512
TRAIN_LOSS_RTOL = 1e-4  # the bag fine-tune's first epoch, card against CPU
DOMAIN_STEPS, DOMAIN_BATCH, DOMAIN_CHUNK, DOMAIN_Q, DOMAIN_D = 50, 256, 25, 64, 192
# The domain encoder's first-step loss, card bf16 against CPU bf16 (cuBLAS
# and the CPU's GEMMs round bf16 products at other places): 1.19e-4 measured
# on an H100 at batch 256.
DOMAIN_LOSS_TOL = 1e-3
TRAIN_TEMPLATES = {
    "profitability_analysis": "What was {bank}'s net profit in {q} {fy}?",
    "balance_sheet_analysis": "What were {bank}'s total customer deposits in {q} {fy}?",
    "financial_ratios": "What was the basic EPS of {bank} for {q} {fy}?",
    "segment_analysis": "How did {bank}'s treasury segment revenue do in {q} {fy}?",
}


def train_questions(n: int, seed: int):
    """``n`` gold filings, each the only one of its (bank, quarter, fiscal
    year, statement) cell: years 2004-2017, which the generated corpus
    (2018-2031) never uses. One question per filing names its cell; its
    expected chunk is the filing's own id."""
    import numpy as np

    from ragfin_tpu_torch.data.models import IndexedChunk
    from ragfin_tpu_torch.eval.datasets import EvalQuestion
    from ragfin_tpu_torch.eval.distractors import _TEMPLATES, BANKS

    r = np.random.default_rng(seed)
    cells = [(b, q, y, t) for b in BANKS for y in range(2004, 2018) for q in range(1, 5)
             for t in range(len(_TEMPLATES))]
    gold, qs = [], []
    for i in r.choice(len(cells), n, replace=False):
        bank, q, year, t = cells[int(i)]
        ctype, fn, stype = _TEMPLATES[t]
        period = f"Q{q}_FY{year}"
        cid = f"gold_{len(gold):05d}_{bank.split()[0].lower()}_{period.lower()}_{ctype}"
        gold.append(IndexedChunk(id=cid, text=fn(bank, period, r), period=period, chunk_type=ctype,
                                 statement_type=stype, company=bank))
        qs.append(EvalQuestion(id=f"t{len(qs)}", category=ctype.split("_")[0],
                               question=TRAIN_TEMPLATES[ctype].format(bank=bank, q=f"Q{q}", fy=f"FY{year}"),
                               expected_chunks=[cid]))
    return gold, qs


def step_profile(torch, label: str, step, state, batch, reps: int) -> tuple[float, float]:
    """(device busy ms, host wall ms) per training step from torch.profiler.
    Busy time is the union of the CUDA kernels' and copies' intervals: the
    autograd and optimizer ranges on the host carry their kernels' device
    time too, so summing key_averages() would count it twice. Prints the
    kernels that take most of it (device ms per step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    spans, by_name = [], {}
    for ev in prof.events():
        # user annotations (the optimizer's step range) span gaps as well
        if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False):
            spans.append((ev.time_range.start, ev.time_range.end))
            name = ev.name
            for noise in ("void ", "(anonymous namespace)::", "at::native::", "at_cuda_detail::"):
                name = name.replace(noise, "")
            name = name[:56]
            by_name[name] = by_name.get(name, 0.0) + ev.time_range.elapsed_us() / 1e3 / reps
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_ms = busy_us / 1e3 / reps
    if busy_ms <= 0:
        raise AssertionError(f"{label}: the profiler saw no device time in a training step")
    top = sorted(((ms, name) for name, ms in by_name.items()), reverse=True)[:6]
    print(f"{label} step profile: {len(spans) / reps:.0f} device events per step; "
          + ", ".join(f"{name} {ms:.3f} ms" for ms, name in top), flush=True)
    return busy_ms, wall_ms


def bag_train_check(torch, topk, dev, chunks, qs) -> dict:
    """(a) The bag encoder fine-tuned at the hashed backend's width:
    finetune_and_evaluate as cli train runs it, with the fused kernel's
    counter at 0 just before; the first epoch on the card against the CPU;
    steps/s and one step's device time."""
    import numpy as np

    from ragfin_tpu_torch.models import finetune
    from ragfin_tpu_torch.models.bag_encoder import BagEncoder
    from ragfin_tpu_torch.models.featurizer import HashedFeaturizer
    from ragfin_tpu_torch.models.training import AdamW, bag_apply, init_train_state, make_train_step

    kw = dict(batch_size=16, learning_rate=3e-3, temperature=0.1)  # JAX's defaults
    t0 = time.perf_counter()
    feat = HashedFeaturizer().fit([c.text for c in chunks])
    fit_s = time.perf_counter() - t0
    pairs = finetune.PairDataset.from_eval_questions(qs, chunks)
    if len(pairs) != len(qs):
        raise AssertionError(f"{len(pairs)} pairs from {len(qs)} questions")
    card_loss, cpu_loss = (
        finetune.finetune_bag_encoder(pairs, feat, BagEncoder(device=d), epochs=1, **kw)[1][0]["loss"]
        for d in (dev, "cpu"))
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    if rel > TRAIN_LOSS_RTOL or not np.isfinite(card_loss):
        raise AssertionError(f"bag first epoch: card loss {card_loss} against CPU {cpu_loss}")
    # steps/s over a whole default run (20 epochs) on the card
    rng = np.random.default_rng(0)
    steps = sum(len(b) >= 2 for _ in range(20) for b in finetune.epoch_batches(pairs, 16, rng))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    finetune.finetune_bag_encoder(pairs, feat, BagEncoder(device=dev), epochs=20, **kw)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    # one step's device time and idle share
    q_ids, q_w = feat.encode_batch(pairs.queries[:16])
    d_ids, d_w = feat.encode_batch(pairs.documents[:16])
    batch = {side: {"ids": torch.from_numpy(i.astype(np.int64)).to(dev),
                    "weights": torch.from_numpy(w.astype(np.float32)).to(dev)}
             for side, i, w in (("query", q_ids, q_w), ("doc", d_ids, d_w))}
    opt = AdamW(3e-3)
    state = init_train_state(BagEncoder(device=dev).table, opt)
    busy_ms, wall_ms = step_profile(torch, "train bag", make_train_step(bag_apply, opt, 0.1), state, batch, 20)

    # ---- the driven run: counters 0 just before, read just after ----------
    topk.cosine_topk_fused.launches = 0
    t0 = time.perf_counter()
    out = finetune.finetune_and_evaluate(chunks, qs, k=3, device=dev, epochs=20, **kw)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = topk.cosine_topk_fused.launches
    # -------------------------------------------------------------------------
    hist = out["history"]
    if launches < 2 or out["pairs"] != len(qs):
        raise AssertionError(f"bag fine-tune: {launches} fused launches, {out['pairs']} pairs")
    if not (out["after"]["recall"] >= out["before"]["recall"] and hist[-1]["loss"] < hist[0]["loss"]):
        raise AssertionError(f"bag fine-tune did not improve: {out['before']} -> {out['after']}, "
                             f"loss {hist[0]['loss']} -> {hist[-1]['loss']}")
    print(f"train bag: {len(chunks)} chunks, {len(qs)} questions, table 65536 x {D} f32; featurizer "
          f"fit {fit_s:.1f} s; first epoch loss card {card_loss:.7f}, CPU {cpu_loss:.7f} "
          f"(rel {rel:.2e}, limit {TRAIN_LOSS_RTOL:g}); 20 epochs = {steps} steps in {run_s:.2f} s = "
          f"{steps / run_s:.1f} steps/s; one step device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
          f"wall, idle share {1 - busy_ms / wall_ms:.1%}; finetune_and_evaluate {total_s:.1f} s: "
          f"recall {out['before']['recall']:.4f} -> {out['after']['recall']:.4f}, F1 "
          f"{out['before']['f1']:.4f} -> {out['after']['f1']:.4f}, loss {hist[0]['loss']:.4f} -> "
          f"{hist[-1]['loss']:.4f}; fused launches in the two evals {launches}; {CARD}", flush=True)
    return {"launches": launches, "steps_per_s": steps / run_s, "step_busy_ms": busy_ms,
            "step_wall_ms": wall_ms, "before": out["before"], "after": out["after"],
            "loss_rel_err": rel}


def domain_train_check(torch, topk, dev, here: str, work_dir: str) -> dict:
    """(b) The domain encoder warm-started from the committed checkpoint at
    full width, the first step's loss against the CPU, the saved checkpoint
    against the committed one, then served over the main path's filings."""
    import numpy as np

    from ragfin_tpu_torch.config.settings import Settings
    from ragfin_tpu_torch.eval.distractors import generate_distractors
    from ragfin_tpu_torch.models import domain_encoder, minilm, pairgen
    from ragfin_tpu_torch.models.embedder import TrainedEmbedder
    from ragfin_tpu_torch.models.minilm import minilm_apply
    from ragfin_tpu_torch.models.training import AdamW, info_nce_loss, init_train_state, make_train_step
    from ragfin_tpu_torch.serving.engine import get_engine, reset_engine

    parent = os.path.join(here, "checkpoints", "domain_encoder")
    ckpt = os.path.join(work_dir, "domain_encoder")
    lines: list[str] = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # left by earlier phases
    t0 = time.perf_counter()
    res = domain_encoder.train_domain_encoder(
        steps=DOMAIN_STEPS, batch_size=DOMAIN_BATCH, query_len=DOMAIN_Q, doc_len=DOMAIN_D,
        scan_chunk=DOMAIN_CHUNK, init_from=parent, ckpt_dir=ckpt, device=dev, log=lines.append,
    )
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    hist = res["history"]
    dev_s = sum(h["chunk_s"] for h in hist)
    tokens = DOMAIN_STEPS * DOMAIN_BATCH * (DOMAIN_Q + DOMAIN_D)
    if len(hist) != -(-DOMAIN_STEPS // DOMAIN_CHUNK) or not all(np.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"domain training history {hist}")

    # The first step's loss (the parent's parameters on the first batch) on
    # the card against the CPU, bf16 activations both.
    flax_params, tok, config, _ = domain_encoder.load_encoder_checkpoint(parent)
    rng = np.random.default_rng(0)  # the trainer's seed: its first batch
    queries, docs = pairgen.pair_batch(rng, DOMAIN_BATCH)
    sides = {}
    for side, texts, length in (("query", queries, DOMAIN_Q), ("doc", docs, DOMAIN_D)):
        ids, mask = domain_encoder._fixed_len(*tok.encode_batch(texts), length)
        sides[side] = {"input_ids": torch.from_numpy(ids.astype(np.int64)),
                       "attention_mask": torch.from_numpy(mask.astype(np.int64))}
    first = []
    for d in (dev, torch.device("cpu")):
        model = minilm.MiniLMEncoder(config)
        model.load_state_dict(minilm.params_from_flax(flax_params))
        model.to(d)
        batch = {s: {k: v.to(d) for k, v in side.items()} for s, side in sides.items()}
        with torch.inference_mode():
            loss = info_nce_loss(minilm_apply(model, batch["query"]), minilm_apply(model, batch["doc"]), 0.05)
        first.append(float(loss))
    gap = abs(first[0] - first[1])
    if gap > DOMAIN_LOSS_TOL or not np.isfinite(first[0]):
        raise AssertionError(f"domain first-step loss: card {first[0]} against CPU {first[1]}")

    # One step's device time and idle share, on the card, from the parent.
    model = minilm.MiniLMEncoder(config)
    model.load_state_dict(minilm.params_from_flax(flax_params))
    model.to(dev).train()
    opt = AdamW(3e-4, weight_decay=0.01, max_grad_norm=1.0)
    batch = {s: {k: v.to(dev) for k, v in side.items()} for s, side in sides.items()}
    busy_ms, wall_ms = step_profile(torch, "train domain encoder", make_train_step(minilm_apply, opt, 0.05),
                                    init_train_state(model, opt), batch, 3)
    del model

    # The checkpoint written must match the committed one's layout.
    with np.load(os.path.join(parent, "params.npz")) as a, np.load(os.path.join(ckpt, "params.npz")) as b:
        if sorted(a.files) != sorted(b.files) or any(
                b[k].shape != a[k].shape or b[k].dtype != np.float16 for k in a.files):
            raise AssertionError("the trained params.npz differs in keys, shapes or dtype")
    print(f"train domain encoder: warm start from checkpoints/domain_encoder, {DOMAIN_STEPS} steps of "
          f"{DOMAIN_BATCH} pairs (q {DOMAIN_Q}, d {DOMAIN_D} tokens) in {wall_s:.1f} s; host batches "
          f"{', '.join(f'{s:.2f}' for s in res['host_s'])} s per chunk of {DOMAIN_CHUNK}; device "
          f"{', '.join(str(h['chunk_s']) for h in hist)} s per chunk = "
          f"{dev_s / DOMAIN_STEPS * 1e3:.1f} ms per step, {DOMAIN_STEPS / dev_s:.1f} steps/s, "
          f"{tokens / dev_s:,.0f} tokens/s; one step (profiler) device busy {busy_ms:.2f} ms of "
          f"{wall_ms:.2f} ms wall, idle {1 - busy_ms / wall_ms:.1%}; peak memory "
          f"{peak / 2**30:.2f} GiB ({(peak - held) / 2**30:.2f} GiB above what was held before); loss first chunk {hist[0]['loss']:.4f} (mean "
          f"{hist[0]['loss_mean']:.4f}), last chunk {hist[-1]['loss']:.4f} (mean "
          f"{hist[-1]['loss_mean']:.4f}); first-step loss card {first[0]:.6f}, CPU "
          f"{first[1]:.6f} (gap {gap:.2e}, limit {DOMAIN_LOSS_TOL:g}); params.npz keys, shapes "
          f"and f16 as committed; {CARD}", flush=True)

    # Served: the trained checkpoint behind the engine, over the main path's
    # filings, through get_engine.
    pool = generate_distractors(int(N_MAIN * 1.16), seed=SEED)
    chunks = [c for c in pool if c.company != "ICICI Bank"][:N_MAIN]
    reset_engine()
    t0 = time.perf_counter()
    engine = get_engine(settings=Settings(embed_backend="trained", trained_checkpoint=ckpt, index_dir=""),
                        chunks=chunks)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    index = engine.vector_index
    if (not isinstance(index.embedder, TrainedEmbedder) or index.embedder.checkpoint != ckpt
            or index.n != len(chunks) or not index.matrix_t.is_cuda):
        raise AssertionError(f"unexpected trained engine {index.stats()}")
    engine.warmup()
    _, unscoped = questions(chunks)
    asked = unscoped[:6]
    rag = engine.vector_rag
    rag.search(asked[0], top_k=3)
    torch.cuda.synchronize()
    # ---- the driven run: counters 0 just before, read just after ----------
    topk.cosine_topk_fused.launches = 0
    served = {q: rag.search(q, top_k=3) for q in asked}
    torch.cuda.synchronize()
    launches = topk.cosine_topk_fused.launches
    # -------------------------------------------------------------------------
    if launches < len(asked) or not all(served.values()):
        raise AssertionError(f"{len(asked)} requests on the trained checkpoint made {launches} launches")
    searcher = rag._searcher
    bad = [q for q in asked
           if not hits_agree([h.to_dict(False) for h in searcher.search_texts([q], top_k=3, method="dense")[0]],
                             served[q], BATCH_TOL)]
    if bad:
        raise AssertionError(f"trained-checkpoint hits differ from the dense tier for {bad}")
    print(f"train served: engine on the trained checkpoint over {len(chunks)} chunks built in "
          f"{build_s:.1f} s; {len(asked)} requests, fused launches {launches}, hits equal to the "
          f"dense tier", flush=True)
    reset_engine()
    return {"launches": launches, "step_ms": dev_s / DOMAIN_STEPS * 1e3, "tokens_per_s": tokens / dev_s,
            "peak_bytes": peak - held, "first_step_gap": gap, "step_busy_ms": busy_ms}


def train_phase(torch, topk, here: str, work_dir: str) -> dict:
    """Training on the card: (a) the bag encoder's fine-tune and (b) the
    domain encoder's warm start, each checked against the CPU."""
    from ragfin_tpu_torch.data.loader import build_corpus
    from ragfin_tpu_torch.eval.distractors import generate_distractors
    from ragfin_tpu_torch.eval.statements import write_extract_data
    from ragfin_tpu_torch.utils.device import resolve_device

    dev = resolve_device(None)
    gold, qs = train_questions(TRAIN_QUESTIONS, SEED + 5)
    icici = build_corpus(write_extract_data(os.path.join(work_dir, "train_data"), seed=44))
    chunks = generate_distractors(N_MAIN - len(gold), seed=SEED + 5) + gold + icici
    bag = bag_train_check(torch, topk, dev, chunks, qs)
    domain = domain_train_check(torch, topk, dev, here, work_dir)
    return {"launches": bag["launches"] + domain["launches"], "bag": bag, "domain": domain}


# --- phase 8: the services over HTTP -----------------------------------------


def http_json(method: str, port: int, path: str, body=None):
    """(status, parsed JSON body) of one request to a local service; talks to
    the socket directly (no proxy from the environment)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode() or "null")
    finally:
        conn.close()


def served_phase(torch, topk, graph_index, work_dir: str) -> dict:
    """The normal way in: a chunk snapshot on disk, the engine from Settings
    through get_engine, all seven services on ephemeral ports, requests over
    HTTP; then persist, reset, and a second engine from the saved index."""
    import numpy as np

    from ragfin_tpu_torch.config.settings import Settings, get_config
    from ragfin_tpu_torch.data.loader import save_chunk_snapshot
    from ragfin_tpu_torch.eval.distractors import generate_distractors
    from ragfin_tpu_torch.serving import main as serving_main
    from ragfin_tpu_torch.serving.engine import get_engine, reset_engine
    from ragfin_tpu_torch.serving.mcp_client import MCPClient

    chunks = generate_distractors(N_MAIN, seed=SEED + 1)
    snapshot = os.path.join(work_dir, "chunks.json")
    index_dir = os.path.join(work_dir, "index")
    t0 = time.perf_counter()
    save_chunk_snapshot(chunks, snapshot)
    settings = Settings(embed_backend="trained", chunks_snapshot=snapshot, index_dir=index_dir,
                        data_dir=os.path.join(work_dir, "no_extract_data"))
    reset_engine()
    engine = get_engine(settings=settings)
    torch.cuda.synchronize()
    start_s = time.perf_counter() - t0
    if engine.vector_index.n != N_MAIN or len(engine.chunks) != N_MAIN:
        raise AssertionError(f"served engine loaded {engine.vector_index.n} chunks")
    built = engine.graph_builder.build_from_vector_index(engine.vector_index)
    facts = engine.graph.stats()["total_facts"]
    if facts < graph_index.FIRST_K_MIN_ROWS:
        raise AssertionError(f"graph store has {facts} facts, below the first-k route")
    ports = {name: 0 for name in serving_main.ALL_SERVICES}
    get_config.cache_clear()
    servers = serving_main.launch(ports=ports, engine=engine)
    if set(servers) != set(serving_main.ALL_SERVICES):
        raise AssertionError(f"launched {sorted(servers)}")
    port = {name: srv.port for name, srv in servers.items()}
    print(f"served: snapshot of {N_MAIN} chunks written, engine started from Settings in "
          f"{start_s:.1f} s, graph of {facts} facts ({built.get('chunks_processed')} chunks), "
          f"7 services on ports {sorted(port.values())}", flush=True)

    def tool(service: str, name: str, arguments: dict):
        client = MCPClient(f"http://127.0.0.1:{port[service]}")
        return client.call_tool(name, arguments)

    def must(status_body, what: str):
        status, body = status_body
        if status != 200:
            raise AssertionError(f"{what}: HTTP {status} {str(body)[:200]}")
        return body

    def wire() -> dict:
        """Every request of the phase, over HTTP only; what came back, by name."""
        out = {}
        for name in ("entity_service", "graph_service", "vector_adapter", "graph_adapter"):
            out[f"health/{name}"] = must(http_json("GET", port[name], "/health"), f"/health {name}")
        for name in ("vector_mcp", "graph_mcp", "graph_mcp_monolith"):
            out[f"health/{name}"] = tool(name, "health_check", {})
        lat = []
        for q in WIRE_QUESTIONS:
            t = time.perf_counter()
            out[f"search/{q}"] = must(http_json("POST", port["vector_adapter"], "/search",
                                                {"query": q, "top_k": 3}), "/search")
            lat.append(time.perf_counter() - t)
            out[f"answer/{q}"] = must(http_json("POST", port["vector_adapter"], "/answer",
                                                {"question": q, "top_k": 3}), "/answer")
            out[f"search_vectors/{q}"] = tool("vector_mcp", "search_vectors", {"query": q, "top_k": 3})
            out[f"answer_question/{q}"] = tool("vector_mcp", "answer_question",
                                               {"question": q, "top_k": 3})
            out[f"hybrid_query/{q}"] = tool("graph_mcp_monolith", "hybrid_query", {"question": q})
        for q in WIRE_GRAPH_QUESTIONS:
            out[f"query_financial_graph/{q}"] = tool("graph_mcp", "query_financial_graph",
                                                     {"question": q, "limit": 10})
            out[f"api_query/{q}"] = must(http_json("POST", port["graph_service"], "/api/v1/query",
                                                   {"question": q, "limit": 10}), "/api/v1/query")
        out["compare_quarters"] = tool("graph_mcp_monolith", "compare_quarters",
                                       {"quarter1": "Q1_FY2024", "quarter2": "Q2_FY2024"})
        out["wire_p50_ms"] = statistics.median(lat) * 1e3
        return out

    def direct(eng, out: dict) -> None:
        """The same calls on the engine object, held against what came back
        over the wire."""
        t_in = []
        for q in WIRE_QUESTIONS:
            t = time.perf_counter()
            hits = eng.vector_rag.search(q, 3)
            t_in.append(time.perf_counter() - t)
            for got in (out[f"search/{q}"]["results"], out[f"search_vectors/{q}"]["results"]):
                if not hits_agree(hits, got, BATCH_TOL):
                    raise AssertionError(f"hits over the wire differ from the engine's for {q!r}")
            answered = asyncio.run(eng.vector_rag.search_and_answer(q, 3))
            for got in (out[f"answer/{q}"], out[f"answer_question/{q}"]):
                if got.get("answer") != answered.get("answer") or not got.get("answer"):
                    raise AssertionError(f"answer over the wire differs for {q!r}")
            hyb = asyncio.run(eng.hybrid.hybrid_query(q))
            if [c["id"] for c in out[f"hybrid_query/{q}"]["chunks"]] != [c["id"] for c in hyb["chunks"]]:
                raise AssertionError(f"hybrid chunks over the wire differ for {q!r}")
        for q in WIRE_GRAPH_QUESTIONS:
            rows = asyncio.run(eng.graph_builder.query_engine.query(q, 10))["results"]
            for key in (f"query_financial_graph/{q}", f"api_query/{q}"):
                if out[key]["results"] != json.loads(json.dumps(rows, default=str)) or not rows:
                    raise AssertionError(f"graph results over the wire differ for {q!r}")
        out["in_process_p50_ms"] = statistics.median(t_in) * 1e3

    # ---- the driven run: counters 0 just before the HTTP requests, read ----
    # ---- just after them and before any call on the engine object ---------
    topk.cosine_topk_fused.launches = 0
    graph_index.masked_first_k.launches = 0
    first = wire()
    torch.cuda.synchronize()
    launches = {"fused_topk": topk.cosine_topk_fused.launches,
                "first_k": graph_index.masked_first_k.launches}
    # -----------------------------------------------------------------------
    direct(engine, first)
    if min(launches.values()) < 1:
        raise AssertionError(f"the HTTP requests did not reach the kernels: {launches}")
    for name in ("vector_adapter", "vector_mcp", "graph_mcp_monolith"):
        h = first[f"health/{name}"]
        if h["status"] != "healthy" or h["vector_index"]["entities"] != N_MAIN or \
                "integrity_active" not in h:
            raise AssertionError(f"/health of {name}: {h}")
    cq = first["compare_quarters"]
    if not cq.get("success") or "metrics" not in cq or "segments" not in cq:
        raise AssertionError(f"compare_quarters: {str(cq)[:300]}")
    # A small build through the graph service (its own dataset id).
    body = must(http_json("POST", port["graph_service"], "/api/v1/build", {
        "chunks": [c.to_financial_chunk().model_dump() for c in chunks[:8]],
        "dataset_id": "wire_build"}), "/api/v1/build")
    if not body["success"] or body["chunks_processed"] != 8 or body["entities_created"] < 8:
        raise AssertionError(f"/api/v1/build: {body}")
    engine.graph.clear_data("wire_build")
    print(f"served: {len(first) - 2} responses over HTTP equal the engine's own; request p50 over "
          f"the wire (/search through adapter, MCP client and MCP server) "
          f"{first['wire_p50_ms']:.2f} ms, in process {first['in_process_p50_ms']:.2f} ms; "
          f"launches during the HTTP requests alone {launches}", flush=True)

    # ---- persist, reset, a second engine from index_dir alone -------------
    t0 = time.perf_counter()
    engine.persist()
    persist_s = time.perf_counter() - t0
    for srv in servers.values():
        srv.stop()
    reset_engine()
    os.remove(snapshot)
    t0 = time.perf_counter()
    again = get_engine(settings=settings)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if again is engine or again.chunks or again.vector_index.n != N_MAIN or \
            again.graph.stats()["total_facts"] != facts:
        raise AssertionError("the second engine did not come from the saved index")
    servers = serving_main.launch(ports=ports, engine=again)
    port = {name: srv.port for name, srv in servers.items()}
    try:
        second = wire()
        direct(again, second)
    finally:
        for srv in servers.values():
            srv.stop()
        reset_engine()
    for key, value in first.items():
        if key.startswith(("search/", "search_vectors/")):
            if not hits_agree(value["results"], second[key]["results"], F32_TOL):
                raise AssertionError(f"{key}: hits differ after persist and reload")
        elif key.startswith(("query_financial_graph/", "api_query/")):
            if value["results"] != second[key]["results"]:
                raise AssertionError(f"{key}: graph results differ after persist and reload")
    print(f"served: persisted in {persist_s:.1f} s, second engine loaded from index_dir in "
          f"{load_s:.1f} s (no chunks), same hits and graph results over HTTP", flush=True)
    return {"launches": launches, "wire_p50_ms": first["wire_p50_ms"],
            "in_process_p50_ms": first["in_process_p50_ms"]}


WIRE_QUESTIONS = [
    "What was the net profit?",
    "What were total customer deposits and advances?",
    "What was HDFC Bank's net profit in Q1 FY2024?",
    "What was the basic EPS growth?",
    "Which segment had the highest revenue?",
    "What were the provisions and cost ratio?",
]
WIRE_GRAPH_QUESTIONS = [
    "What was the net profit in Q1 FY2024?",
    "How did net profit trend across all quarters of FY2024?",
]


# --- phase 9: the command line ------------------------------------------------


def cli_phase(torch, work_dir: str, here: str) -> dict:
    """build-index, query --mode hybrid and chunk as subprocesses on a small
    generated extract_data tree; then ``bench`` through the CLI in this
    process (BENCH_N = 1,000,000, BENCH_Q = 64), so that the ceiling kernel's
    launches on the bench path are counted."""

    from ragfin_tpu_torch import cli
    from ragfin_tpu_torch.eval.statements import write_extract_data
    from ragfin_tpu_torch.ops import ceiling as C

    data = write_extract_data(os.path.join(work_dir, "extract_data"), seed=SEED)
    index_dir = os.path.join(work_dir, "cli_index")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("RAGFIN_", "BENCH_"))}

    def run(*argv) -> str:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ragfin_tpu_torch.cli", *argv], cwd=here,
                              env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"cli {argv[0]} exited {proc.returncode}: {proc.stderr[-800:]}")
        print(f"cli {argv[0]}: exit 0 in {time.perf_counter() - t0:.1f} s", flush=True)
        return proc.stdout

    out = run("chunk", "--data", data, "--out", os.path.join(work_dir, "cli_chunks.json"))
    with open(os.path.join(work_dir, "cli_chunks.json")) as f:
        if "wrote 16 chunks" not in out or len(json.load(f)) != 16:
            raise AssertionError(f"cli chunk: {out!r}")
    built = json.loads(run("build-index", "--data", data, "--out", index_dir).strip().splitlines()[-1])
    if built["chunks"] != 16 or built["num_entities"] != 16 or built["graph_facts"] < 16 or \
            not built["device"].startswith("cuda"):
        raise AssertionError(f"cli build-index: {built}")
    answer = json.loads(run("query", "What was the net profit in Q1 FY2024?", "--mode", "hybrid",
                            "--data", data, "--index", index_dir))
    if not answer.get("chunks") or "graph_results" not in answer:
        raise AssertionError(f"cli query --mode hybrid: {str(answer)[:300]}")
    print(f"cli: chunk, build-index ({built['graph_facts']} facts) and query --mode hybrid "
          f"({len(answer['chunks'])} chunks) ran on the card", flush=True)

    # ---- the bench path: counter 0 just before, read just after -----------
    saved = {k: os.environ.get(k) for k in ("BENCH_N", "BENCH_Q", "BENCH_DTYPE", "BENCH_REPS")}
    os.environ.update({"BENCH_Q": "64", "BENCH_DTYPE": "bf16", "BENCH_REPS": "8"})
    C.ceiling.launches = 0
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            try:
                code = cli.main(["bench", "--n", str(N_KERNEL)])
            except SystemExit as e:
                code = e.code
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)
    torch.cuda.synchronize()
    launches = C.ceiling.launches
    # -----------------------------------------------------------------------
    text = buf.getvalue()
    print(text, end="", flush=True)
    lines = [json.loads(line) for line in text.strip().splitlines()]
    if code not in (0, None) or len(lines) != 2:
        raise AssertionError(f"cli bench exited {code} with {len(lines)} lines")
    stages, result = lines
    if set(result) < {"metric", "value", "unit", "vs_baseline"} or not result["value"] > 0 or \
            "kernel" not in stages["ceiling_stages_ms"]:
        raise AssertionError(f"cli bench: {lines}")
    if launches < 1:
        raise AssertionError("the bench path never launched the ceiling kernel")
    return {"launches": launches, "bench": result, "stages": stages}


# --- phase 11: the drivers outside the package --------------------------------

CONC_CLIENTS = (8, 32)
CONC_SECONDS = 10.0
N_EVAL = 65_536  # + 16 real chunks: at FUSED_MIN_N, so the unscoped arms run row 1
ENTRY_COS = 0.999  # entry()'s bf16 forward on the card against the f32 forward on the CPU


def drivers_module(here: str, name: str):
    """A driver script of scripts/ as a module (they read their settings
    from the environment when main() runs)."""
    import importlib

    scripts = os.path.join(here, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return importlib.import_module(name)


def concurrent_phase(torch, topk, engine, chunks, here: str) -> dict:
    """(a) scripts/serving_concurrent_torch.py's stack and measuring loop on
    phase 3's engine: the vector MCP server and the vector adapter on
    ephemeral ports (the script's serve()); the script's warm pass, each hit
    held against the engine object's and against the dense tier's (plain
    torch on the card), 0 mismatches outside 1e-5 tie bands; then C clients
    for CONC_SECONDS each, the fused counters at 0 just before a level and
    read just after, and every response of the level held against the
    dense tier's (within BATCH_TOL: served questions are encoded in
    batches)."""
    sc = drivers_module(here, "serving_concurrent_torch")
    if engine.batcher is None:
        raise AssertionError("the engine runs without its batcher")
    scoped, unscoped = questions(chunks)
    qs = scoped + unscoped
    rag = engine.vector_rag
    wide = rag._detection_fetch(3)
    dense = {q: [h.to_dict(False) for h in rag._searcher.search_texts([q], top_k=wide, method="dense")[0][:3]]
             for q in qs}
    t0 = time.perf_counter()
    servers, url = sc.serve(engine)
    levels = []
    try:
        warm = sc.warm(url, qs)
        mismatched = [q for q, got in warm.items()
                      if not hits_agree(rag.search(q, 3), got, F32_TOL) or not hits_agree(dense[q], got, F32_TOL)]
        if mismatched:
            raise AssertionError(f"hits over HTTP differ from the engine's or the dense tier's for {mismatched}")
        print(f"concurrent: warm pass of {len(qs)} questions over HTTP (vector adapter, MCP "
              f"client, MCP server, batcher) in {time.perf_counter() - t0:.1f} s, every hit equal "
              f"to the engine object's and to the dense tier's", flush=True)
        for c in CONC_CLIENTS:
            record: list = []
            topk.cosine_topk_fused.launches = 0
            r = sc.level(url, qs, c, CONC_SECONDS, record)
            torch.cuda.synchronize()
            r["launches"] = topk.cosine_topk_fused.launches
            if r["errors"] or not r["done"]:
                raise AssertionError(f"C={c}: {r['errors']} of {r['done'] + r['errors']} requests "
                                     f"failed; first: {r['first_error']}")
            if r["launches"] < 1:
                raise AssertionError(f"C={c}: the load never launched the fused f32 kernel")
            bad = sorted({q for q, got in record if not hits_agree(dense[q], got, BATCH_TOL)})
            if len(record) != r["done"] or bad:
                raise AssertionError(f"C={c}: {len(record)} responses recorded for {r['done']} "
                                     f"requests; hits differ from the dense tier's for {bad}")
            print(sc.line(N_MAIN, r, " backend=trained dtype=float32", CARD)
                  + f"; fused launches {r['launches']} for {r['done']} requests, every response "
                  f"equal to the dense tier's", flush=True)
            levels.append(r)
    finally:
        for srv in servers.values():
            srv.stop()
    return {"levels": levels, "launches": sum(r["launches"] for r in levels),
            "seconds": time.perf_counter() - t0}


def arm_against(label, searcher, questions, k, reported, reference) -> int:
    """An eval arm's searches again, in the harness's batches of 64, through
    the arm's own route and through ``reference(searcher, batch, k)`` on the
    same index: hits equal outside 1e-5 tie bands, and the route's hits
    score to the summary the script reported. Returns how many questions'
    ids differ inside a tie band."""
    from ragfin_tpu_torch.eval.harness import evaluate_retrieval

    texts = [q.question for q in questions]
    routed, bad, ties = {}, [], 0
    for s in range(0, len(texts), 64):
        batch = texts[s : s + 64]
        for q, a, b in zip(batch, searcher.search_texts(batch, top_k=k), reference(searcher, batch, k)):
            got, ref = [h.to_dict(False) for h in a], [h.to_dict(False) for h in b]
            if not hits_agree(ref, got, F32_TOL):
                bad.append(q)
            ties += [h["id"] for h in got] != [h["id"] for h in ref]
            routed[q] = a
    if bad:
        raise AssertionError(f"{label}: hits differ from the reference's for {bad}")

    class Replay:
        def search_texts(self, queries, top_k, method="auto"):
            return [routed[q] for q in queries]

    timing = ("wall_s", "mean_latency_ms")
    got = {key: v for key, v in evaluate_retrieval(Replay(), questions, k).summary().items()
           if key not in timing}
    want = {key: v for key, v in reported.items() if key not in timing}
    if got != want:
        raise AssertionError(f"{label}: the script reported {want}; its hits give {got}")
    return ties


def eval_phase(torch, topk, ivf, here: str, work_dir: str) -> dict:
    """(b) scripts/trained_eval_torch.py (ARMS=pipeline,raw,ivf: its
    counterparts of the base and IVF groups) and
    scripts/distractor_eval_torch.py (ARMS=base,ivf) at DISTRACTOR_N =
    N_EVAL, then the trained eval's pipeline and raw arms again at
    TRAINED_DTYPE=int8, in this process, each dtype writing into its own
    directory; rows 1-3's counters at 0 just before and read just after.
    Every labelled arm is held, question by question, against the same
    searches on the same index with the dense tier (f32) or the int8
    kernel's plain version (int8) in the kernel's place, and its reported
    summary against its hits; the trained IVF at full probe against the
    host-exact oracle."""
    from ragfin_tpu_torch.eval.datasets import load_holdout_phrasings
    from ragfin_tpu_torch.retrieval.queryfilter import FilteredSearch

    te = drivers_module(here, "trained_eval_torch")
    de = drivers_module(here, "distractor_eval_torch")
    keys = ("DISTRACTOR_N", "EVAL_OUT", "ARMS", "TRAINED_DTYPE", "REFERENCE_ROOT", "RAGFIN_DEVICE",
            "SLAB", "ENCODE_ONLY")
    saved = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ["DISTRACTOR_N"] = str(N_EVAL)
    counted = (topk.cosine_topk_fused, topk.cosine_topk_fused_int8, ivf.pruned_topk)
    for w in counted:
        w.launches = 0

    def dense(searcher, batch, k):
        return searcher.search_texts(batch, top_k=k, method="dense")

    def plain_int8(searcher, batch, k):
        with index_int8_plain(topk):
            return searcher.search_texts(batch, top_k=k)

    runs = (  # label, script, environment, the arms' reference
        ("trained f32", te, {"ARMS": "pipeline,raw,ivf", "TRAINED_DTYPE": "f32", "EVAL_OUT": "f32"}, dense),
        ("distractor", de, {"ARMS": "base,ivf", "EVAL_OUT": "f32"}, dense),
        ("trained int8", te, {"ARMS": "pipeline,raw", "TRAINED_DTYPE": "int8", "EVAL_OUT": "int8"},
         plain_int8),
    )
    hp = load_holdout_phrasings()
    reports, ties = {}, {}
    try:
        for label, script, env, reference in runs:
            os.environ.update({**env, "EVAL_OUT": os.path.join(work_dir, "eval", env["EVAL_OUT"])})
            kept: dict = {}
            rep = reports[label] = script.main(kept)
            idx = kept["index"]
            if rep.get("n_chunks") != N_EVAL + 16 or not rep["device"].startswith("cuda"):
                raise AssertionError(f"{label}: {rep.get('n_chunks')} chunks on {rep.get('device')}")
            arms = {name: r for name, r in rep["results"].items() if "retrieval_recall" in r}
            if not arms:
                raise AssertionError(f"{label}: no arm ran")
            with uncounted(*counted):
                for name, r in arms.items():
                    if not name.startswith("holdout_phrasings_"):
                        raise AssertionError(f"{label}: arm {name} has no questions here")
                    searcher = idx if "_raw" in name else FilteredSearch(idx)
                    ties[f"{label} {name}"] = arm_against(f"{label} {name}", searcher, hp, r["k"], r,
                                                          reference)
            print(f"eval {label} (N = {N_EVAL} + 16, {rep['questions']}): " + "; ".join(
                f"{name} recall@{r['k']} {r['retrieval_recall']['mean']:.4f}" for name, r in arms.items())
                + f"; every arm's hits equal to the {'plain int8' if reference is plain_int8 else 'dense'} "
                f"route's (questions differing inside a tie band: "
                f"{sum(n for a, n in ties.items() if a.startswith(label))})", flush=True)
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)
    torch.cuda.synchronize()
    launches = {"fused_topk": topk.cosine_topk_fused.launches,
                "fused_topk_int8": topk.cosine_topk_fused_int8.launches,
                "ivf_topk": ivf.pruned_topk.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"the evals did not reach every kernel: {launches}")
    f32, i8 = reports["trained f32"]["results"], reports["trained int8"]["results"]
    same = {name: f32[name]["retrieval_recall"] == r["retrieval_recall"]
            for name, r in i8.items() if "retrieval_recall" in r}
    print(f"eval trained int8 against f32: recall equal per arm {same}", flush=True)
    trained_ivf = f32.get("ivf_vs_exact_overlap@10_trained")
    hashed_ivf = reports["distractor"]["results"].get("ivf_vs_exact_overlap@10")
    if not trained_ivf or not hashed_ivf:
        raise AssertionError("an IVF agreement arm did not finish")
    full = trained_ivf["agreement_by_nprobe"][trained_ivf["n_cells"]]
    if full["tie_aware"] != 1.0:
        raise AssertionError(f"IVF at full probe disagrees with the host-exact oracle: {full}")
    print(f"eval IVF agreement@10 by nprobe ({trained_ivf['n_cells']} cells): trained f32 "
          f"{json.dumps(trained_ivf['agreement_by_nprobe'])}; hashed (against the dense tier) "
          f"{json.dumps(hashed_ivf['agreement_by_nprobe'])}; launches {launches}", flush=True)
    return {"launches": launches, "reports": reports, "ties": ties}


def demo_phase(here: str) -> float:
    """(c) examples/demo_torch.py as a user runs it; it must exit 0."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("RAGFIN_")}
    env.pop("REFERENCE_ROOT", None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(here, "examples", "demo_torch.py")],
                          cwd=here, env=env, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0 or "recall@10 = " not in proc.stdout:
        raise AssertionError(f"demo exited {proc.returncode}: {proc.stderr[-800:]}")
    recall = proc.stdout.split("recall@10 = ")[1].split()[0]
    print(f"demo: examples/demo_torch.py exit 0 in {time.perf_counter() - t0:.1f} s "
          f"(six steps, recall@10 {recall} on the holdout phrasings)", flush=True)
    return float(recall)


def entry_phase(torch) -> float:
    """(d) parallel/dryrun.py:entry()'s forward on the card (bf16) against
    the same forward in f32 on the CPU from the same init_params."""
    from ragfin_tpu_torch.models.minilm import MiniLMConfig
    from ragfin_tpu_torch.parallel.dryrun import entry

    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    fn32, args32 = entry(config=MiniLMConfig(dtype=torch.float32), device="cpu")
    ref = fn32(*args32)
    if not args[1].is_cuda or tuple(out.shape) != (8, 384) or not torch.isfinite(out).all():
        raise AssertionError(f"entry forward: {tuple(out.shape)} on {out.device}")
    if any(not torch.equal(args[0][k].cpu(), args32[0][k]) for k in args32[0]):
        raise AssertionError("entry's parameters differ between the card and the CPU")
    cos = torch.nn.functional.cosine_similarity(out.float().cpu(), ref, dim=1)
    if float(cos.min()) < ENTRY_COS:
        raise AssertionError(f"entry forward: cosine {cos.tolist()} below {ENTRY_COS}")
    print(f"entry: MiniLMConfig() forward on 8 x 32 ids on the card, bf16 against f32 on the "
          f"CPU: min cosine {float(cos.min()):.6f} (limit {ENTRY_COS})", flush=True)
    return float(cos.min())


def drivers_phase(torch, topk, ivf, here: str, work_dir: str, concurrent=None) -> dict:
    """Phase 11. (a) ran inside phase 3 when ``concurrent`` is given; alone
    (--drivers) it builds phase 3's engine here."""
    t0 = time.perf_counter()
    alone = concurrent is None
    if alone:
        chunks = main_chunks()
        engine = main_engine(chunks)
        torch.cuda.synchronize()
        print(f"drivers: phase 3's engine over {len(chunks)} chunks up in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        try:
            concurrent = concurrent_phase(torch, topk, engine, chunks, here)
        finally:
            engine.close()
    evals = eval_phase(torch, topk, ivf, here, work_dir)
    demo = demo_phase(here)
    cos = entry_phase(torch)
    took = time.perf_counter() - t0 + (0.0 if alone else concurrent["seconds"])
    print(f"drivers: phase 11 took {took:.1f} s, with (a)'s {concurrent['seconds']:.1f} s "
          f"{'here' if alone else 'inside phase 3'}", flush=True)
    return {"concurrent": concurrent, "evals": evals, "demo_recall": demo, "entry_cos": cos,
            "seconds": took}


# --- phase 10: the parallel layer ----------------------------------------------

N_SCALE = 4_000_037  # not a multiple of any tile
PAR_K = 64
# tests/test_sharded_graph.py's MATCH_CASES (types 0 = METRIC, 2 = RATIO) and company scopes.
PAR_MATCH_CASES = [
    dict(names=["Net Profit"], limit=10),
    dict(quarters=["Q1_FY2024"], limit=30),
    dict(quarters=["Q2_FY2023", "Q3_FY2023"], types=[0], limit=16),
    dict(types=[2], limit=50),
    dict(names=["Metric 7", "Metric 12"], quarters=["Q4_FY2022"], limit=30),
    dict(limit=25),
    dict(names=["No Such Entity"], limit=10),
    dict(names=["Rare B"], companies=["Rare Bank"], limit=30),
    dict(names=["Metric 3"], companies=["ICICI Bank"], limit=20),
]
PAR_COS = 0.999  # bf16 pp / sp forward against the single-device forward, per row


@contextlib.contextmanager
def uncounted(*wrappers):
    """Launches made inside (references, timings, direct kernel checks) do
    not count towards the parallel path's launches."""
    saved = [w.launches for w in wrappers]
    try:
        yield
    finally:
        for w, n in zip(wrappers, saved):
            w.launches = n


@contextlib.contextmanager
def int8_plain(topk):
    """The sharded programs call fused_topk_int8_plain where they would
    launch the int8 kernel: the kernel's reference on the same inputs."""
    kernel = topk.cosine_topk_fused_int8
    topk.cosine_topk_fused_int8 = lambda q, c, s, k, n_valid=None: topk.fused_topk_int8_plain(q, c, s, k, n_valid)
    try:
        yield
    finally:
        topk.cosine_topk_fused_int8 = kernel


@contextlib.contextmanager
def index_int8_plain(topk):
    """The index module calls fused_topk_int8_plain where it would launch
    the int8 kernel."""
    from ragfin_tpu_torch.index import vector_index

    kernel = vector_index.cosine_topk_fused_int8
    vector_index.cosine_topk_fused_int8 = (
        lambda q, c, s, k, n_valid=None: topk.fused_topk_int8_plain(q, c, s, k, n_valid))
    try:
        yield
    finally:
        vector_index.cosine_topk_fused_int8 = kernel


def par_mesh(dev, p: int, axis: str = "data"):
    from ragfin_tpu_torch.parallel.mesh import make_mesh

    return make_mesh((axis,), devices=[dev] * p)


def hit_rows(hits) -> list[list[tuple[str, float]]]:
    return [[(h.id, h.score) for h in hs] for hs in hits]


def par_index(torch, topk, index, idx8, qs) -> None:
    """(a) ShardedVectorIndex.from_dense over the main path's indexes."""
    from ragfin_tpu_torch.parallel.sharded import ShardedVectorIndex

    with uncounted(topk.cosine_topk_fused):
        flat = [[h.to_dict(False) for h in hs] for hs in index.search_texts(qs, top_k=10)]
    for p in (1, 2):
        mesh = par_mesh(index.matrix_t.device, p)
        sh = ShardedVectorIndex.from_dense(index, mesh=mesh)
        got = sh.search_texts(qs, top_k=10)
        bad = [q for q, a, b in zip(qs, flat, got) if not hits_agree(a, [h.to_dict(False) for h in b], F32_TOL)]
        if bad:
            raise AssertionError(f"sharded f32 index P={p} differs from the flat index for {bad}")
        sh8 = ShardedVectorIndex.from_dense(idx8, mesh=mesh, dtype="int8")
        got8 = hit_rows(sh8.search_texts(qs, top_k=10))
        with int8_plain(topk):
            want8 = hit_rows(sh8.search_texts(qs, top_k=10))
        if got8 != want8:
            raise AssertionError(f"sharded int8 index P={p}: not bitwise equal to the plain version")
        print(f"parallel (a) engine index P={p} ({sh.matrix_t[0].shape[1]} columns a shard): "
              f"{len(qs)} questions, f32 hits equal to the flat index (1e-5), int8 hits bitwise "
              f"equal to the plain version", flush=True)


def par_scale(torch, topk, dev) -> dict:
    """(b) 4,000,037 seeded unit vectors, f32 and int8, 1 and 4 shards,
    Q in {1, 64}; the negative-similarity corpus with 98 % padding over 8
    shards; the kernels at limit 0."""
    import numpy as np

    from ragfin_tpu_torch.ops.quantize import quantize_corpus_t
    from ragfin_tpu_torch.parallel.mesh import shard
    from ragfin_tpu_torch.parallel.sharded import sharded_cosine_topk

    n, k = N_SCALE, PAR_K
    n_pad = -(-n // 512) * 512  # 128 columns a shard unit, 4 shards
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    ct = torch.zeros((D, n_pad), device=dev)
    for c0 in range(0, n, 1 << 20):
        x = torch.randn((min(n, c0 + (1 << 20)) - c0, D), generator=gen, device=dev)
        ct[:, c0 : c0 + x.shape[0]] = (x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).T
    q = torch.randn((64, D), generator=gen, device=dev)
    q = (q / torch.linalg.vector_norm(q, dim=1, keepdim=True)).contiguous()
    c8, sc = quantize_corpus_t(ct)
    parts = {p: tuple(shard(par_mesh(dev, p), "data", t, 1) for t in (ct, c8, sc)) for p in (1, 4)}
    got, err = {}, 0.0
    for p, (cp, c8p, scp) in parts.items():
        mesh = par_mesh(dev, p)
        for q_n in (1, 64):
            qq = q[:q_n]
            s, i = sharded_cosine_topk(mesh, "data", qq, cp, k, n_valid=n)
            s8, i8 = sharded_cosine_topk(mesh, "data", qq, c8p, k, n_valid=n, scales=scp)
            got[(p, q_n)] = (s, i, s8, i8)
            with int8_plain(topk):
                w8 = sharded_cosine_topk(mesh, "data", qq, c8p, k, n_valid=n, scales=scp)
            if not (torch.equal(s8, w8[0]) and torch.equal(i8, w8[1])):
                raise AssertionError(f"sharded int8 P={p} Q={q_n}: not bitwise equal to the plain version")
            ref_s, ref_i = f64_oracle(torch, qq, ct, k + 1, n)
            s_np, i_np = s.cpu().numpy(), i.cpu().numpy()
            e = float(np.max(np.abs(s_np - ref_s[:, :k])))
            err = max(err, e)
            if e > F32_TOL or not ids_agree(ref_s, ref_i, i_np, F32_TOL):
                raise AssertionError(f"sharded f32 P={p} Q={q_n}: err {e}, or ids differ from the f64 oracle")
    # Negative similarities, ~98 % padding over 8 shards: shards 1-7 hold
    # pads only, so their local limit is 0.
    rng = np.random.default_rng(SEED + 11)
    base = rng.standard_normal(D).astype(np.float32)
    base /= np.linalg.norm(base)
    neg = rng.standard_normal((100, D)).astype(np.float32)
    neg /= np.linalg.norm(neg, axis=1, keepdims=True)
    neg -= 2 * np.maximum(neg @ base, 0)[:, None] * base
    neg /= np.linalg.norm(neg, axis=1, keepdims=True)
    ct_neg = torch.nn.functional.pad(torch.from_numpy(neg.T.copy()), (0, 1024 - 100)).to(dev)
    mesh8 = par_mesh(dev, 8)
    qn = torch.from_numpy(base[None]).to(dev)
    s, i = sharded_cosine_topk(mesh8, "data", qn, shard(mesh8, "data", ct_neg, 1), 5, n_valid=100,
                               method="fused")
    oracle = np.argsort(-(neg @ base), kind="stable")[:5]
    if i.cpu().numpy()[0].tolist() != oracle.tolist() or float(s.max()) >= 0:
        raise AssertionError(f"98 % padding: {i.cpu().numpy()[0]} != oracle {oracle}")
    # The kernels on a pure-pad shard (limit 0) return empty lists.
    with uncounted(topk.cosine_topk_fused, topk.cosine_topk_fused_int8):
        c8n, scn = quantize_corpus_t(ct_neg)
        for s0, i0 in (topk.cosine_topk_fused(qn, ct_neg[:, 128:256].contiguous(), 5, n_valid=0),
                       topk.cosine_topk_fused_int8(qn, c8n[:, 128:256].contiguous(),
                                                   scn[:, 128:256].contiguous(), 5, n_valid=0)):
            if not (torch.isinf(s0).all() and (i0 == topk.INT32_MAX).all()):
                raise AssertionError(f"a kernel at limit 0 returned {s0}, {i0}")
    print(f"parallel (b) scale: N={n} D={D} k={k}, f32 ids equal to the f64 oracle outside "
          f"{F32_TOL} tie bands (max err {err:.2e}), int8 bitwise equal to the plain version, "
          f"P = 1 and 4, Q = 1 and 64; 98 % padding over 8 shards equal to the oracle; "
          f"both kernels return empty lists at limit 0", flush=True)
    return {"ct": ct, "c8": c8, "sc": sc, "q": q, "parts": parts, "got": got, "n": n, "err": err}


def par_scale_times(torch, topk, dev, scale) -> dict:
    """The sharded calls of (b) beside the direct fused call (CUDA events,
    median of 20): the difference is the sharded wrapper's cost."""
    from ragfin_tpu_torch.parallel.sharded import sharded_cosine_topk

    n, k, out = scale["n"], PAR_K, {}
    with uncounted(topk.cosine_topk_fused, topk.cosine_topk_fused_int8):
        for label in ("f32", "int8"):
            for q_n in (1, 64):
                qq = scale["q"][:q_n]
                if label == "f32":
                    direct = lambda: topk.cosine_topk_fused(qq, scale["ct"], k, n_valid=n)
                else:
                    direct = lambda: topk.cosine_topk_fused_int8(qq, scale["c8"], scale["sc"], k, n_valid=n)
                row = {"direct": time_ms(torch, direct)}
                for p, (cp, c8p, scp) in scale["parts"].items():
                    mesh = par_mesh(dev, p)
                    if label == "f32":
                        fn = lambda: sharded_cosine_topk(mesh, "data", qq, cp, k, n_valid=n)
                    else:
                        fn = lambda: sharded_cosine_topk(mesh, "data", qq, c8p, k, n_valid=n, scales=scp)
                    row[p] = time_ms(torch, fn)
                out[(label, q_n)] = row
                print(f"parallel scale {label} Q={q_n} N={n} k={k}: direct fused {row['direct']:.4f} ms; "
                      f"sharded P=1 {row[1]:.4f} ms (+{row[1] - row['direct']:.4f}), P=4 {row[4]:.4f} ms "
                      f"(+{row[4] - row['direct']:.4f}) [{CARD}]", flush=True)
    return out


def match_count(graph, kw) -> int:
    """Hits of one match on the packed host columns (numpy)."""
    import numpy as np

    host = graph._pack()["host"]
    sel = np.ones(host["quarter_ids"].shape[0], bool)
    for key, col, ids in (("quarters", "quarter_ids", graph._quarter_id),
                          ("names", "entity_ids", graph._entity_id),
                          ("companies", "company_ids", graph._company_id_of)):
        if kw.get(key):
            sel &= np.isin(host[col], [ids[x] for x in kw[key] if x in ids])
    if kw.get("types"):
        sel &= np.isin(host["type_ids"], kw["types"])
    return int(sel.sum())


def par_graph(torch, graph_index, graph) -> None:
    """(c) the 10M-fact store row-sharded over 1 and 4 shards."""
    from ragfin_tpu_torch.parallel.sharded_graph import ShardedGraphIndex

    with uncounted(graph_index.masked_first_k):
        want = [graph.match(**kw) for kw in PAR_MATCH_CASES]
    counts = [match_count(graph, kw) for kw in PAR_MATCH_CASES]
    dev = graph._pack()["quarter_ids"].device
    for p in (1, 4):
        before = graph_index.masked_first_k.launches
        view = ShardedGraphIndex(graph, mesh=par_mesh(dev, p), axis="data")
        for kw, w, c in zip(PAR_MATCH_CASES, want, counts):
            got = view.match(**kw)
            _, _, count = view.match_rows(**kw)
            if got != w or int(count) != c:
                raise AssertionError(f"sharded graph P={p} {kw}: {len(got)} rows, count {int(count)} "
                                     f"against {len(w)} rows, {c}")
        made = graph_index.masked_first_k.launches - before
        if made != 2 * p * len(PAR_MATCH_CASES):
            raise AssertionError(f"sharded graph P={p}: {made} first-k launches, "
                                 f"{2 * p * len(PAR_MATCH_CASES)} expected")
        print(f"parallel (c) graph: {view.n_rows} facts over {p} shards ({view.shard_rows} rows a shard): "
              f"{len(PAR_MATCH_CASES)} matches (rows and counts) equal to GraphIndex.match, "
              f"{made} first-k launches", flush=True)


def dequantized_oracle(torch, q, index, k):
    """f64 top-k over an int8 IVF index's dequantized cells, original ids."""
    cells = (index.cells.double() * index.scales.double()).permute(1, 0, 2).reshape(D, -1)
    scores = q.double() @ cells
    scores[:, index.orig_ids == 0x7FFFFFFF] = float("-inf")
    s, pos = torch.topk(scores, k + 1, dim=1)
    return s.float().cpu().numpy(), index.orig_ids[pos].cpu().numpy()


def par_ivf(torch, topk, ivf, ct32, q, idx32, idx8) -> dict:
    """(d) phase 6's IVF over 4 shards (cells padded to a multiple of 4)."""
    import numpy as np

    from ragfin_tpu_torch.parallel.sharded_ivf import shard_ivf_arrays, sharded_ivf_topk

    dev, k = q.device, IVF_K
    mesh = par_mesh(dev, 4)
    with uncounted(topk.cosine_topk_fused, ivf.pruned_topk):
        es, ei = (t.cpu().numpy() for t in topk.cosine_topk_fused(q, ct32, k + 1))
        single10 = ivf.ivf_topk(q, idx32, 10, nprobe=IVF_NPROBE, block_q=IVF_BLOCK_Q,
                                precision="exact")[1].cpu().numpy()
    e8s, e8i = dequantized_oracle(torch, q, idx8, k)
    out = {}
    for label, index, ref_s, ref_i in (("f32", idx32, es, ei), ("int8", idx8, e8s, e8i)):
        arrays = shard_ivf_arrays(mesh, "data", index)

        def run(nprobe, kk=k, arrays=arrays):
            return sharded_ivf_topk(mesh, "data", q, *arrays[:4], kk, nprobe=nprobe,
                                    block_q=IVF_BLOCK_Q, n_cells_real=arrays[4])

        s, i = (t.cpu().numpy() for t in run(index.n_cells))
        e = float(np.max(np.abs(s - ref_s[:, :k])))
        if e > F32_TOL or not ids_agree(ref_s, ref_i, i, F32_TOL):
            raise AssertionError(f"sharded IVF {label} at full probe: err {e}, or ids differ from the exact tier")
        pruned = run(IVF_NPROBE, 10)[1].cpu().numpy()
        recall = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(pruned, ref_i[:, :10])]))
        out[label] = {"cells": arrays[0][0].shape[0] * 4, "recall": recall, "run": run}
    recall1 = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(single10, ei[:, :10])]))
    print(f"parallel (d) IVF: {idx32.n_cells} cells padded to {out['f32']['cells']} over 4 shards, Q=64, "
          f"block_q {IVF_BLOCK_Q}, k {k}: at full probe f32 equal to the exact fused tier and int8 to "
          f"its dequantized cells (1e-5); recall@10 at nprobe {IVF_NPROBE}: f32 {out['f32']['recall']:.3f}, "
          f"int8 {out['int8']['recall']:.3f}, single-device pruned kernel {recall1:.3f}", flush=True)
    out["recall_single"] = recall1
    return out


def par_ivf_times(torch, ivf, q, idx32, sharded) -> None:
    with uncounted(ivf.pruned_topk):
        kernel_ms = time_ms(torch, lambda: ivf.ivf_topk(q, idx32, IVF_K, nprobe=IVF_NPROBE,
                                                        block_q=IVF_BLOCK_Q, precision="exact"))
        sh_ms = time_ms(torch, lambda: sharded["f32"]["run"](IVF_NPROBE), runs=5, warmup=1)
    print(f"parallel IVF times, Q=64 nprobe {IVF_NPROBE} k {IVF_K} f32: sharded (4 shards, torch ops) "
          f"{sh_ms:.4f} ms, single-device pruned kernel (ivf_topk) {kernel_ms:.4f} ms [{CARD}]", flush=True)


def par_free_source(torch, ivf, ct32) -> None:
    """(e) build_ivf on the same 1M corpus with free_source off and on."""
    dev = ct32.device
    built, peaks = [], []
    for free in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        built.append(ivf.build_ivf(ct32, cell=IVF_CELL, seed=SEED, free_source=free))
        torch.cuda.synchronize()
        peaks.append((torch.cuda.max_memory_allocated(dev) - base, time.perf_counter() - t0))
    a, b = built
    if not (torch.equal(a.cells, b.cells) and torch.equal(a.orig_ids, b.orig_ids)
            and torch.equal(a.centroids, b.centroids)):
        raise AssertionError("build_ivf(free_source=True) built another index")
    source = ct32.numel() * ct32.element_size()
    if peaks[0][0] - peaks[1][0] < source:
        raise AssertionError(f"free_source lowered the build's peak by {peaks[0][0] - peaks[1][0]} bytes, "
                             f"less than the source's {source}")
    print(f"parallel (e) build_ivf N={ct32.shape[1]} cell {IVF_CELL}: peak above the caller's "
          f"{peaks[0][0] / 2**30:.3f} GiB off ({peaks[0][1]:.1f} s), {peaks[1][0] / 2**30:.3f} GiB with "
          f"free_source ({peaks[1][1]:.1f} s); the source is {source / 2**30:.3f} GiB; cells, ids and "
          f"centroids equal [{CARD}]", flush=True)


def par_encoder(torch, here, dev, chunks) -> None:
    """(f) the committed domain encoder pipelined (pp = 2, M = 4) and
    sequence-parallel (sp = 4); one pp train step; the residual MLP."""
    import dataclasses

    import numpy as np

    from ragfin_tpu_torch.models.domain_encoder import load_encoder_checkpoint
    from ragfin_tpu_torch.models.minilm import MiniLMEncoder, params_from_flax
    from ragfin_tpu_torch.parallel import pipeline as ppl
    from ragfin_tpu_torch.parallel.minilm_pipeline import make_minilm_pp_forward, make_minilm_pp_train_step
    from ragfin_tpu_torch.parallel.minilm_sp import make_minilm_sp_forward

    flax_params, tok, cfg, _ = load_encoder_checkpoint(os.path.join(here, "checkpoints", "domain_encoder"))
    sd = {k_: v.to(dev) for k_, v in params_from_flax(flax_params).items()}
    ids, mask = tok.encode_batch([c.text for c in chunks[:64]], pad_multiple=cfg.max_position)
    if ids.shape != (64, 192):
        raise AssertionError(f"encoder batch {ids.shape}, wanted 64 chunks of 192 tokens")
    ids = torch.from_numpy(ids.astype(np.int64)).to(dev)
    mask = torch.from_numpy(mask).to(dev)
    pp_mesh, sp_mesh = par_mesh(dev, 2, "pp"), par_mesh(dev, 4, "sp")
    line = []
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        c = dataclasses.replace(cfg, dtype=dtype)
        model = MiniLMEncoder(c).to(dev).eval()
        model.load_state_dict(sd)
        pp = make_minilm_pp_forward(pp_mesh, c)
        sp = make_minilm_sp_forward(sp_mesh, c)
        with torch.no_grad():
            ref = model(ids, mask)
            out_pp = pp(sd, ids.reshape(4, 16, -1), mask.reshape(4, 16, -1)).reshape(64, -1)
            out_sp = sp(sd, ids, mask)
            for label, out in (("pp", out_pp), ("sp", out_sp)):
                if name == "bf16":
                    worst = float((out * ref).sum(dim=1).min())
                    ok = worst >= PAR_COS
                else:
                    worst = float((out - ref).abs().max())
                    ok = worst <= F32_TOL
                if not ok:
                    raise AssertionError(f"{label} encoder {name}: {worst} against the single-device forward")
                line.append(f"{label} {name} {'min cosine' if name == 'bf16' else 'max err'} {worst:.6g}")
            times = {label: time_ms(torch, fn, runs=5, warmup=1) for label, fn in (
                ("single", lambda: model(ids, mask)),
                ("pp", lambda: pp(sd, ids.reshape(4, 16, -1), mask.reshape(4, 16, -1))),
                ("sp", lambda: sp(sd, ids, mask)))}
        line.append(f"{name} ms single {times['single']:.3f}, pp {times['pp']:.3f}, sp {times['sp']:.3f}")
    # One pp train step at f32 against a single-device replay of its loss.
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    model = MiniLMEncoder(c32).to(dev).eval()
    model.load_state_dict(sd)
    targets = torch.randn((4, 16, cfg.hidden_size), generator=torch.Generator(device=dev).manual_seed(SEED),
                          device=dev)
    new, loss = make_minilm_pp_train_step(pp_mesh, c32)(sd, ids.reshape(4, 16, -1), mask.reshape(4, 16, -1),
                                                        targets)
    with torch.no_grad():
        replay = torch.mean((model(ids, mask).reshape(4, 16, -1) - targets) ** 2)
    moved = [bool((new[f"layers.{i}.intermediate.weight"] != sd[f"layers.{i}.intermediate.weight"]).any())
             for i in range(cfg.num_layers)]
    if abs(float(loss) - float(replay)) > F32_TOL or not all(moved):
        raise AssertionError(f"pp train step: loss {float(loss)} against {float(replay)}, layers moved {moved}")
    # The residual-MLP pipeline at d = 384.
    params = ppl.init_pipeline_params(torch.Generator().manual_seed(SEED), 8, D).to(dev)
    x = torch.randn((8, 64, D), generator=torch.Generator(device=dev).manual_seed(SEED + 1), device=dev)
    ref = torch.stack([ppl.sequential_forward(params, mb) for mb in x])
    mlp_err = max(float((ppl.make_pipeline_forward(par_mesh(dev, p, "pp"))(params, x) - ref).abs().max())
                  for p in (2, 4))
    if mlp_err > F32_TOL:
        raise AssertionError(f"residual-MLP pipeline differs from sequential_forward by {mlp_err}")
    print(f"parallel (f) domain encoder ({cfg.num_layers} layers, hidden {cfg.hidden_size}) on 64 chunks x "
          f"192 tokens, pp = 2 (M = 4), sp = 4: {'; '.join(line)}; pp train step loss {float(loss):.6f} "
          f"(replay {float(replay):.6f}), all {cfg.num_layers} layers updated; residual MLP L=8 d={D} M=8 "
          f"B=64 pp 2 and 4 within {mlp_err:.1e} of sequential [{CARD}]", flush=True)


def par_process_group(torch, topk, dev, scale) -> int:
    """(g) case (b) again through a one-rank NCCL process group."""
    import socket

    import torch.distributed as dist

    from ragfin_tpu_torch.parallel.sharded import sharded_cosine_topk

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        before = topk.cosine_topk_fused.launches + topk.cosine_topk_fused_int8.launches
        for p, (cp, c8p, scp) in scale["parts"].items():
            mesh = par_mesh(dev, p)
            for q_n in (1, 64):
                qq = scale["q"][:q_n]
                s, i = sharded_cosine_topk(mesh, "data", qq, cp, PAR_K, n_valid=scale["n"])
                s8, i8 = sharded_cosine_topk(mesh, "data", qq, c8p, PAR_K, n_valid=scale["n"], scales=scp)
                if not all(torch.equal(a, b) for a, b in zip((s, i, s8, i8), scale["got"][(p, q_n)])):
                    raise AssertionError(f"process-group search P={p} Q={q_n} differs from the in-process one")
        made = topk.cosine_topk_fused.launches + topk.cosine_topk_fused_int8.launches - before
    finally:
        dist.destroy_process_group()
    print(f"parallel (g) process group (nccl, world size 1): case (b) equal to the in-process results, "
          f"{made} kernel launches", flush=True)
    return made


DP_TP_CHECKS = ((2, 2), (1, 4))  # f32 against the single-device step
DP_TP_TIMED = ((1, 1), (2, 2), (1, 4))  # bf16, the trainer's dtype
DP_TP_STEPS = 10
N_DP_TP = 65_536  # the served index: FUSED_MIN_N columns, so row 1 runs


def par_dp_tp(torch, topk, here: str, dev) -> dict:
    """(i) The dp x tp InfoNCE step (parallel/minilm_tp.py) of the committed
    domain encoder at full width, on the trainer's first batch (256 pairs, 64 and
    192 tokens): f32 at (2, 2) and (1, 4) against the single-device step
    (loss and accuracy 1e-5, post-step global norm 1e-5 relative); bf16
    step times, idle share and peak memory at (1, 1), (2, 2), (1, 4); then
    10 bf16 steps at (2, 2) saved as a checkpoint and served over 65,536
    filings, row 1's counter at 0 just before the requests and read just
    after, hits equal to the dense tier's."""
    import dataclasses
    import tempfile

    import numpy as np

    from ragfin_tpu_torch.config.settings import Settings
    from ragfin_tpu_torch.eval.distractors import generate_distractors
    from ragfin_tpu_torch.models import domain_encoder, pairgen
    from ragfin_tpu_torch.models.minilm import MiniLMEncoder, minilm_apply, params_from_flax
    from ragfin_tpu_torch.models.training import AdamW, global_norm, init_train_state, make_train_step
    from ragfin_tpu_torch.parallel import minilm_tp
    from ragfin_tpu_torch.parallel.mesh import make_mesh
    from ragfin_tpu_torch.serving.engine import RagFinEngine

    t0 = time.perf_counter()
    flax_params, tok, cfg, meta = domain_encoder.load_encoder_checkpoint(
        os.path.join(here, "checkpoints", "domain_encoder"))
    params = params_from_flax(flax_params)
    rng = np.random.default_rng(0)  # the trainer's seed: its first batch

    def pair_batch():
        queries, docs = pairgen.pair_batch(rng, DOMAIN_BATCH)
        out = {}
        for side, texts, length in (("query", queries, DOMAIN_Q), ("doc", docs, DOMAIN_D)):
            ids, mask = domain_encoder._fixed_len(*tok.encode_batch(texts), length)
            out[side] = {"input_ids": torch.from_numpy(ids.astype(np.int64)).to(dev),
                         "attention_mask": torch.from_numpy(mask.astype(np.int64)).to(dev)}
        return out

    batch = pair_batch()
    # The trainer's optimizer at a constant rate (its schedule's first rate is 0).
    opt = AdamW(3e-4, weight_decay=0.01, max_grad_norm=1.0)

    def tp_state(c, dp, tp):
        mesh = make_mesh(("dp", "tp"), (dp, tp), devices=[dev] * (dp * tp))
        step = minilm_tp.make_minilm_dp_tp_train_step(mesh, c, opt)
        return step, init_train_state(minilm_tp.place_minilm_tp_params(params, mesh, c), opt)

    # ---- f32 parity against the single-device step -------------------------
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    model = MiniLMEncoder(c32)
    model.load_state_dict(params)
    ref_state, ref = make_train_step(minilm_apply, opt)(init_train_state(model.to(dev).train(), opt), batch)
    ref_norm = float(global_norm(ref_state.tensors()))
    del model, ref_state
    parity = []
    for dp, tp in DP_TP_CHECKS:
        step, state = tp_state(c32, dp, tp)
        state, got = step(state, batch)
        errs = {key: abs(float(got[key]) - float(ref[key])) for key in ("loss", "accuracy")}
        errs["norm_rel"] = abs(float(minilm_tp.global_norm(state.params)) - ref_norm) / ref_norm
        if errs["loss"] > F32_TOL or errs["accuracy"] > F32_TOL or errs["norm_rel"] > F32_TOL:
            raise AssertionError(f"dp x tp ({dp}, {tp}) f32 step against the single-device step: {errs}, "
                                 f"loss {float(got['loss'])} / {float(ref['loss'])}")
        parity.append(f"({dp}, {tp}) loss err {errs['loss']:.2e}, accuracy err {errs['accuracy']:.2e}, "
                      f"norm rel err {errs['norm_rel']:.2e}")
        del state

    # ---- bf16 step times, idle share, peak memory ---------------------------
    times = {}
    for dp, tp in DP_TP_TIMED:
        step, state = tp_state(cfg, dp, tp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        for _ in range(2):
            step(state, batch)
        runs = []
        for _ in range(DP_TP_STEPS):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            _, m = step(state, batch)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - s0) * 1e3)
        if not torch.isfinite(m["loss"]):
            raise AssertionError(f"dp x tp ({dp}, {tp}) bf16 step: loss {float(m['loss'])}")
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        busy, wall = step_profile(torch, f"parallel (i) dp x tp ({dp}, {tp}) bf16", step, state, batch, 3)
        ms = statistics.median(runs)
        # The profiler slows the host: idle against the unprofiled median too.
        times[(dp, tp)] = {"ms": ms, "busy_ms": busy, "idle": 1 - busy / ms, "idle_profiled": 1 - busy / wall,
                           "peak_gib": peak}
        del state

    # ---- 10 bf16 steps at (2, 2), saved and served --------------------------
    step, state = tp_state(cfg, 2, 2)
    losses = []
    for _ in range(DP_TP_STEPS):
        state, m = step(state, pair_batch())
        losses.append(float(m["loss"]))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"dp x tp (2, 2) bf16 training losses {losses}")
    trained = minilm_tp.gather_minilm_tp_params(state.params, cfg)
    del state
    with tempfile.TemporaryDirectory(prefix="ragfin_dp_tp_") as work:
        ckpt = domain_encoder.save_encoder_checkpoint(
            os.path.join(work, "domain_encoder"), trained, tok.vocab, cfg,
            {**meta, "dp_tp_steps": DP_TP_STEPS})
        pool = generate_distractors(int(N_DP_TP * 1.16), seed=SEED + 7)
        chunks = [c for c in pool if c.company != "ICICI Bank"][:N_DP_TP]
        b0 = time.perf_counter()
        engine = RagFinEngine(settings=Settings(embed_backend="trained", trained_checkpoint=ckpt, index_dir=""),
                              chunks=chunks)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - b0
    try:
        index = engine.vector_index
        if index.n != N_DP_TP or not index.matrix_t.is_cuda or index.embedder.checkpoint != ckpt:
            raise AssertionError(f"unexpected dp x tp engine {index.stats()}")
        engine.warmup()
        _, unscoped = questions(chunks)
        rag = engine.vector_rag
        rag.search(unscoped[0], top_k=3)
        torch.cuda.synchronize()
        # ---- the driven run: counter 0 just before, read just after -------
        topk.cosine_topk_fused.launches = 0
        served = {q: rag.search(q, top_k=3) for q in unscoped}
        torch.cuda.synchronize()
        launches = topk.cosine_topk_fused.launches
        # ---------------------------------------------------------------------
        bad, wide = [], rag._detection_fetch(3)
        with uncounted(topk.cosine_topk_fused):
            for q in unscoped:
                fused, dense = ([h.to_dict(False) for h in rag._searcher.search_texts([q], top_k=wide, method=m)[0]]
                                for m in ("auto", "dense"))
                # Served hits came from batched encodes (see the main path): BATCH_TOL.
                if not (hits_agree(dense, fused, F32_TOL) and hits_agree(fused[:3], served[q], BATCH_TOL)):
                    bad.append(q)
    finally:
        engine.close()
    if launches < len(unscoped) or not all(served.values()) or bad:
        raise AssertionError(f"dp x tp checkpoint served: {launches} launches for {len(unscoped)} requests, "
                             f"hits differ from the dense tier for {bad}")
    seconds = time.perf_counter() - t0
    print(f"parallel (i) dp x tp InfoNCE step, domain encoder ({cfg.num_layers} layers, hidden "
          f"{cfg.hidden_size}, vocab {cfg.vocab_size}, FFN {cfg.intermediate_size}), {DOMAIN_BATCH} pairs of "
          f"{DOMAIN_Q} + {DOMAIN_D} tokens: f32 against the single-device step {'; '.join(parity)}; bf16 "
          + "; ".join(f"({dp}, {tp}) {t['ms']:.3f} ms a step (median of {DP_TP_STEPS}), busy "
                      f"{t['busy_ms']:.3f} ms, idle {t['idle']:.1%} ({t['idle_profiled']:.1%} under the "
                      f"profiler), peak {t['peak_gib']:.2f} GiB"
                      for (dp, tp), t in times.items())
          + f"; (2, 2) x {DP_TP_STEPS} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, saved and served over "
          f"{N_DP_TP} filings (built in {build_s:.1f} s): {len(unscoped)} requests, fused launches {launches}, "
          f"hits equal to the dense tier; {seconds:.1f} s [{CARD}]", flush=True)
    return {"launches": launches, "times": times, "seconds": seconds}


def parallel_phase(torch, topk, graph_index, ivf, here, main_in, graph, ivf_in) -> dict:
    """Phase 10: the parallel layer on the card, counters at 0 just before
    (a) and read after (d)."""
    from ragfin_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    index, idx8, qs = main_in
    ct32, q_ivf, idx32, idx8_ivf = ivf_in
    dev = index.matrix_t.device
    wrappers = (topk.cosine_topk_fused, topk.cosine_topk_fused_int8, graph_index.masked_first_k,
                ivf.pruned_topk)
    for w in wrappers:
        w.launches = 0
    par_index(torch, topk, index, idx8, qs)
    scale = par_scale(torch, topk, dev)
    par_graph(torch, graph_index, graph)
    sharded_ivf = par_ivf(torch, topk, ivf, ct32, q_ivf, idx32, idx8_ivf)
    torch.cuda.synchronize()
    launches = {"fused_topk": topk.cosine_topk_fused.launches,
                "fused_topk_int8": topk.cosine_topk_fused_int8.launches,
                "first_k": graph_index.masked_first_k.launches,
                "ivf_topk": ivf.pruned_topk.launches}
    print(f"parallel launches (a)-(d): {launches} (the sharded IVF scores with torch ops, as JAX's "
          f"does with XLA ops: no pruned-kernel launch)", flush=True)
    par_scale_times(torch, topk, dev, scale)
    par_ivf_times(torch, ivf, q_ivf, idx32, sharded_ivf)
    par_free_source(torch, ivf, ct32)
    par_encoder(torch, here, dev, index.records)
    group_launches = par_process_group(torch, topk, dev, scale)
    dryrun_multichip(4)
    print(f"parallel (h) dryrun_multichip(4) on the card: stages 1-6 passed", flush=True)
    dp_tp = par_dp_tp(torch, topk, here, dev)
    for w in wrappers:
        w.launches = 0
    seconds = time.perf_counter() - t0
    print(f"parallel phase: {seconds:.1f} s [{CARD}]", flush=True)
    return {"launches": launches, "group_launches": group_launches, "seconds": seconds,
            "max_abs_err": scale["err"], "dp_tp_launches": dp_tp["launches"]}


def parallel_inputs(torch, graph_index, ivf):
    """Phase 10's inputs when it runs alone (--parallel): the main path's
    indexes and questions, the 10M-fact store, phase 6's IVF."""
    chunks = main_chunks()
    engine = main_engine(chunks)
    engine.close()
    index = engine.vector_index
    scoped, unscoped = questions(chunks)
    main_in = (index, int8_index(index, chunks), scoped + unscoped)
    return main_in, scale_graph(graph_index), ivf_inputs(torch, ivf)[:4]


class Lap:
    """Seconds each phase of the full run took, on the host clock: call it
    with the phase's name and result just after the phase."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, name, result):
        now = time.perf_counter()
        print(f"phase {name}: {now - self.t:.1f} s", flush=True)
        self.t = now
        return result


def main() -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="With no option: every phase, the train phase (3e) included: the bag encoder's "
               "fine-tune and the domain encoder's warm start on the card, each against the "
               "CPU, then the trained checkpoint served. --kernels and --graph skip it.")
    ap.add_argument("--kernels", action="store_true",
                    help="build, check and time the kernels alone (phases 1, 2, 4, 6 and 7)")
    ap.add_argument("--graph", action="store_true",
                    help="build, first-k alone and the graph store at scale (phases 1, 4 and 5)")
    ap.add_argument("--parallel", action="store_true",
                    help="build, then the parallel layer alone (phases 1 and 10), with its own inputs")
    ap.add_argument("--drivers", action="store_true",
                    help="build, then the drivers outside the package alone (phases 1 and 11), "
                         "with phase 3's engine built for the concurrent load")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the IVF wrapper's grid rule against fixed splits (phase 6), "
                         "the int8 wrapper's rows per block against 64 (phase 2) and "
                         "first-k's span (phase 4)")
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
        from ragfin_tpu_torch.index import graph_index
        from ragfin_tpu_torch.ops import _cuda, ivf, topk
    except ImportError as e:
        return fail(f"the ragfin_tpu_torch package is not beside this script ({e})")

    from ragfin_tpu_torch.utils.profiling import card

    global CARD
    CARD = card()
    print(CARD, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    lap = Lap()
    logs = _cuda.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s ({len(logs)} sources)", flush=True)
    pass1_ptxas(_cuda)
    merge = lap("build, ptxas, merge cases", merge_phase(torch, here))
    if args.parallel:
        parallel_phase(torch, topk, graph_index, ivf, here, *parallel_inputs(torch, graph_index, ivf))
        return 0
    if args.drivers:
        import tempfile

        with tempfile.TemporaryDirectory(prefix="ragfin_smoke_") as work_dir:
            drivers_phase(torch, topk, ivf, here, work_dir)
        return 0

    first_k = lap("first-k", first_k_phase(torch, graph_index, sweep=args.sweep))
    if args.graph:
        graph_scale_phase(torch, graph_index)
        return 0
    kern = lap("kernels", kernel_phase(torch, topk, sweep=args.sweep))
    ceil = lap("ceiling", ceiling_phase(torch, topk))
    ivf_alone = lap("IVF alone", ivf_phase(torch, topk, ivf, sweep=args.sweep))
    if args.kernels:
        return 0
    graph = lap("graph store", graph_scale_phase(torch, graph_index))
    main_path = lap("main path", main_path_phase(torch, topk, here))
    par = lap("parallel", parallel_phase(torch, topk, graph_index, ivf, here,
                                         main_path.pop("inputs"), graph, ivf_alone.pop("inputs")))
    del graph
    import tempfile

    with tempfile.TemporaryDirectory(prefix="ragfin_smoke_") as work_dir:
        lap("integrity", integrity_phase(torch, work_dir))
        hashed = lap("hashed", hashed_phase(torch, topk, work_dir))
        minilm_run = lap("minilm", minilm_phase(torch, topk, work_dir))
        train = lap("train", train_phase(torch, topk, here, work_dir))
        served = lap("served", served_phase(torch, topk, graph_index, work_dir))
        cli_run = lap("cli", cli_phase(torch, work_dir, here))
        drivers = lap("drivers", drivers_phase(torch, topk, ivf, here, work_dir,
                                               main_path["concurrent"]))
    print(f"request p50: over the wire {served['wire_p50_ms']:.2f} ms, in process "
          f"{served['in_process_p50_ms']:.2f} ms (served engine), main path one at a time "
          f"{main_path['p50_alone_ms']:.2f} ms", flush=True)

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
            "hashed_launches": hashed["launches"][name],
            "max_abs_err": kern["errs"][name],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": {"Q": 64, "N": kern["n"], "D": D, "k": r["k"]},
            "by_q": {f"{variant} Q={q_n}": rows[(key, q_n)]
                     for (key, q_n) in rows if key.startswith(name + "[") or key == name
                     for variant in [key[len(name):].strip("[]") or "default"]},
        })
    r = ivf_alone["rows"][("f32 exact", 64)]
    table.append({
        "name": "ivf_topk", "route": "cuda", "source": "ragfin_tpu_torch/csrc/ivf_topk.cu",
        "replaces": "ragfin_tpu/ops/ivf.py:293",
        "launches": main_path["launches"]["ivf_topk"],
        "hashed_launches": hashed["launches"]["ivf_topk"],
        "max_abs_err": max(ivf_alone["max_abs_err"], main_path["ivf_engine_err"]),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "shape": {"Q": 64, "block_q": IVF_BLOCK_Q, "N": ivf_alone["n"], "D": D, "cell": IVF_CELL,
                  "nprobe": IVF_NPROBE, "k": IVF_K, "cells": "float32"},
        "by_q": {f"{tier} Q={q_n}": row for (tier, q_n), row in ivf_alone["rows"].items()},
    })
    table.append({
        "name": "first_k", "route": "cuda", "source": "ragfin_tpu_torch/csrc/first_k.cu",
        "replaces": "ragfin_tpu/index/graph_index.py:81",
        "launches": main_path["launches"]["first_k"],
        **first_k,
    })
    r = ceil["rows"][("bf16 Q=64 bn=6144", "mm")]
    table.append({
        "name": "ceiling", "route": "cuda", "source": "ragfin_tpu_torch/csrc/ceiling.cu",
        "replaces": "scripts/kernel_probe.py:1080",
        "launches": cli_run["launches"],
        "max_abs_err": max([ceil["max_abs_err"]]
                           + [ladder["max_abs_err"] for ladder in kern["ladders"].values()]),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "shape": {"stage": "mm", "Q": 64, "N": ceil["n"], "D": D, "block_n": 6144,
                  "corpus": "bfloat16"},
        "stages": {f"{family} {stage}": row for (family, stage), row in ceil["rows"].items()},
        "ladders_q64": kern["ladders"],
        "served_launches": served["launches"],
    })
    table.append({
        "name": "merge_cases", "route": "cuda", "source": "ragfin_tpu_torch/csrc/merge_cases.cu",
        "replaces": "scripts/mosaic_bisect.py:26",
        "path": "scripts/mosaic_bisect_torch.py",
        **{key: merge[key] for key in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
        "shape": {"case": "nested_while", "rows": 64, "cols": 256, "sub": 128, "k": 10},
        "cases": merge["cases"],
    })
    table[0]["minilm_launches"] = minilm_run["launches"]
    table[0]["train_launches"] = train["launches"]
    table[0]["dp_tp_launches"] = par["dp_tp_launches"]
    table[0]["concurrent_launches"] = drivers["concurrent"]["launches"]
    for row in table[:3]:
        row["eval_launches"] = drivers["evals"]["launches"][row["name"]]
    for row in table:
        if row["name"] in ("fused_topk", "fused_topk_int8", "first_k"):
            row["parallel_launches"] = par["launches"][row["name"]]
    for row in table:
        if row["launches"] < 1 or any(row.get(key, 1) < 1 for key in (
                "hashed_launches", "train_launches", "parallel_launches", "dp_tp_launches",
                "concurrent_launches", "eval_launches")):
            return fail(f"kernel {row['name']} was launched no time on its path")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
