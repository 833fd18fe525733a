"""Million-scale eval of the trained semantic backend, on the CUDA card.

Counterpart of scripts/trained_eval.py for the PyTorch port. Builds the 16
real chunks + N generated distractors (eval/distractors.py, seed 1), embeds
them with the committed in-domain encoder (checkpoints/domain_encoder/) and
measures:

- labelled recall through the production FilteredSearch (no query expansion
  for semantic backends);
- the raw embedding arms: no filters, no expansion, no lexicon;
- the graph / hybrid arms on the trained backend;
- IVF against exact on the trained embeddings, with the exact side scored
  on the host (one f32 product, stable lowest-id tie-break) and agreement
  read through ``tie_aware_agreement``.

The 16 real chunks and the labelled question sets come from REFERENCE_ROOT
when it is set (``extract_data/``, ``qa_subset.json``,
``vector_rag_evaluation_dataset.json``). Without it the chunks come from a
generated ``extract_data`` tree (``write_extract_data``, seed 0) and the only
labelled questions are the holdout phrasings shipped in the package; the arms
of the absent sets are skipped, and such recalls are not comparable with the
reference's.

Encoding is resumable: embeddings persist in SLAB-chunk float16 slabs under
EVAL_OUT/trained_emb_torch_{N}/, keyed on the checkpoint's fingerprint.

Usage: [DISTRACTOR_N=1000000] [TRAINED_DTYPE=f32|bf16|int8] [ARMS=all]
       [EVAL_OUT=eval_results] python3 scripts/trained_eval_torch.py
Writes EVAL_OUT/trained_eval_torch_{N}.json. It runs on the CUDA card;
RAGFIN_DEVICE=cpu runs it on the CPU.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DTYPES = {"f32": "float32", "bf16": "bfloat16", "int8": "int8"}


def out_dir() -> str:
    return os.environ.get("EVAL_OUT") or os.path.join(ROOT, "eval_results")


def emb_dir(n: int) -> str:
    return os.path.join(out_dir(), f"trained_emb_torch_{n}")


def reference_inputs(ref):
    """(real chunks, qa_subset, vector_eval, holdout phrasings): from the
    reference directory ``ref`` where it is given, else from a generated
    ``extract_data`` tree (seed 0) with qa_subset and vector_eval None."""
    from ragfin_tpu_torch.data.loader import build_corpus
    from ragfin_tpu_torch.eval.datasets import (
        load_holdout_phrasings,
        load_qa_subset,
        load_vector_eval,
    )

    hp = load_holdout_phrasings()
    if ref:
        return (
            build_corpus(os.path.join(ref, "extract_data")),
            load_qa_subset(os.path.join(ref, "qa_subset.json")),
            load_vector_eval(os.path.join(ref, "vector_rag_evaluation_dataset.json")),
            hp,
        )
    import tempfile

    from ragfin_tpu_torch.eval.statements import write_extract_data

    with tempfile.TemporaryDirectory(prefix="ragfin_extract_") as tmp:
        real = build_corpus(write_extract_data(tmp, seed=0))
    return real, None, None, hp


def encode_corpus(embedder, texts, t0, path=None):
    """Resumable slab-wise encode: returns [N, 384] float32.

    The cache is keyed on the encoder checkpoint's fingerprint: slabs from
    another encoder version would otherwise be mixed with queries encoded by
    the new checkpoint. ``path`` defaults to :func:`emb_dir` of
    DISTRACTOR_N."""
    import shutil

    import numpy as np

    slab = int(os.environ.get("SLAB", 100_000))
    path = path or emb_dir(int(os.environ.get("DISTRACTOR_N", 1_000_000)))
    os.makedirs(path, exist_ok=True)
    fingerprint = {k: embedder.meta.get(k) for k in ("steps", "final_loss", "wall_s", "seed")}
    marker = os.path.join(path, "encoder.json")
    stale = True
    if os.path.exists(marker):
        with open(marker) as f:
            stale = json.load(f) != fingerprint
    if stale:
        shutil.rmtree(path)
        os.makedirs(path)
        with open(marker, "w") as f:
            json.dump(fingerprint, f)
    encode_only = os.environ.get("ENCODE_ONLY") == "1"
    slabs = []
    for start in range(0, len(texts), slab):
        name = os.path.join(path, f"slab_{start:08d}.npy")
        stop = min(start + slab, len(texts))
        if os.path.exists(name):
            if encode_only:
                continue
            arr = np.load(name)
            if arr.shape[0] == stop - start:
                slabs.append(arr.astype(np.float32))
                continue
        t = time.perf_counter()
        emb = embedder.encode_texts(texts[start:stop])
        np.save(name, emb.astype(np.float16))
        if not encode_only:
            slabs.append(emb)
        rate = (stop - start) / (time.perf_counter() - t)
        print(
            f"[{time.perf_counter()-t0:7.1f}s] encoded {stop:,}/{len(texts):,} "
            f"({rate:,.0f} chunks/s)",
            flush=True,
        )
    if encode_only:
        return None  # ENCODE_ONLY=1: slabs on disk, nothing held in RAM
    return np.concatenate(slabs, axis=0)


def main(keep: dict | None = None) -> dict:
    """Runs the arms ARMS selects and returns the report it writes.
    ``keep``, where given, receives the index the arms search under
    "index" (for a caller that checks their hits)."""
    import numpy as np

    from ragfin_tpu_torch.eval.distractors import generate_distractors, paraphrased_questions
    from ragfin_tpu_torch.eval.harness import evaluate_retrieval
    from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex
    from ragfin_tpu_torch.models.embedder import TrainedEmbedder
    from ragfin_tpu_torch.retrieval.queryfilter import FilteredSearch
    from ragfin_tpu_torch.utils.device import resolve_device

    device = resolve_device(os.environ.get("RAGFIN_DEVICE") or None)
    n = int(os.environ.get("DISTRACTOR_N", 1_000_000))
    ref = os.environ.get("REFERENCE_ROOT") or None
    dtype = DTYPES[os.environ.get("TRAINED_DTYPE", "f32")]
    out_path = os.path.join(out_dir(), f"trained_eval_torch_{n}.json")
    t0 = time.perf_counter()
    embedder = TrainedEmbedder(batch_size=512, pad_multiple=192, device=device)
    print(f"[{time.perf_counter()-t0:7.1f}s] encoder loaded on {device}: "
          f"{embedder.meta.get('steps')} steps, vocab {embedder.tokenizer.vocab_size}", flush=True)

    real, qa, ve, hp = reference_inputs(ref)
    dis = generate_distractors(n, seed=1)
    chunks = list(real) + dis
    print(f"[{time.perf_counter()-t0:7.1f}s] corpus: {len(chunks):,} chunks", flush=True)

    texts = [c.text for c in chunks]
    if os.environ.get("ENCODE_ONLY") == "1":
        del chunks, dis, real
        encode_corpus(embedder, texts, t0, emb_dir(n))
        print(f"[{time.perf_counter()-t0:7.1f}s] encode-only pass complete", flush=True)
        return {}
    matrix = encode_corpus(embedder, texts, t0, emb_dir(n))
    del texts
    idx = DeviceVectorIndex(matrix, chunks, dtype=dtype, device=device)
    del matrix  # the index keeps its own (padded) rows
    idx.embedder = embedder  # query encoding path
    if keep is not None:
        keep["index"] = idx
    print(f"[{time.perf_counter()-t0:7.1f}s] index built: {len(idx):,} (dtype {dtype})", flush=True)

    para = paraphrased_questions(qa) if qa else None
    labelled = qa or hp  # the graph and IVF arms' questions
    fs = FilteredSearch(idx)

    out = {
        "n_distractors": n,
        "n_chunks": len(idx),
        "backend": "trained",
        "dtype": dtype,
        "device": str(device),
        "reference_root": ref,
        "questions": "reference" if ref else (
            "generated extract_data (seed 0) and the holdout phrasings only; "
            "not comparable with the reference's recalls"
        ),
        "encoder_meta": {k: embedder.meta.get(k) for k in ("steps", "final_loss", "platform")},
        "results": {},
    }

    def write() -> None:
        os.makedirs(out_dir(), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=2)

    def run_arm(name, questions, searcher, k):
        if not questions:
            return  # the set is absent without the reference
        t = time.perf_counter()
        s = evaluate_retrieval(searcher, questions, k=k).summary()
        s["wall_s"] = round(time.perf_counter() - t, 2)
        out["results"][name] = s
        print(
            f"[{time.perf_counter()-t0:7.1f}s] {name}: "
            f"recall={s['retrieval_recall']['mean']:.3f} "
            f"precision={s['retrieval_precision']['mean']:.3f} "
            f"zero={s['zero_recall_queries']}",
            flush=True,
        )
        write()

    # ARMS=ivf (comma list) re-runs a subset against the slab cache; results
    # merge into the existing artifact.
    arms = set(filter(None, os.environ.get("ARMS", "all").split(",")))
    if os.path.exists(out_path) and arms != {"all"}:
        with open(out_path) as f:
            out["results"].update(json.load(f).get("results", {}))

    if arms & {"all", "pipeline"}:
        run_arm("qa_subset_k3_trained", qa, fs, 3)
        run_arm("qa_subset_k10_trained", qa, fs, 10)
        run_arm("paraphrases_k10_trained", para, fs, 10)
        run_arm("vector_eval_k10_trained", ve, fs, 10)
        run_arm("holdout_phrasings_k10_trained", hp, fs, 10)
        run_arm("holdout_phrasings_k3_trained", hp, fs, 3)
    if arms & {"all", "raw"}:
        run_arm("qa_subset_k10_raw_trained", qa, idx, 10)
        run_arm("paraphrases_k10_raw_trained", para, idx, 10)
        run_arm("holdout_phrasings_k10_raw_trained", hp, idx, 10)
    if arms & {"all", "graph"}:
        # The graph facts come from the real records + 2,000 multi-company
        # distractors as noise.
        from ragfin_tpu_torch.eval.graph_arms import graph_hybrid_arms

        t = time.perf_counter()
        ga = graph_hybrid_arms(idx, real, labelled, vector_searcher=fs, noise_chunks=dis[:2000])
        ga["wall_s"] = round(time.perf_counter() - t, 2)
        out["results"]["graph_hybrid_arms_trained"] = ga
        for name, v in ga.items():
            if isinstance(v, dict) and "retrieval_recall" in v:
                print(f"[{time.perf_counter()-t0:7.1f}s] {name}: "
                      f"recall={v['retrieval_recall']['mean']:.3f}", flush=True)
        write()
    if not arms & {"all", "ivf"}:
        write()
        print("wrote", out_path)
        return out

    try:
        from ragfin_tpu_torch.eval.harness import tie_aware_agreement
        from ragfin_tpu_torch.index.ivf_index import IVFVectorIndex

        t = time.perf_counter()
        ivf = IVFVectorIndex.from_dense(idx, cell=2048, iters=3)
        n_cells = ivf.ivf.n_cells
        build_s = time.perf_counter() - t
        questions = [q.question for q in labelled]
        # The reference is the HOST-exact oracle over the f32 shadow rows
        # (one host product, stable descending, lowest id first), never a
        # device tier: inside the bitwise-duplicate tie bands of trained
        # embeddings a device tier's last-ulp differences flip membership.
        wide = 128
        qv = np.asarray(embedder.encode_texts(questions), np.float32)
        s_all = ivf._exact_rows @ qv.T  # [N, Q] f32, one BLAS call
        exact_wide = []
        for qi in range(len(questions)):
            s = s_all[:, qi]
            part = np.argpartition(-s, min(wide * 4, len(s) - 1))[: wide * 4]
            order = part[np.lexsort((part, -s[part]))][:wide]
            exact_wide.append([(idx.records[i].id, float(s[i])) for i in order])
        del s_all
        # The exact tier's wall at the same k over the same questions.
        t = time.perf_counter()
        idx.search_texts(questions, top_k=10)
        exact_wall = time.perf_counter() - t
        curve = {}
        for nprobe in sorted(
            {max(2, n_cells // 32), max(2, n_cells // 8), max(2, n_cells // 4), n_cells}
        ):
            ivf.search_texts(questions, top_k=10, nprobe=nprobe)  # warm
            t = time.perf_counter()
            approx = ivf.search_texts(questions, top_k=10, nprobe=nprobe)
            wall = time.perf_counter() - t
            overlap, tie_aware, trunc = tie_aware_agreement(
                exact_wide, [[h.id for h in hits] for hits in approx], k=10, wide=wide
            )
            curve[nprobe] = {
                "overlap": round(overlap, 4),
                "tie_aware": round(tie_aware, 4),
                "tie_truncated": trunc,
                "wall_s": round(wall, 2),
            }
        out["results"]["ivf_vs_exact_overlap@10_trained"] = {
            "agreement_by_nprobe": curve,
            "n_cells": n_cells,
            "build_s": round(build_s, 1),
            "exact_wall_s_k10": round(exact_wall, 2),
        }
        print(f"[{time.perf_counter()-t0:7.1f}s] ivf: {curve}", flush=True)
    except Exception as e:  # the main arms are already written
        print(f"[ivf] failed: {e!r}", flush=True)

    write()
    print("wrote", out_path)
    return out


if __name__ == "__main__":
    main()
