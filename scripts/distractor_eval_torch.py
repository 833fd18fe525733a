"""Million-scale distractor evaluation of the hashed backend, on the CUDA card.

Counterpart of scripts/distractor_eval.py for the PyTorch port. Builds an
index over the 16 real chunks + N synthetic hard negatives
(eval/distractors.py), runs the labelled questions at k=3/k=10 through the
production pipeline (FilteredSearch) and the raw-embedding ablation, and
writes EVAL_OUT/distractor_eval_torch_{N}.json.

The 16 real chunks and the labelled question sets come from REFERENCE_ROOT
when it is set; without it, from a generated ``extract_data`` tree
(``write_extract_data``, seed 0) and the holdout phrasings shipped in the
package (scripts/trained_eval_torch.py:reference_inputs). The arms of absent
question sets are skipped, and such recalls are not comparable with the
reference's.

Usage: [DISTRACTOR_N=1000000] [ARMS=all] [EVAL_OUT=eval_results]
       python3 scripts/distractor_eval_torch.py
It runs on the CUDA card; RAGFIN_DEVICE=cpu runs it on the CPU.

ARMS=base,graph,ivf,tamper,fabrication,scaled,sparse (comma list; default
"all") selects arm groups: at 10M each in-scope group rebuilds a full-size
index, so running groups in separate processes bounds peak memory and makes
the battery resumable; results merge into the existing artifact.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

# Out-of-scope distractors can never enter an FY2024 question's candidate set
# (the company and period masks remove them before scoring), so the base arms
# measure the filter parser. The in-scope arms add ICICI-FY2024 perturbed
# negatives that survive every mask and force the embedder to discriminate.
INSCOPE_N = int(os.environ.get("INSCOPE_N", 20_000))


def _ivf_agreement(idx, qa, out):
    """IVF (cluster-pruned approximate) arm: overlap between IVF top-10 and
    the EXACT top-10 in the same embedding space — this isolates the
    cluster-pruning loss (recall-vs-labels belongs to the production
    pipeline arms; the raw embedding space is ambiguous by construction,
    see the raw_embedding ablation). Disable with DISTRACTOR_IVF=0."""
    if os.environ.get("DISTRACTOR_IVF", "1") != "1" or len(idx) < 4096:
        return
    import numpy as np

    from ragfin_tpu_torch.index.ivf_index import IVFVectorIndex

    t = time.perf_counter()
    ivf = IVFVectorIndex.from_dense(idx, cell=2048, iters=3)
    n_cells = ivf.ivf.n_cells
    build_s = time.perf_counter() - t
    questions = [q.question for q in qa]
    exact = idx.search_texts(questions, top_k=10)
    curve = {}
    for nprobe in sorted({max(2, n_cells // 8), max(2, n_cells // 4), max(2, n_cells // 2), n_cells}):
        approx = ivf.search_texts(questions, top_k=10, nprobe=nprobe)
        overlaps = []
        for e_hits, a_hits in zip(exact, approx):
            e_ids = {h.id for h in e_hits}
            if e_ids:
                overlaps.append(len(e_ids & {h.id for h in a_hits}) / len(e_ids))
        curve[nprobe] = round(float(np.mean(overlaps)) if overlaps else 0.0, 4)
    out["results"]["ivf_vs_exact_overlap@10"] = {
        "agreement_by_nprobe": curve,
        "n_cells": n_cells,
        "build_s": round(build_s, 1),
    }
    print(
        f"[ivf] {n_cells} cells (built {build_s:.1f}s): top-10 agreement "
        f"with exact by nprobe = {curve}",
        flush=True,
    )


def main(keep: dict | None = None) -> dict:
    """Runs the arms ARMS selects and returns the report it writes.
    ``keep``, where given, receives the index the arms search under
    "index" (for a caller that checks their hits)."""
    from ragfin_tpu_torch.eval.distractors import (
        generate_distractors,
        generate_inscope_distractors,
        paraphrased_questions,
    )
    from ragfin_tpu_torch.eval.harness import evaluate_retrieval
    from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex
    from ragfin_tpu_torch.retrieval.queryfilter import FilteredSearch
    from ragfin_tpu_torch.utils.device import resolve_device
    from trained_eval_torch import out_dir, reference_inputs

    device = resolve_device(os.environ.get("RAGFIN_DEVICE") or None)
    N = int(os.environ.get("DISTRACTOR_N", 1_000_000))
    ref = os.environ.get("REFERENCE_ROOT") or None

    def build(chunks):
        return DeviceVectorIndex.build(chunks, device=device)

    t0 = time.perf_counter()
    real, qa, ve, hp = reference_inputs(ref)
    dis = generate_distractors(N, seed=1)
    print(f"[{time.perf_counter()-t0:7.1f}s] generated {N:,} distractors", flush=True)
    idx = build(list(real) + dis)
    print(f"[{time.perf_counter()-t0:7.1f}s] index built on {device}: {len(idx):,} chunks", flush=True)
    if keep is not None:
        keep["index"] = idx
    para = paraphrased_questions(qa) if qa else None
    labelled = qa or hp  # the in-scope, conflict and IVF arms' questions
    fs = FilteredSearch(idx)

    # Arm-group selection (10M memory/resume discipline — see module doc).
    arms = set(filter(None, os.environ.get("ARMS", "all").split(",")))

    def on(name: str) -> bool:
        return bool(arms & {"all", name})

    os.makedirs(out_dir(), exist_ok=True)
    path = os.path.join(out_dir(), f"distractor_eval_torch_{N}.json")
    out = {
        "n_distractors": N,
        "n_chunks": len(idx),
        "device": str(device),
        "reference_root": ref,
        "questions": "reference" if ref else (
            "generated extract_data (seed 0) and the holdout phrasings only; "
            "not comparable with the reference's recalls"
        ),
        "results": {},
    }
    if os.path.exists(path) and arms != {"all"}:
        with open(path) as f:
            out["results"].update(json.load(f).get("results", {}))

    qname = "qa" if qa else "holdout"  # the labelled set the later arms use

    def write(note: str = "") -> None:
        with open(path, "w") as f:
            json.dump(out, f, indent=2)
        print("wrote", path, note)

    def run_arm(name, questions, searcher, k, precision=False):
        if not questions:
            return None  # the set is absent without the reference
        t = time.perf_counter()
        s = evaluate_retrieval(searcher, questions, k=k).summary()
        s["wall_s"] = round(time.perf_counter() - t, 2)
        out["results"][name] = s
        extra = f"precision={s['retrieval_precision']['mean']:.3f} " if precision else ""
        print(
            f"[{time.perf_counter()-t0:7.1f}s] {name}: recall={s['retrieval_recall']['mean']:.3f} "
            f"{extra}zero={s['zero_recall_queries']}",
            flush=True,
        )
        return s

    if on("base"):
        for name, questions, searcher, k in [
            ("qa_subset_k3", qa, fs, 3),
            ("qa_subset_k10", qa, fs, 10),
            ("paraphrases_k10", para, fs, 10),
            ("vector_eval_k10", ve, fs, 10),
            # Hand-written held-out phrasings: colloquial, abbreviated,
            # misspelled and compositional styles the pair generators cannot
            # emit.
            ("holdout_phrasings_k10", hp, fs, 10),
            ("holdout_phrasings_k3", hp, fs, 3),
            ("qa_subset_k10_raw_embedding", qa, idx, 10),
            ("holdout_phrasings_k10_raw_embedding", hp, idx, 10),
        ]:
            run_arm(name, questions, searcher, k, precision=True)
        # Write the main results BEFORE the optional arms: a failure there
        # (e.g. k-means running out of memory at 1M) must not discard them.
        write()

    # ---- graph / hybrid quality arms ---------------------------------------
    # The same labelled questions through the strategy dispatch, the plan
    # engine and hybrid fusion (raw-vector leg and FilteredSearch leg). The
    # graph is built from the real records + 2,000 multi-company distractor
    # chunks as fact noise (company-scoped per record).
    if on("graph") and os.environ.get("GRAPH_ARMS", "1") == "1":
        from ragfin_tpu_torch.eval.graph_arms import graph_hybrid_arms

        t = time.perf_counter()
        arms_out = graph_hybrid_arms(idx, real, labelled, vector_searcher=fs, noise_chunks=dis[:2000])
        for name, v in arms_out.items():
            if isinstance(v, dict) and "retrieval_recall" in v:
                v["wall_s"] = None
                print(
                    f"[{time.perf_counter()-t0:7.1f}s] {name}: "
                    f"recall={v['retrieval_recall']['mean']:.3f} "
                    f"precision={v['retrieval_precision']['mean']:.3f} "
                    f"zero={v['zero_recall_queries']}",
                    flush=True,
                )
        arms_out["wall_s"] = round(time.perf_counter() - t, 2)
        out["results"]["graph_hybrid_arms"] = arms_out
        write("(with graph/hybrid arms)")

    # ---- in-scope arms: negatives that survive every filter mask -----------
    # 'reword'/'dupe' tamper with the gold chunks' figures and wording, which
    # in-text arithmetic detects (retrieval/consistency.py), so the defended
    # pipeline (consistency_weight=0.95) must hold recall near the clean
    # ceiling. 'regen' fabricates internally consistent statements: evidence
    # no text-only retriever can resolve without provenance, reported as the
    # bound, not a headline.
    if INSCOPE_N:
        out["n_inscope"] = INSCOPE_N
        for tag, tiers in [("tamper", ("reword", "dupe")), ("fabrication", ("regen",))]:
            if not on(tag):
                continue
            ins = generate_inscope_distractors(real, INSCOPE_N, seed=11, tiers=tiers)
            idx_in = build(list(real) + dis + ins)
            print(
                f"[{time.perf_counter()-t0:7.1f}s] {tag} index built: "
                f"{len(idx_in):,} chunks ({INSCOPE_N:,} in-scope {'/'.join(tiers)})",
                flush=True,
            )
            undefended = FilteredSearch(idx_in)
            defended = FilteredSearch(idx_in, consistency_weight=0.95)
            run_arm(f"{qname}_k10_inscope_{tag}_undefended", labelled, undefended, 10)
            run_arm(f"{qname}_k3_inscope_{tag}", labelled, defended, 3)
            run_arm(f"{qname}_k10_inscope_{tag}", labelled, defended, 10)
            if tag == "tamper":
                run_arm(f"paraphrases_k10_inscope_{tag}", para, defended, 10)
            del idx_in, undefended, defended
            write(f"(with in-scope {tag} arms)")
        out["results"]["inscope_notes"] = {
            "tamper": (
                "reword/dupe tiers perturb the gold chunks' figures (and "
                "wording); every perturbed copy survives the company/period/"
                "type masks. Defended arms use consistency_weight=0.95: "
                "in-text arithmetic (declared shares, named ratios, subset "
                "sums, EPS band) gates figure-tampered copies at both device "
                "candidate generation and final ranking "
                "(ragfin_tpu_torch/retrieval/consistency.py)."
            ),
            "fabrication": (
                "regen tier fabricates internally-consistent ICICI-FY2024 "
                "statements with fresh random figures. These are conflicting "
                "evidence, not noise: without provenance/authority metadata "
                "no text-only retriever (lexical or semantic) can identify "
                "the authentic chunk among N co-scoped self-consistent "
                "claims; expected recall decays toward chance with N. The "
                "production answer is source provenance, which IndexedChunk "
                "carries (id/company fields) but this adversary is allowed "
                "to forge."
            ),
        }
        write()

    # ---- scaled tamper arms: the smart forger -------------------------------
    # One per-chunk factor on every rupee amount: all in-text arithmetic is
    # scale-invariant, so the single-document integrity defence is blind by
    # construction. What remains detectable is cross-chunk: contested scopes
    # (conflict flags and abstention) always, and continuity adjudication
    # while authentic corroborators dominate.
    if INSCOPE_N and os.environ.get("SCALED_ARMS", "1") == "1" and (on("scaled") or on("sparse")):
        from ragfin_tpu_torch.retrieval.conflict import (
            ContinuityAdjudicatedSearch,
            detect_conflicts,
        )

        def conflict_rate(searcher, questions, k=10, fetch=32):
            """{'top': fraction whose top hit sits in a contested scope (the
            abstention trigger; 0 on a clean corpus), 'any': fraction with any
            contested scope in the shortlist}. Detection runs over a
            ``fetch``-wide shortlist, as VectorRAG does (detection_fetch_k=32)."""
            cache: dict = {}
            flagged_any = flagged_top = 0
            for q in questions:
                hits = searcher.search_texts([q.question], top_k=max(k, fetch))[0]
                scopes = detect_conflicts(hits, cache=cache)
                contested = {k_ for k_, i in scopes.items() if i["conflict"]}
                if contested:
                    flagged_any += 1
                if hits:
                    r = hits[0].record
                    if (r.company, r.period, r.chunk_type) in contested:
                        flagged_top += 1
            n = max(len(questions), 1)
            return {"top": round(flagged_top / n, 4), "any": round(flagged_any / n, 4)}

        if on("scaled"):
            # The false-flag gate on the clean corpus first: its rate must be 0.
            clean_rate = conflict_rate(fs, labelled)
            out["results"]["conflict_flag_rate_clean"] = clean_rate
            print(f"[{time.perf_counter()-t0:7.1f}s] conflict flags (clean): {clean_rate}", flush=True)

            ins = generate_inscope_distractors(real, INSCOPE_N, seed=13, tiers=("scaled",))
            idx_sc = build(list(real) + dis + ins)
            print(f"[{time.perf_counter()-t0:7.1f}s] scaled index built: {len(idx_sc):,}", flush=True)
            undefended = FilteredSearch(idx_sc)
            integrity = FilteredSearch(idx_sc, consistency_weight=0.95)
            run_arm(f"{qname}_k10_inscope_scaled_undefended", labelled, undefended, 10)
            run_arm(f"{qname}_k10_inscope_scaled_integrity", labelled, integrity, 10)
            out["results"]["conflict_flag_rate_scaled"] = conflict_rate(undefended, labelled)
            print(
                f"[{time.perf_counter()-t0:7.1f}s] conflict flags (scaled): "
                f"{out['results']['conflict_flag_rate_scaled']}",
                flush=True,
            )
            del idx_sc, undefended, integrity
            write()

            # Fabrication conflict flags: regen forgeries are co-scoped,
            # internally consistent contradictions; ranking them is
            # impossible, flagging them is not.
            ins_fab = generate_inscope_distractors(real, min(INSCOPE_N, 2000), seed=17, tiers=("regen",))
            idx_fab = build(list(real) + ins_fab)
            out["results"]["conflict_flag_rate_fabrication"] = conflict_rate(
                FilteredSearch(idx_fab), labelled
            )
            print(
                f"[{time.perf_counter()-t0:7.1f}s] conflict flags (fabrication): "
                f"{out['results']['conflict_flag_rate_fabrication']}",
                flush=True,
            )
            del idx_fab

        if not on("sparse"):
            write("(scaled arms, sparse skipped)")
        else:
            # Sparse adversary: 5 scaled forgeries per gold chunk, inserted
            # before the gold rows and with ids that sort before gold's, the
            # worst case for every tie-break an exact-duplicate attack hits.
            # Continuity adjudication is the defence with teeth here.
            import numpy as np

            from ragfin_tpu_torch.data.models import IndexedChunk
            from ragfin_tpu_torch.eval.distractors import _scale_uniformly

            r = np.random.default_rng(23)
            forged = []
            for gi, g in enumerate(real):
                for c in range(5):
                    forged.append(
                        IndexedChunk(
                            id=f"aa_forged_{gi:02d}_{c}",
                            text=_scale_uniformly(g.text, r),
                            period=g.period,
                            chunk_type=g.chunk_type,
                            statement_type=g.statement_type,
                            primary_value=g.primary_value,
                            company=g.company,
                        )
                    )
            idx_sp = build(forged + list(real) + dis)
            und = FilteredSearch(idx_sp)
            run_arm(f"{qname}_k10_sparse_scaled_undefended", labelled, und, 10)
            run_arm(
                f"{qname}_k10_sparse_scaled_continuity",
                labelled,
                ContinuityAdjudicatedSearch(und, idx_sp),
                10,
            )
            out["results"]["sparse_scaled_notes"] = (
                "5 scale-consistent forgeries per gold chunk (80 total), worst-"
                "case insertion/id order so every exact-duplicate tie-break "
                "favors the forger. Undefended = tie-break collapse; continuity "
                "= best-effort cross-period adjudication "
                "(retrieval/conflict.py): a measurable recall improvement, not "
                "recovery: scale-consistent forgeries are in-band "
                "unidentifiable. Scaling attacks therefore join fabrication "
                "under the impossibility bound; the production defense is "
                "conflict flagging + abstention (rates above; VectorRAG "
                "answer_mode='conflict')."
            )
            del idx_sp, und
            write("(with scaled/conflict arms)")

    if on("ivf"):
        try:
            _ivf_agreement(idx, labelled, out)
        except Exception as e:  # the main arms are already written
            print(f"[ivf] agreement arm failed: {e!r}", flush=True)
        else:
            write("(with IVF agreement)")
    return out


if __name__ == "__main__":
    main()
