"""Command-line interface: build, query, evaluate, serve, extract, train.

Replaces the reference's script-per-task workflow (``chunking_storing``
module script, ``retrieve.py`` interactive main, ``graphretrieve.py`` smoke
runs, ``multi_bank_extractor`` batch loop) with one CLI:

    python -m ragfin_tpu_torch.cli chunk        --data extract_data --out chunks.json
    python -m ragfin_tpu_torch.cli build-index  --data extract_data --out .ragfin_index
    python -m ragfin_tpu_torch.cli query        "net profit in Q1 FY2024?" --mode hybrid
    python -m ragfin_tpu_torch.cli eval         --path qa.json --k 10 --summary out.json
    python -m ragfin_tpu_torch.cli extract-pdf  path/to/report.pdf
    python -m ragfin_tpu_torch.cli serve        --model fake
    python -m ragfin_tpu_torch.cli train        --data extract_data --qa qa.json --epochs 30
    python -m ragfin_tpu_torch.cli bench        --n 1000000

Counterpart of ``ragfin_tpu/cli.py`` with the same subcommands, flags and
defaults. Everything that touches an index runs on the CUDA card and raises
without one; ``RAGFIN_DEVICE=cpu`` asks for the CPU (the counterpart of
pinning ``JAX_PLATFORMS``). ``build-index`` embeds with the hashed backend,
as the JAX command does; ``train`` fine-tunes its projection table on a
labeled QA file and prints recall and F1 before and after. ``eval`` and
``train`` need their QA file named (``--path``, ``--qa``): the JAX CLI's
defaults point into the reference repository.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys


def cmd_chunk(args) -> int:
    from .data.loader import build_corpus, save_chunk_snapshot

    chunks = build_corpus(args.data)
    save_chunk_snapshot(chunks, args.out)
    print(f"wrote {len(chunks)} chunks to {args.out}")
    return 0


def cmd_build_index(args) -> int:
    import os

    from .config.settings import get_config
    from .data.loader import build_corpus
    from .extraction.service import rule_based_extract
    from .index.graph_index import GraphIndex
    from .index.vector_index import DeviceVectorIndex
    from .utils.device import resolve_device

    device = resolve_device(get_config().device)
    chunks = build_corpus(args.data)
    index = DeviceVectorIndex.build(chunks, device=device)
    if getattr(args, "index_type", "flat") == "ivf":
        from .index.ivf_index import IVFVectorIndex

        index = IVFVectorIndex.from_dense(
            index, cell=args.cell, nprobe=args.nprobe
        )
    index.save(args.out)
    graph = GraphIndex(device=device)
    for c in chunks:
        graph.save_entities(rule_based_extract(c.text), c.id)
    graph.save(os.path.join(args.out, "graph"))
    print(json.dumps({"chunks": len(chunks), **index.stats(), "graph_facts": graph.stats()["total_facts"]}, default=str))
    return 0


def _engine(args):
    import dataclasses

    from .config.settings import get_config
    from .serving.engine import RagFinEngine

    # Start from the env-derived config (RAGFIN_* vars — integrity weight,
    # embed backend, index type, ... must all apply to CLI engines exactly
    # as to serving ones) and override only what the CLI flags name.
    settings = dataclasses.replace(
        get_config(),
        default_model=getattr(args, "model", "fake") or "fake",
        data_dir=getattr(args, "data", "extract_data"),
        index_dir=getattr(args, "index", ".ragfin_index"),
    )
    return RagFinEngine(settings)


# The reference's canned smoke questions (retrieve.py:90-102).
_CANNED_QUESTIONS = [
    "What was ICICI Bank's net profit in Q1 FY2024?",
    "What was the total income in Q2 FY2024?",
    "How did net profit trend across all quarters of FY2024?",
    "Which quarter had the lowest cost ratio?",
    "What was the retail banking segment revenue in Q4 FY2024?",
]


def _answer_one(engine, mode: str, question: str, k: int) -> dict:
    if mode == "vector":
        return asyncio.run(engine.vector_rag.search_and_answer(question, k))
    if mode == "graph":
        return asyncio.run(engine.graph_builder.query_engine.query(question, k))
    return asyncio.run(engine.hybrid.hybrid_query(question, vector_k=k))


def cmd_query(args) -> int:
    engine = _engine(args)
    if args.mode in ("graph", "hybrid"):
        engine.graph_builder.build_from_vector_index(engine.vector_index)
    if getattr(args, "interactive", False):
        # Reference interactive main (retrieve.py:90-111): run the canned
        # test questions, then loop on stdin until quit/exit/EOF.
        for q in _CANNED_QUESTIONS:
            out = _answer_one(engine, args.mode, q, args.k)
            print(f"\nQ: {q}\nA: {out.get('answer') or out.get('results')}")
        while True:
            try:
                q = input("\nYour question (quit to exit): ").strip()
            except EOFError:
                break
            if not q or q.lower() in ("quit", "exit", "q"):
                break
            out = _answer_one(engine, args.mode, q, args.k)
            print(f"A: {out.get('answer') or out.get('results')}")
        return 0
    if not args.question:
        print("error: question required unless --interactive", file=sys.stderr)
        return 2
    out = _answer_one(engine, args.mode, args.question, args.k)
    print(json.dumps(out, indent=2, ensure_ascii=False, default=str))
    return 0


def cmd_eval(args) -> int:
    from .eval.datasets import load_qa_subset, load_vector_eval
    from .eval.harness import evaluate_retrieval, to_research_summary

    if not args.path:
        # The JAX CLI defaults to the reference repository's files at a fixed
        # mount; the port evaluates the file it is given.
        print("error: eval needs --path (a labeled QA or vector-eval file)", file=sys.stderr)
        return 2
    engine = _engine(args)
    questions = (load_qa_subset if args.dataset == "qa" else load_vector_eval)(args.path)
    # Evaluate the production retrieval pipeline (query filters + exact
    # rerank) — what VectorRAG serves; --raw ablates to bare embedding search.
    searcher = engine.vector_index
    if not getattr(args, "raw", False) and getattr(searcher, "supports_filters", False):
        from .retrieval.queryfilter import FilteredSearch

        # Mirror what VectorRAG serves (vector_rag.py): eval must measure
        # the production pipeline including a configured integrity gate.
        searcher = FilteredSearch(
            searcher, consistency_weight=engine.settings.integrity_weight
        )
    report = evaluate_retrieval(searcher, questions, k=args.k)
    summary = report.summary()
    print(json.dumps(summary, indent=2))
    if args.summary:
        with open(args.summary, "w") as f:
            json.dump(to_research_summary(report), f, indent=2)
        print(f"research summary written to {args.summary}", file=sys.stderr)
    return 0 if summary["retrieval_recall"]["mean"] >= args.min_recall else 1


def cmd_extract_pdf(args) -> int:
    from .data.pdf_extractor import extract_report

    report = extract_report(args.path)
    if not args.full_text:
        report.pop("text", None)
    print(json.dumps(report, indent=2, ensure_ascii=False))
    return 0


def cmd_serve(args) -> int:
    from .serving import main as serving_main

    serving_main.main(["--model", args.model] if args.model else [])
    return 0


def cmd_train(args) -> int:
    from .config.settings import get_config
    from .data.loader import build_corpus
    from .eval.datasets import load_qa_subset
    from .models.finetune import finetune_and_evaluate
    from .utils.device import resolve_device

    if not args.qa:
        print("error: train needs --qa (a labeled QA file)", file=sys.stderr)
        return 2
    device = resolve_device(get_config().device)
    chunks = build_corpus(args.data)
    questions = load_qa_subset(args.qa)
    out = finetune_and_evaluate(
        chunks, questions, k=args.k, epochs=args.epochs, checkpoint_dir=args.checkpoint_dir,
        device=device,
    )
    print(json.dumps({k: v for k, v in out.items() if k != "history"}, indent=2))
    return 0


def cmd_bench(args) -> int:
    import os
    import runpy

    # Explicit flag wins over any inherited env var (setdefault would make
    # --n dead whenever BENCH_N is exported in the shell).
    os.environ["BENCH_N"] = str(args.n)
    runpy.run_module("bench_torch", run_name="__main__")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ragfin_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("chunk", help="generate analysis chunks from quarterly JSON")
    p.add_argument("--data", default="extract_data")
    p.add_argument("--out", default="chunks.json")
    p.set_defaults(fn=cmd_chunk)

    p = sub.add_parser("build-index", help="chunk, embed, and persist the device index")
    p.add_argument("--data", default="extract_data")
    p.add_argument("--out", default=".ragfin_index")
    p.add_argument("--index-type", choices=["flat", "ivf"], default="flat",
                   help="flat = exact search; ivf = cluster-pruned (the reference's IVF_FLAT)")
    p.add_argument("--nprobe", type=int, default=32)
    p.add_argument("--cell", type=int, default=2048)
    p.set_defaults(fn=cmd_build_index)

    p = sub.add_parser("query", help="answer a question")
    p.add_argument("question", nargs="?", default=None)
    p.add_argument("--interactive", action="store_true",
                   help="canned smoke questions then a stdin loop (retrieve.py:104-111)")
    p.add_argument("--mode", choices=["vector", "graph", "hybrid"], default="vector")
    p.add_argument("--k", type=int, default=3)
    p.add_argument("--model", default="fake")
    p.add_argument("--data", default="extract_data")
    p.add_argument("--index", default=".ragfin_index")
    p.set_defaults(fn=cmd_query)

    p = sub.add_parser("eval", help="run retrieval evaluation")
    p.add_argument("--dataset", choices=["qa", "vector"], default="qa")
    p.add_argument("--path", default=None)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--min-recall", type=float, default=0.0)
    p.add_argument("--raw", action="store_true", help="bypass query filters/rerank (embedding-only ablation)")
    p.add_argument("--summary", default=None, help="write research-summary JSON here")
    p.add_argument("--data", default="extract_data")
    # Same default as `query`/`serve` so eval scores the index users
    # actually serve (pass --index "" to force a fresh default build).
    p.add_argument("--index", default=".ragfin_index")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("extract-pdf", help="extract text + line items from a PDF filing")
    p.add_argument("path")
    p.add_argument("--full-text", action="store_true")
    p.set_defaults(fn=cmd_extract_pdf)

    p = sub.add_parser("serve", help="start the service registry")
    p.add_argument("--model", default=None)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("train", help="contrastively fine-tune the embedder on labeled QA")
    p.add_argument("--data", default="extract_data")
    p.add_argument("--qa", default=None, help="labeled QA file")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--k", type=int, default=3)
    p.add_argument("--checkpoint-dir", default=None)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("bench", help="run the headline benchmark")
    p.add_argument("--n", type=int, default=1_000_000)
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
