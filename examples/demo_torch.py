"""End-to-end offline demo of the PyTorch port: build -> search -> graph -> hybrid -> eval.

Counterpart of examples/demo.py: five canned vector questions, a rule-based
knowledge-graph build, four graph-strategy questions, one hybrid query and
a recall@10 gate, deterministic and offline (rule-based extraction,
extractive answers) on the device indexes.

    python3 examples/demo_torch.py [--data <extract_data dir>]

Without ``--data`` it writes a generated ``extract_data`` tree
(``write_extract_data``, seed 0) into a temporary directory. Step 6 scores
REFERENCE_ROOT's ``qa_subset.json`` when it is set, else the holdout
phrasings shipped in the package. It runs on the CUDA card;
RAGFIN_DEVICE=cpu runs it on the CPU.
"""

import argparse
import asyncio
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", default=None,
                        help="an extract_data tree (default: a generated one, seed 0)")
    args = parser.parse_args()

    from ragfin_tpu_torch.data.loader import build_corpus
    from ragfin_tpu_torch.eval.datasets import load_holdout_phrasings, load_qa_subset
    from ragfin_tpu_torch.eval.harness import evaluate_retrieval
    from ragfin_tpu_torch.eval.statements import write_extract_data
    from ragfin_tpu_torch.index.graph_index import GraphIndex
    from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex
    from ragfin_tpu_torch.retrieval.graph_rag import GraphBuilder
    from ragfin_tpu_torch.retrieval.hybrid import HybridRAG
    from ragfin_tpu_torch.retrieval.vector_rag import VectorRAG
    from ragfin_tpu_torch.utils.device import resolve_device

    device = resolve_device(os.environ.get("RAGFIN_DEVICE") or None)

    print(f"=== 1. chunk + build device index ({device}) ===")
    if args.data:
        chunks = build_corpus(args.data)
    else:
        with tempfile.TemporaryDirectory(prefix="ragfin_demo_") as tmp:
            chunks = build_corpus(write_extract_data(tmp, seed=0))
    index = DeviceVectorIndex.build(chunks, device=device)
    print(f"indexed {len(index)} chunks, dim={index.dim}")

    print("\n=== 2. vector search (the reference's retrieve.py test set) ===")
    rag = VectorRAG(index)
    for question in [
        "What was ICICI Bank's net profit in Q1 FY2024?",
        "What was the operating margin for Q2 FY2024?",
        "How did retail banking perform in Q3 FY2024?",
        "What was the EPS for Q4 FY2024?",
        "What were the total assets in Q3 FY2024?",
    ]:
        hits = rag.search(question, top_k=3)
        print(f"Q: {question}")
        print(f"   -> {hits[0]['id']}  (score {hits[0]['score']:.3f})")

    print("\n=== 3. knowledge graph build (rule-based, no LLM) ===")
    builder = GraphBuilder(GraphIndex(device=device))
    result = builder.build_from_vector_index(index)
    print(f"processed {result['chunks_processed']} chunks, "
          f"{result['total_entities_created']} facts")
    print(json.dumps({k: v for k, v in builder.get_stats().items() if k.endswith("_count")}))

    print("\n=== 4. graph strategy search (the reference's graphretrieve.py set) ===")
    hybrid = HybridRAG(index, builder.graph)
    for question in [
        "How did ICICI's net profit change from Q1 to Q4 FY2024?",
        "Which business segment drove growth in Q3?",
        "How did treasury margins evolve across quarters?",
        "What was retail banking revenue in Q2?",
    ]:
        out = asyncio.run(hybrid.graph_search(question))
        print(f"Q: {question}")
        print(f"   strategy={out['strategy']}  results={len(out['results'])}")

    print("\n=== 5. hybrid retrieval ===")
    out = hybrid.hybrid_query_simple("How did ICICI's net profit change from Q1 to Q4 FY2024?")
    for c in out["chunks"][:5]:
        print(f"   [{c['source']}] {c['id']}  score={c['score']:.3f}")

    ref = os.environ.get("REFERENCE_ROOT")
    qa_path = os.path.join(ref, "qa_subset.json") if ref else None
    if qa_path and os.path.exists(qa_path):
        name, questions = "qa_subset.json", load_qa_subset(qa_path)
    else:
        name, questions = "holdout phrasings (REFERENCE_ROOT not set)", load_holdout_phrasings()
    print(f"\n=== 6. recall@10 ({name}) ===")
    s = evaluate_retrieval(index, questions, k=10).summary()
    print(f"recall@10 = {s['retrieval_recall']['mean']:.3f} "
          f"({s['perfect_retrievals']}/{s['questions_evaluated']} perfect)")


if __name__ == "__main__":
    main()
