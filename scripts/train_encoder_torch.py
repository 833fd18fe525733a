"""Train the in-domain semantic encoder with the PyTorch port, on the CUDA card.

Usage:
    [TRAIN_PLATFORM=cuda|cpu] [STEPS=2000] [BATCH=256] [LAYERS=4] [LR=3e-4]
    [SCAN_CHUNK=25] [SEED=0] [CKPT_DIR=build/domain_encoder_torch]
    [INIT_FROM=checkpoints/domain_encoder] [REFERENCE_ROOT=<reference repo>]
    python scripts/train_encoder_torch.py

The counterpart of ``scripts/train_encoder.py``, driven by the same
environment variables. ``TRAIN_PLATFORM=cpu`` runs on the CPU; anything
else runs on the card and fails without one. The checkpoint is written in
the format both packages load (``config.json``, ``vocab.txt``,
``params.npz``); unlike the JAX script, the default ``CKPT_DIR`` is under
the gitignored ``build/``, never the committed ``checkpoints/``: point the
served ``trained`` backend at it with ``RAGFIN_TRAINED_CHECKPOINT``.
``INIT_FROM`` warm-starts from an existing checkpoint (its vocabulary and
architecture are kept). ``REFERENCE_ROOT``, when given and not warm
starting, adds the reference repository's chunk texts, QA question texts
and filing PDFs to the vocabulary corpus, as the JAX script does.
"""

import glob
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def vocab_texts(ref: str) -> list[str]:
    """Chunk texts, QA question texts and English-looking PDF lines of the
    reference repository at ``ref`` (what exists of them)."""
    texts: list[str] = []
    data_dir = os.path.join(ref, "extract_data")
    if os.path.isdir(data_dir):
        from ragfin_tpu_torch.data.loader import build_corpus

        texts += [c.text for c in build_corpus(data_dir)]
    qa_path = os.path.join(ref, "qa_subset.json")
    if os.path.exists(qa_path):
        from ragfin_tpu_torch.eval.datasets import load_qa_subset

        texts += [q.question for q in load_qa_subset(qa_path)]
    from ragfin_tpu_torch.data.pdf_extractor import extract_text

    for pdf in sorted(glob.glob(os.path.join(ref, "FinRag_Parameter_Extractor", "*", "*.pdf"))):
        try:
            txt = extract_text(pdf)
        except Exception as e:  # a PDF the extractor cannot read adds nothing
            print(f"skipping {pdf}: {e}", file=sys.stderr)
            continue
        # Keep only lines that read as English (some PDFs decode to glyphs).
        lines = []
        for line in txt.split("\n"):
            words = line.split()
            alpha = [w for w in words if re.fullmatch(r"[A-Za-z][A-Za-z'&.-]*", w)]
            if len(words) >= 3 and len(alpha) >= 0.7 * len(words):
                lines.append(line)
        if len(lines) >= 50:
            texts.append("\n".join(lines))
    return texts


def main() -> int:
    from ragfin_tpu_torch.models.domain_encoder import train_domain_encoder
    from ragfin_tpu_torch.utils.device import resolve_device

    device = resolve_device("cpu" if os.environ.get("TRAIN_PLATFORM") == "cpu" else None)
    init_from = os.environ.get("INIT_FROM") or None
    ref = os.environ.get("REFERENCE_ROOT")
    # A warm start reuses the parent vocabulary: no vocabulary texts needed.
    extra = vocab_texts(ref) if ref and not init_from else []
    t0 = time.time()
    result = train_domain_encoder(
        steps=int(os.environ.get("STEPS", 2000)),
        batch_size=int(os.environ.get("BATCH", 256)),
        num_layers=int(os.environ.get("LAYERS", 4)),
        learning_rate=float(os.environ.get("LR", 3e-4)),
        scan_chunk=int(os.environ.get("SCAN_CHUNK", 25)),
        seed=int(os.environ.get("SEED", 0)),
        ckpt_dir=os.environ.get("CKPT_DIR", os.path.join(ROOT, "build", "domain_encoder_torch")),
        vocab_extra_texts=extra,
        init_from=init_from,
        device=device,
    )
    result["platform"] = device.type
    result["total_wall_s"] = round(time.time() - t0, 1)
    print("TRAIN_RESULT " + json.dumps({k: v for k, v in result.items() if k not in ("history", "host_s")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
