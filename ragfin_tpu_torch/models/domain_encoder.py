"""Checkpoint reader for the trained in-domain encoder.

Counterpart of ``load_encoder_checkpoint``/``_unflatten_params`` in
``ragfin_tpu/models/domain_encoder.py``. The checkpoint directory
(``checkpoints/domain_encoder/``) is shared with the JAX package:
``config.json`` (architecture), ``vocab.txt`` (WordPiece vocabulary) and
``params.npz`` (f16 leaves keyed by Flax pytree path). Training is ROADMAP
Slice 5.
"""

from __future__ import annotations

import json
import os

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CKPT_DIR = os.environ.get(
    "RAGFIN_TRAINED_CHECKPOINT", os.path.join(_REPO_ROOT, "checkpoints", "domain_encoder")
)


def _unflatten_params(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(value, np.float32)
    return tree


def load_encoder_checkpoint(directory: str):
    """Returns (Flax-layout params as f32 numpy, tokenizer, MiniLMConfig,
    meta). Raises on any missing or invalid piece."""
    from .minilm import MiniLMConfig
    from .tokenizer import WordPieceTokenizer

    with open(os.path.join(directory, "config.json")) as f:
        spec = json.load(f)
    if spec.get("format") != "ragfin-domain-encoder-v1":
        raise ValueError(f"unknown checkpoint format in {directory}")
    arch = spec["arch"]
    config = MiniLMConfig(
        vocab_size=arch["vocab_size"],
        hidden_size=arch["hidden_size"],
        num_layers=arch["num_layers"],
        num_heads=arch["num_heads"],
        intermediate_size=arch["intermediate_size"],
        max_position=arch["max_position"],
        pooling=arch.get("pooling", "mean"),
    )
    with np.load(os.path.join(directory, "params.npz")) as archive:
        params = _unflatten_params({k: archive[k] for k in archive.files})
    tokenizer = WordPieceTokenizer.from_vocab_file(
        os.path.join(directory, "vocab.txt"),
        max_len=arch["max_position"],
        collapse_numbers=bool(spec.get("collapse_numbers", True)),
    )
    if tokenizer.vocab_size > config.vocab_size:
        raise ValueError(
            f"vocab.txt has {tokenizer.vocab_size} entries > embedding table {config.vocab_size}"
        )
    return params, tokenizer, config, spec.get("meta", {})
