"""The in-domain semantic encoder: training and checkpoint IO.

Counterpart of ``ragfin_tpu/models/domain_encoder.py``. A MiniLM-architecture
encoder (:mod:`.minilm`) with a domain-learned WordPiece vocabulary is
trained from scratch, or warm-started from a checkpoint, with symmetric
InfoNCE over generated (query, document) pairs (:mod:`.pairgen`).

The checkpoint format is the JAX package's, and either package loads what
the other writes: ``config.json`` (format ``ragfin-domain-encoder-v1``:
architecture, tokenizer flags, training metadata), ``vocab.txt`` (the
WordPiece vocabulary) and ``params.npz`` (f16 leaves keyed by Flax pytree
path, ``params/layer_i/attention/query/kernel`` and so on, Dense kernels
``[in, out]``). The committed one is ``checkpoints/domain_encoder/``.

Training runs on the card unless the caller asks for the CPU. Where JAX runs
``scan_chunk`` steps as one ``lax.scan`` program, the port runs a plain loop
over the same chunk of host batches and reads the metrics back once per
chunk. Parameters and optimizer state stay f32; activations run in
``MiniLMConfig.dtype`` (bf16), the encoder casting its weights at each call.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

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


def _flatten_params(state_dict: dict) -> dict[str, np.ndarray]:
    """A :class:`~.minilm.MiniLMEncoder` ``state_dict`` as the JAX package
    flattens its Flax tree: the inverse of :func:`.minilm.params_from_flax`
    (``Linear.weight [out, in]`` back to ``kernel [in, out]``, LayerNorm
    ``weight`` to ``scale``), keyed ``params/<module>/.../<leaf>``."""
    from .minilm import _FLAX_LINEARS, _FLAX_NORMS

    sd = {k: v.detach().float().cpu().numpy() for k, v in state_dict.items()}
    flat = {}
    for table in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        flat[f"params/{table}/embedding"] = sd[f"{table}.weight"]
    flat["params/embeddings_norm/scale"] = sd["embeddings_norm.weight"]
    flat["params/embeddings_norm/bias"] = sd["embeddings_norm.bias"]
    i = 0
    while f"layers.{i}.ffn_norm.weight" in sd:
        for flax_path, name in _FLAX_LINEARS.items():
            flat[f"params/layer_{i}/{flax_path}/kernel"] = np.ascontiguousarray(
                sd[f"layers.{i}.{name}.weight"].T
            )
            flat[f"params/layer_{i}/{flax_path}/bias"] = sd[f"layers.{i}.{name}.bias"]
        for norm in _FLAX_NORMS:
            flat[f"params/layer_{i}/{norm}/scale"] = sd[f"layers.{i}.{norm}.weight"]
            flat[f"params/layer_{i}/{norm}/bias"] = sd[f"layers.{i}.{norm}.bias"]
        i += 1
    if len(flat) != len(sd):
        raise ValueError(f"state_dict has {len(sd)} entries, {len(flat)} mapped to Flax paths")
    return flat


def save_encoder_checkpoint(
    directory: str, params: dict, vocab: dict[str, int], config, meta: Optional[dict] = None
) -> str:
    """Write ``params`` (a MiniLMEncoder ``state_dict``) with its vocabulary
    and architecture in the format both packages load."""
    from .tokenizer import WordPieceTokenizer

    os.makedirs(directory, exist_ok=True)
    flat = _flatten_params(params)
    np.savez_compressed(
        os.path.join(directory, "params.npz"),
        **{k: v.astype(np.float16) for k, v in flat.items()},
    )
    WordPieceTokenizer(vocab=vocab).save_vocab(os.path.join(directory, "vocab.txt"))
    arch = {
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "num_layers": config.num_layers,
        "num_heads": config.num_heads,
        "intermediate_size": config.intermediate_size,
        "max_position": config.max_position,
        "pooling": config.pooling,
    }
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(
            {"format": "ragfin-domain-encoder-v1", "arch": arch,
             "collapse_numbers": True, "meta": meta or {}},
            f, indent=2,
        )
    return directory


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


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _fixed_len(ids: np.ndarray, mask: np.ndarray, length: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad/trim a tokenized batch to an exact length (one shape per side)."""
    b, s = ids.shape
    if s >= length:
        return ids[:, :length], mask[:, :length]
    pad = length - s
    return (
        np.pad(ids, ((0, 0), (0, pad))),
        np.pad(mask, ((0, 0), (0, pad))),
    )


def train_domain_encoder(
    steps: int = 2000,
    batch_size: int = 256,
    num_layers: int = 4,
    vocab_budget: int = 8192,
    query_len: int = 64,
    doc_len: int = 192,
    learning_rate: float = 3e-4,
    warmup: int = 100,
    temperature: float = 0.05,
    scan_chunk: int = 25,
    seed: int = 0,
    ckpt_dir: str = DEFAULT_CKPT_DIR,
    vocab_extra_texts: Optional[list[str]] = None,
    save_every_chunks: int = 8,
    init_from: Optional[str] = None,
    log=print,
    device: DeviceLike = None,
) -> dict:
    """Train the domain encoder and write the checkpoint. Returns metrics:
    the JAX package's keys, plus ``host_s`` (seconds spent making each
    chunk's batches on the host, which ``chunk_s`` excludes).

    ``init_from``: warm-start from an existing checkpoint directory. Its
    vocabulary, tokenizer, architecture and parameters are reused as they
    are (``num_layers``, ``vocab_budget`` and ``vocab_extra_texts`` are
    ignored), and the sequence lengths are clamped to its position table.
    """
    from .minilm import MiniLMConfig, MiniLMEncoder, init_params, minilm_apply, params_from_flax
    from .pairgen import corpus_sample, pair_batch
    from .tokenizer import WordPieceTokenizer, build_wordpiece_vocab
    from .training import AdamW, init_train_state, make_train_step, warmup_cosine_decay_schedule

    dev = resolve_device(device)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)

    if init_from is not None:
        # Warm start: vocabulary, architecture and params all come from the
        # parent checkpoint, so the result is drop-in compatible.
        flax_params, tokenizer, config, parent_meta = load_encoder_checkpoint(init_from)
        params = params_from_flax(flax_params)
        vocab = tokenizer.vocab
        # Sequences must fit the parent's position table: longer inputs
        # would index past it.
        query_len = min(query_len, config.max_position)
        doc_len = min(doc_len, config.max_position)
        log(
            f"[{time.perf_counter()-t0:6.1f}s] warm start from {init_from}: "
            f"{len(vocab)} tokens, parent steps={parent_meta.get('steps')}, "
            f"lens q={query_len}/d={doc_len}"
        )
    else:
        # The domain vocabulary from a generated corpus sample (plus the
        # production chunk texts when given).
        vocab_texts = corpus_sample(4000, seed=seed)
        if vocab_extra_texts:
            vocab_texts = vocab_texts + list(vocab_extra_texts)
        vocab = build_wordpiece_vocab(vocab_texts, vocab_size=vocab_budget)
        # The embedding table rounded up to a multiple of 128 rows.
        table_size = -(-len(vocab) // 128) * 128
        tokenizer = WordPieceTokenizer(vocab=vocab, max_len=doc_len, collapse_numbers=True)
        log(f"[{time.perf_counter()-t0:6.1f}s] vocab: {len(vocab)} tokens (table {table_size})")
        config = MiniLMConfig(
            vocab_size=table_size,
            num_layers=num_layers,
            max_position=max(doc_len, query_len),
        )
        params = init_params(config, seed=seed)
    model = MiniLMEncoder(config)
    model.load_state_dict(params)
    model.to(dev).train()
    n_params = sum(p.numel() for p in model.parameters())
    log(
        f"[{time.perf_counter()-t0:6.1f}s] model: {config.num_layers} layers, "
        f"{n_params/1e6:.1f}M params"
    )

    warmup = min(warmup, max(1, steps // 10))  # the decay span must stay positive
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=learning_rate, warmup_steps=warmup, decay_steps=steps
    )
    # optax.chain(clip_by_global_norm(1.0), adamw(schedule, weight_decay=0.01))
    optimizer = AdamW(schedule, weight_decay=0.01, max_grad_norm=1.0)
    step_fn = make_train_step(minilm_apply, optimizer, temperature=temperature)
    state = init_train_state(model, optimizer)

    def host_batches(k: int) -> list[dict]:
        """k tokenized batches: [B, S] int64 ids and masks on the device."""
        out = []
        for _ in range(k):
            queries, docs = pair_batch(rng, batch_size)
            batch = {}
            for side, texts, length in (("query", queries, query_len), ("doc", docs, doc_len)):
                ids, mask = _fixed_len(*tokenizer.encode_batch(texts), length)
                batch[side] = {"input_ids": torch.from_numpy(ids.astype(np.int64)).to(dev),
                               "attention_mask": torch.from_numpy(mask.astype(np.int64)).to(dev)}
            out.append(batch)
        return out

    history: list[dict] = []
    host_s: list[float] = []
    done = 0
    chunk_idx = 0
    while done < steps:
        k = min(scan_chunk, steps - done)
        t_batches = time.perf_counter()
        batches = host_batches(k)
        t_host = time.perf_counter()
        host_s.append(t_host - t_batches)
        losses, accs = [], []
        for batch in batches:
            state, metrics = step_fn(state, batch)
            losses.append(metrics["loss"])
            accs.append(metrics["accuracy"])
        loss = torch.stack(losses).cpu().numpy()
        acc = torch.stack(accs).cpu().numpy()
        done += k
        chunk_idx += 1
        record = {
            "step": done,
            "loss": float(loss[-1]),
            "loss_mean": float(loss.mean()),
            "accuracy": float(acc[-1]),
            "chunk_s": round(time.perf_counter() - t_host, 2),
        }
        history.append(record)
        log(
            f"[{time.perf_counter()-t0:6.1f}s] step {done}/{steps} "
            f"loss {record['loss']:.4f} acc {record['accuracy']:.3f} "
            f"({record['chunk_s']}s/chunk)"
        )
        if chunk_idx % save_every_chunks == 0 or done >= steps:
            meta = {
                "steps": done,
                "init_from": init_from,
                "batch_size": batch_size,
                "final_loss": record["loss"],
                "final_accuracy": record["accuracy"],
                "seed": seed,
                "platform": dev.type,
                "wall_s": round(time.perf_counter() - t0, 1),
                "history_tail": history[-4:],
            }
            save_encoder_checkpoint(ckpt_dir, model.state_dict(), vocab, config, meta)
            log(f"[{time.perf_counter()-t0:6.1f}s] checkpoint -> {ckpt_dir} (step {done})")

    return {
        "ckpt_dir": ckpt_dir,
        "steps": steps,
        "history": history,
        "final_loss": history[-1]["loss"] if history else None,
        "final_accuracy": history[-1]["accuracy"] if history else None,
        "wall_s": round(time.perf_counter() - t0, 1),
        "host_s": host_s,
    }
