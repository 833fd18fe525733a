"""Contrastive fine-tuning of the bag encoder on the labeled QA data.

Counterpart of ``ragfin_tpu/models/finetune.py``: (question ->
expected-chunk) pairs mined from a labeled QA file
(``expected_relevant_chunks``), InfoNCE steps (:mod:`.training`), a
checkpoint every 10 epochs (:mod:`..utils.checkpoint`), and retrieval
evaluated before and after through the same index pipeline. The batches are
the JAX package's: the same greedy packing drawn from the same numpy rng.
The tuned encoder carries its table (``BagEncoder(table=...)``, ``tuned``),
which index persistence writes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.models import IndexedChunk
from ..eval.datasets import EvalQuestion
from ..utils.device import DeviceLike, resolve_device
from .bag_encoder import BagEncoder
from .featurizer import HashedFeaturizer
from .training import AdamW, bag_apply, init_train_state, make_train_step


@dataclasses.dataclass
class PairDataset:
    """(query text, positive document text) pairs."""

    queries: list[str]
    documents: list[str]

    @classmethod
    def from_eval_questions(
        cls, questions: Sequence[EvalQuestion], chunks: Sequence[IndexedChunk]
    ) -> "PairDataset":
        by_id = {c.id: c for c in chunks}
        qs, ds = [], []
        for q in questions:
            for cid in q.expected_chunks:
                chunk = by_id.get(cid)
                if chunk is not None:
                    qs.append(q.question)
                    ds.append(chunk.text)
        return cls(qs, ds)

    def __len__(self) -> int:
        return len(self.queries)


def epoch_batches(pairs: PairDataset, batch_size: int, rng: np.random.Generator) -> list[np.ndarray]:
    """One epoch's batches of pair rows, as the JAX package draws them.

    InfoNCE's diagonal labels require every row in a batch to have a
    distinct query and a distinct document: multi-gold questions emit one
    row per (question, chunk), and two rows with the same question (or the
    same shared gold chunk) in one batch would teach the encoder that a
    relevant pair is a negative. So one random positive per question, then
    greedy packing in which neither queries nor documents repeat."""
    by_query: dict[str, list[int]] = {}
    for i, q in enumerate(pairs.queries):
        by_query.setdefault(q, []).append(i)
    picks = [rows[rng.integers(len(rows))] for rows in by_query.values()]
    rng.shuffle(picks)
    batches: list[list[int]] = []
    for i in picks:
        for b in batches:
            if len(b) < batch_size and all(
                pairs.documents[j] != pairs.documents[i] for j in b
            ):
                b.append(i)
                break
        else:
            batches.append([i])
    return [np.asarray(b) for b in batches]


def finetune_bag_encoder(
    pairs: PairDataset,
    featurizer: HashedFeaturizer,
    encoder: BagEncoder,
    epochs: int = 20,
    batch_size: int = 16,
    learning_rate: float = 3e-3,
    temperature: float = 0.1,
    seed: int = 0,
    checkpoint_dir: Optional[str] = None,
) -> tuple[BagEncoder, list[dict]]:
    """Tune the projection table on (question, chunk) pairs, on the
    encoder's device. Returns the tuned encoder and per-epoch metrics; the
    featurizer stays frozen and ``encoder`` is not changed."""
    if not len(pairs):
        return encoder, []
    dev = encoder.device
    q_ids, q_w = featurizer.encode_batch(pairs.queries)
    d_ids, d_w = featurizer.encode_batch(pairs.documents)
    q_ids, d_ids = (torch.from_numpy(np.asarray(a, np.int64)).to(dev) for a in (q_ids, d_ids))
    q_w, d_w = (torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in (q_w, d_w))

    # optax.adamw's default weight decay, 1e-4, as the JAX package relies on.
    optimizer = AdamW(learning_rate, weight_decay=1e-4)
    step = make_train_step(bag_apply, optimizer, temperature=temperature)
    state = init_train_state(encoder.table.float(), optimizer)

    rng = np.random.default_rng(seed)
    history = []
    for epoch in range(epochs):
        losses, accs = [], []
        for sel in epoch_batches(pairs, batch_size, rng):
            if len(sel) < 2:  # in-batch negatives need >= 2
                continue
            rows = torch.from_numpy(sel).to(dev)
            batch = {
                "query": {"ids": q_ids[rows], "weights": q_w[rows]},
                "doc": {"ids": d_ids[rows], "weights": d_w[rows]},
            }
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
            accs.append(metrics["accuracy"])
        loss = torch.stack(losses).double().cpu().numpy() if losses else []
        acc = torch.stack(accs).double().cpu().numpy() if accs else []
        history.append(
            {"epoch": epoch, "loss": float(np.mean(loss)) if len(loss) else 0.0,
             "accuracy": float(np.mean(acc)) if len(acc) else 0.0}
        )
        if checkpoint_dir and (epoch + 1) % 10 == 0:
            from ..utils.checkpoint import save_train_state

            save_train_state(checkpoint_dir, state, step=epoch + 1)

    tuned = BagEncoder(
        vocab_size=encoder.vocab_size, dim=encoder.dim, seed=encoder.seed,
        table=state.params.detach(), device=dev,
    )
    return tuned, history


def finetune_and_evaluate(
    chunks: Sequence[IndexedChunk],
    questions: Sequence[EvalQuestion],
    k: int = 3,
    device: DeviceLike = None,
    **kwargs,
) -> dict:
    """Full loop: baseline eval -> fine-tune -> re-eval (same index
    pipeline), on ``device`` (the card unless the caller asks for the CPU)."""
    from ..eval.harness import evaluate_retrieval
    from ..index.vector_index import DeviceVectorIndex

    dev = resolve_device(device)
    featurizer = HashedFeaturizer()
    featurizer.fit([c.text for c in chunks])
    base_encoder = BagEncoder(device=dev)
    base_index = DeviceVectorIndex.build(chunks, encoder=base_encoder, featurizer=featurizer, device=dev)
    before = evaluate_retrieval(base_index, questions, k=k).summary()
    del base_index

    pairs = PairDataset.from_eval_questions(questions, chunks)
    tuned, history = finetune_bag_encoder(pairs, featurizer, base_encoder, **kwargs)
    tuned_index = DeviceVectorIndex.build(chunks, encoder=tuned, featurizer=featurizer, device=dev)
    after = evaluate_retrieval(tuned_index, questions, k=k).summary()
    return {
        "pairs": len(pairs),
        "history": history,
        "before": {"recall": before["retrieval_recall"]["mean"], "f1": before["retrieval_f1"]["mean"]},
        "after": {"recall": after["retrieval_recall"]["mean"], "f1": after["retrieval_f1"]["mean"]},
    }
