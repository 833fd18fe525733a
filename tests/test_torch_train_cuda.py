"""Training on the card against the port on the CPU (card-only; these
import nothing of JAX, so they run on a machine with a card and no Flax).
chip_smoke.py's train phase makes the same checks at full width.

Tolerances: the bag fine-tune's first-epoch loss within 1e-4 relative
(``embedding_bag``'s backward on CUDA sums with atomics, in no fixed
order); the domain encoder's first-chunk loss within 5e-3 (bf16 products
rounded at other places by cuBLAS and the CPU's GEMMs).
"""

import numpy as np
import pytest
import torch

from ragfin_tpu_torch.eval.datasets import EvalQuestion
from ragfin_tpu_torch.eval.distractors import generate_distractors
from ragfin_tpu_torch.models import domain_encoder as td
from ragfin_tpu_torch.models import finetune as tf
from ragfin_tpu_torch.models.bag_encoder import BagEncoder
from ragfin_tpu_torch.models.featurizer import HashedFeaturizer

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; training on the CPU is checked against JAX elsewhere")


def test_bag_first_epoch_on_card_matches_cpu():
    chunks = generate_distractors(200, seed=3)
    qs = [EvalQuestion(id=f"q{i}", category="x", question=f"{c.company} {c.chunk_type} {c.period}",
                       expected_chunks=[c.id]) for i, c in enumerate(chunks[:64])]
    pairs = tf.PairDataset.from_eval_questions(qs, chunks)
    feat = HashedFeaturizer(vocab_size=8192).fit([c.text for c in chunks])
    card, cpu = (tf.finetune_bag_encoder(pairs, feat, BagEncoder(vocab_size=8192, device=d), epochs=1)[1][0]
                 for d in ("cuda", "cpu"))
    assert abs(card["loss"] - cpu["loss"]) <= 1e-4 * abs(cpu["loss"])
    assert card["accuracy"] == cpu["accuracy"]


def test_domain_warm_start_on_card_matches_cpu(tmp_path):
    kw = dict(steps=2, batch_size=8, scan_chunk=1, learning_rate=1e-3, warmup=1,
              init_from=td.DEFAULT_CKPT_DIR, log=lambda *a, **k: None)
    cpu = td.train_domain_encoder(ckpt_dir=str(tmp_path / "cpu"), device="cpu", **kw)
    card = td.train_domain_encoder(ckpt_dir=str(tmp_path / "card"), device="cuda", **kw)
    assert abs(card["history"][0]["loss"] - cpu["history"][0]["loss"]) <= 5e-3
    assert np.isfinite(card["final_loss"])
