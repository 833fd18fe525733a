"""The port's bag-encoder fine-tuning (models/finetune.py) and train-state
checkpoints (utils/checkpoint.py) against the JAX package's, on the CPU.

The corpus is 240 generated filings (``generate_distractors``, equal in
both packages) and a generated QA file over them: one question per chosen
filing, some with two gold chunks, some pairs of questions sharing a gold
chunk, so the distinct-query/document packing is exercised. The projection
table is 8,192 x 384 from ``init_table`` (bitwise JAX's draw).

Tolerances, measured before they were set: per-epoch loss within 1e-4
relative, accuracy equal; the tuned table within 5e-4 max abs after 12
epochs (the largest gap seen is 7.0e-5: ``embedding_bag``'s backward and
XLA's scatter-add sum in other orders, and Adam divides each element's step
by its own gradient scale, so a last-bit gap in a rarely hit row's gradient
becomes a gap in a step of size ~lr); recall and F1 before and after fine-tuning equal. A run
resumed from a checkpoint is bitwise equal to the run never interrupted.
"""

import json
import os

import numpy as np
import pytest
import torch

from ragfin_tpu.eval.datasets import load_qa_subset as j_load_qa
from ragfin_tpu.eval.distractors import generate_distractors as j_distractors
from ragfin_tpu.models import finetune as jf
from ragfin_tpu.models.bag_encoder import BagEncoder as JBag
from ragfin_tpu.models.featurizer import HashedFeaturizer as JFeat
from ragfin_tpu_torch.eval.datasets import load_qa_subset as t_load_qa
from ragfin_tpu_torch.eval.distractors import generate_distractors as t_distractors
from ragfin_tpu_torch.models import finetune as tf
from ragfin_tpu_torch.models import minilm as tm
from ragfin_tpu_torch.models import training as tt
from ragfin_tpu_torch.models.bag_encoder import BagEncoder as TBag
from ragfin_tpu_torch.models.featurizer import HashedFeaturizer as TFeat
from ragfin_tpu_torch.utils import checkpoint as ck

LOSS_RTOL = 1e-4
TABLE_TOL = 5e-4
VOCAB = 8192

TEMPLATES = {
    "profitability_analysis": "What was {bank}'s net profit in {q} {fy}?",
    "balance_sheet_analysis": "What were {bank}'s total customer deposits in {q} {fy}?",
    "financial_ratios": "What was the basic EPS of {bank} for {q} {fy}?",
    "segment_analysis": "How did {bank}'s treasury segment revenue do in {q} {fy}?",
}


def write_qa(path: str, chunks) -> str:
    """Questions over the generated filings: one per filing of the first
    160, every fifth with a second gold chunk, every seventh asked twice in
    other words (two questions, one gold chunk)."""
    questions = []
    for i, c in enumerate(chunks[:160]):
        q, fy = c.period.split("_")
        text = TEMPLATES[c.chunk_type].format(bank=c.company, q=q, fy=fy)
        gold = [c.id] + ([chunks[160 + i // 5].id] if i % 5 == 0 else [])
        questions.append({"id": f"g{i}", "category": c.chunk_type.split("_")[0], "question": text,
                          "expected_relevant_chunks": gold})
        if i % 7 == 0:
            questions.append({"id": f"g{i}b", "category": "other",
                              "question": f"{c.company} {c.chunk_type.replace('_', ' ')} {c.period}",
                              "expected_relevant_chunks": [c.id]})
    with open(path, "w") as f:
        json.dump({"questions": questions}, f)
    return path


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    j_chunks, t_chunks = j_distractors(240, seed=21), t_distractors(240, seed=21)
    assert [(c.id, c.text) for c in j_chunks] == [(c.id, c.text) for c in t_chunks]
    path = write_qa(str(tmp_path_factory.mktemp("qa") / "qa.json"), t_chunks)
    return j_chunks, t_chunks, j_load_qa(path), t_load_qa(path)


@pytest.fixture(scope="module")
def pairs(data):
    j_chunks, t_chunks, j_qs, t_qs = data
    return jf.PairDataset.from_eval_questions(j_qs, j_chunks), tf.PairDataset.from_eval_questions(t_qs, t_chunks)


def test_pair_dataset_equal(pairs):
    jp, tp = pairs
    assert len(tp) == len(jp) > 160
    assert (tp.queries, tp.documents) == (jp.queries, jp.documents)


def test_pair_dataset_skips_unknown_chunks(data):
    _, t_chunks, _, t_qs = data
    # g0 (gold: filings 0 and 160), g0b (filing 0), g1 (filing 1); only
    # filing 0 is in the corpus
    ds = tf.PairDataset.from_eval_questions(t_qs[:3], t_chunks[:1])
    assert ds.documents == [t_chunks[0].text] * 2 and ds.queries == [q.question for q in t_qs[:2]]


def test_epoch_batches_distinct_queries_and_documents(pairs):
    _, tp = pairs
    rng = np.random.default_rng(0)
    for _ in range(3):
        batches = tf.epoch_batches(tp, 16, rng)
        rows = np.concatenate(batches)
        assert len({tp.queries[i] for i in rows}) == len(rows)  # one row per question
        for b in batches:
            assert len(b) <= 16 and len({tp.documents[i] for i in b}) == len(b)


@pytest.fixture(scope="module")
def tuned(data, pairs, tmp_path_factory):
    j_chunks, t_chunks, _, _ = data
    jp, tp = pairs
    texts = [c.text for c in t_chunks]
    j_feat, t_feat = JFeat(vocab_size=VOCAB).fit(texts), TFeat(vocab_size=VOCAB).fit(texts)
    kw = dict(epochs=12, batch_size=16, learning_rate=3e-3, temperature=0.1, seed=4)
    j_enc, j_hist = jf.finetune_bag_encoder(jp, j_feat, JBag(vocab_size=VOCAB), **kw)
    ckpt = str(tmp_path_factory.mktemp("bag_ckpt"))
    base = TBag(vocab_size=VOCAB, device="cpu")
    t_enc, t_hist = tf.finetune_bag_encoder(tp, t_feat, base, checkpoint_dir=ckpt, **kw)
    return j_enc, j_hist, t_enc, t_hist, base, ckpt


def test_finetune_history_equal(tuned):
    _, j_hist, _, t_hist, _, _ = tuned
    assert len(t_hist) == len(j_hist) == 12
    for j, t in zip(j_hist, t_hist):
        assert t["epoch"] == j["epoch"] and t["accuracy"] == j["accuracy"]
        assert abs(t["loss"] - j["loss"]) <= LOSS_RTOL * abs(j["loss"]), (j, t)
    assert t_hist[-1]["loss"] < t_hist[0]["loss"]


def test_tuned_table_close(tuned):
    j_enc, _, t_enc, _, base, _ = tuned
    assert t_enc.tuned and t_enc.table.device.type == "cpu"
    got, want = t_enc.table.numpy(), np.asarray(j_enc.table)
    assert float(np.max(np.abs(got - want))) <= TABLE_TOL
    # the base encoder is not trained in place
    assert torch.equal(base.table, TBag(vocab_size=VOCAB, device="cpu").table)
    assert not np.array_equal(got, base.table.numpy())


def test_checkpoint_every_10_epochs(tuned):
    _, _, t_enc, _, _, ckpt = tuned
    assert sorted(os.listdir(ckpt)) == ["ckpt_00000010"]
    assert ck.latest_checkpoint(ckpt) == os.path.join(ckpt, "ckpt_00000010")
    payload = torch.load(os.path.join(ckpt, "ckpt_00000010", "state.pt"), weights_only=True)
    assert payload["params"].shape == (VOCAB, 384) and payload["scheduler"] is None


def test_empty_pairs_return_encoder_unchanged():
    enc = TBag(vocab_size=64, dim=8, device="cpu")
    out, hist = tf.finetune_bag_encoder(tf.PairDataset([], []), TFeat(vocab_size=64), enc)
    assert out is enc and hist == []


def test_finetune_and_evaluate_equal(data):
    j_chunks, t_chunks, j_qs, t_qs = data
    j = jf.finetune_and_evaluate(j_chunks, j_qs, k=3, epochs=3)
    t = tf.finetune_and_evaluate(t_chunks, t_qs, k=3, epochs=3, device="cpu")
    assert t["pairs"] == j["pairs"]
    assert t["before"] == j["before"] and t["after"] == j["after"]
    assert [h["accuracy"] for h in t["history"]] == [h["accuracy"] for h in j["history"]]
    assert t["after"]["recall"] > t["before"]["recall"]


def test_finetune_and_evaluate_needs_a_device_without_cuda(data):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    _, t_chunks, _, t_qs = data
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.finetune_and_evaluate(t_chunks, t_qs, epochs=1)


# --- save, latest, restore: a resumed run equals an uninterrupted one -----------


def _bag_run(batches, table, directory=None, split=None):
    opt = tt.AdamW(3e-3)
    step = tt.make_train_step(tt.bag_apply, opt, temperature=0.1)
    state = tt.init_train_state(table, opt)
    losses = []
    for n, batch in enumerate(batches):
        if split is not None and n == split:
            path = ck.save_train_state(directory, state)
            state = ck.restore_train_state(ck.latest_checkpoint(directory),
                                           tt.init_train_state(torch.zeros_like(table), opt))
            assert path.endswith(f"ckpt_{split:08d}") and state.step == split
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return state, losses


def _minilm_run(batches, sd, config, directory=None, split=None):
    def fresh(weights):
        model = tm.MiniLMEncoder(config)
        model.load_state_dict(weights)
        o = tt.AdamW(tt.warmup_cosine_decay_schedule(0.0, 1e-3, 2, len(batches)), weight_decay=0.01,
                     max_grad_norm=1.0)
        return tt.init_train_state(model, o), o

    state, opt = fresh(sd)
    step = tt.make_train_step(tm.minilm_apply, opt, temperature=0.05)
    losses = []
    for n, batch in enumerate(batches):
        if split is not None and n == split:
            ck.save_train_state(directory, state, step=n)
            blank = {k: torch.zeros_like(v) for k, v in sd.items()}
            state = ck.restore_train_state(ck.latest_checkpoint(directory), fresh(blank)[0])
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return state, losses


def _assert_states_equal(a, b):
    ta, tb_ = a.tensors(), b.tensors()
    assert all(torch.equal(x, y) for x, y in zip(ta, tb_))
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for key in sa["state"]:
        for name, value in sa["state"][key].items():
            assert torch.equal(value, sb["state"][key][name]), name
    assert a.step == b.step
    if a.scheduler is not None:
        assert a.scheduler.state_dict() == b.scheduler.state_dict()


def test_resumed_bag_run_is_bitwise_equal(tmp_path):
    rng = np.random.default_rng(6)
    table = torch.from_numpy(rng.standard_normal((512, 32)).astype(np.float32))
    batches = []
    for _ in range(8):
        ids = torch.from_numpy(rng.integers(0, 512, (6, 12)))
        w = torch.from_numpy(rng.uniform(0, 1, (6, 12)).astype(np.float32))
        batches.append({"query": {"ids": ids[:, :6], "weights": w[:, :6]}, "doc": {"ids": ids, "weights": w}})
    whole, l1 = _bag_run(batches, table)
    resumed, l2 = _bag_run(batches, table, str(tmp_path), split=5)
    assert l1 == l2
    _assert_states_equal(whole, resumed)


def test_resumed_minilm_run_with_schedule_is_bitwise_equal(tmp_path):
    config = tm.MiniLMConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                             intermediate_size=64, max_position=16)
    sd = tm.init_params(config, seed=1)
    rng = np.random.default_rng(8)
    batches = []
    for _ in range(6):
        side = {}
        for name, s in (("query", 8), ("doc", 16)):
            mask = (np.arange(s)[None, :] < rng.integers(2, s + 1, (4, 1))).astype(np.int64)
            side[name] = {"input_ids": torch.from_numpy(rng.integers(1, 64, (4, s)) * mask),
                          "attention_mask": torch.from_numpy(mask)}
        batches.append(side)
    whole, l1 = _minilm_run(batches, sd, config)
    resumed, l2 = _minilm_run(batches, sd, config, str(tmp_path), split=3)
    assert l1 == l2
    _assert_states_equal(whole, resumed)
    assert ck.latest_checkpoint(str(tmp_path)).endswith("ckpt_00000003")


def test_latest_checkpoint_orders_by_step(tmp_path):
    assert ck.latest_checkpoint(str(tmp_path / "missing")) is None
    assert ck.latest_checkpoint(str(tmp_path)) is None
    state = tt.init_train_state(torch.zeros(3), tt.AdamW(1e-3))
    for step in (10, 2, 100):
        ck.save_train_state(str(tmp_path), state, step=step)
    assert ck.latest_checkpoint(str(tmp_path)) == os.path.join(str(tmp_path), "ckpt_00000100")
