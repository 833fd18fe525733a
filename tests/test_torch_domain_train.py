"""The port's domain-encoder training and checkpoint writer
(models/domain_encoder.py, models/pairgen.py) against the JAX package's, on
the CPU, at the JAX tests' tiny size (``tests/test_domain_encoder.py``'s
``tiny_checkpoint``: 2 layers, vocabulary budget 2,048, 8 steps of 8 pairs).

- ``pairgen`` gives equal strings for equal seeds.
- A from-scratch run writes JAX's vocabulary and architecture (the draws of
  the initial weights differ on purpose, so only the vocabulary, the
  ``config.json`` arch, the ``params.npz`` keys, shapes and f16 dtype are
  compared) and its loss falls.
- Checkpoints cross-load both ways; embeddings of the same checkpoint agree
  within 1e-4 max abs at f32 activations and at cosine >= 0.999 per row in
  bf16 through each package's ``make_embedder("trained")``.
- A warm start from a JAX-written checkpoint sees equal batches in both
  packages; in bf16 each chunk's last and mean loss agree within 1e-2
  relative (the largest gap seen is 2.6e-3: XLA and torch round bf16
  activations at different places).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ragfin_tpu.models import domain_encoder as jd
from ragfin_tpu.models import minilm as jm
from ragfin_tpu.models import pairgen as jp
from ragfin_tpu.models.embedder import make_embedder as j_make_embedder
from ragfin_tpu_torch.models import domain_encoder as td
from ragfin_tpu_torch.models import minilm as tm
from ragfin_tpu_torch.models import pairgen as tp
from ragfin_tpu_torch.models.embedder import make_embedder as t_make_embedder

F32_TOL = 1e-4
BF16_COS = 0.999
WARM_RTOL = 1e-2
TINY = dict(steps=8, batch_size=8, num_layers=2, vocab_budget=2048, query_len=32, doc_len=64,
            scan_chunk=4, warmup=2)
TEXTS = [
    "ICICI net profit Q1 FY2024", "HDFC deposits", "What was the basic EPS of Axis Bank for Q3 FY2022?",
    "Retail banking segment revenue rose 12.5% YoY to ₹10,636 crore in the second quarter",
]


def quiet(*_a, **_k):
    pass


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_pairgen_equal(seed):
    for mode in ("scope", "quarter", "nobank"):
        a = jp.make_pair(np.random.default_rng(seed), mode)
        b = tp.make_pair(np.random.default_rng(seed), mode)
        assert a == b
    assert jp.pair_batch(np.random.default_rng(seed), 64) == tp.pair_batch(np.random.default_rng(seed), 64)
    assert jp.corpus_sample(40, seed=seed) == tp.corpus_sample(40, seed=seed)
    assert jp.hard_block(np.random.default_rng(seed)) == tp.hard_block(np.random.default_rng(seed))


def test_pairgen_module_constants_equal():
    assert tp.VOCAB_SEED_WORDS == jp.VOCAB_SEED_WORDS
    assert tp.fragment_queries() == jp.fragment_queries()


def test_fixed_len_equal():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 100, (3, 10)).astype(np.int32)
    mask = (ids > 10).astype(np.int32)
    for length in (4, 10, 16):
        a, b = jd._fixed_len(ids, mask, length), td._fixed_len(ids, mask, length)
        assert all(np.array_equal(x, y) for x, y in zip(a, b)) and a[0].shape == (3, length)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The JAX tests' tiny from-scratch run, in each package."""
    root = tmp_path_factory.mktemp("tiny")
    j_dir, t_dir = str(root / "jax"), str(root / "torch")
    j_res = jd.train_domain_encoder(ckpt_dir=j_dir, log=quiet, **TINY)
    t_res = td.train_domain_encoder(ckpt_dir=t_dir, log=quiet, device="cpu", **TINY)
    return j_dir, j_res, t_dir, t_res


def test_from_scratch_writes_jax_vocabulary_and_arch(tiny):
    j_dir, _, t_dir, _ = tiny
    with open(os.path.join(j_dir, "vocab.txt")) as a, open(os.path.join(t_dir, "vocab.txt")) as b:
        assert a.read() == b.read()
    j_spec, t_spec = (json.load(open(os.path.join(d, "config.json"))) for d in (j_dir, t_dir))
    assert t_spec["arch"] == j_spec["arch"] and t_spec["format"] == "ragfin-domain-encoder-v1"
    assert t_spec["collapse_numbers"] is True
    assert set(t_spec["meta"]) == set(j_spec["meta"]) and t_spec["meta"]["steps"] == 8
    assert t_spec["meta"]["platform"] == "cpu"
    with np.load(os.path.join(j_dir, "params.npz")) as a, np.load(os.path.join(t_dir, "params.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert b[k].shape == a[k].shape and b[k].dtype == np.float16 == a[k].dtype, k


def test_from_scratch_history_and_loss_falls(tiny):
    _, j_res, _, t_res = tiny
    assert [set(h) for h in t_res["history"]] == [set(h) for h in j_res["history"]]
    assert [h["step"] for h in t_res["history"]] == [4, 8]
    assert set(t_res) == set(j_res) | {"host_s"} and len(t_res["host_s"]) == 2
    hist = t_res["history"]
    assert hist[-1]["loss_mean"] < hist[0]["loss_mean"]


def test_flatten_params_inverts_params_from_flax():
    ckpt = td.DEFAULT_CKPT_DIR
    flax_params, _, _, _ = td.load_encoder_checkpoint(ckpt)
    sd = tm.params_from_flax(flax_params)
    flat = td._flatten_params(sd)
    with np.load(os.path.join(ckpt, "params.npz")) as archive:
        assert sorted(flat) == sorted(archive.files)
        for k in archive.files:
            assert np.array_equal(flat[k], archive[k].astype(np.float32)), k
    with pytest.raises(ValueError, match="mapped"):
        td._flatten_params({**sd, "extra.weight": torch.zeros(1)})


def _embed_f32(package, ckpt):
    if package == "jax":
        params, tok, cfg, _ = jd.load_encoder_checkpoint(ckpt)
        ids, mask = tok.encode_batch(TEXTS)
        model = jm.MiniLMEncoder(dataclasses.replace(cfg, dtype=jnp.float32))
        return np.asarray(model.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    params, tok, cfg, _ = td.load_encoder_checkpoint(ckpt)
    ids, mask = tok.encode_batch(TEXTS)
    model = tm.MiniLMEncoder(dataclasses.replace(cfg, dtype=torch.float32))
    model.load_state_dict(tm.params_from_flax(params))
    with torch.inference_mode():
        return model(torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_load(tiny, writer):
    j_dir, _, t_dir, _ = tiny
    ckpt = j_dir if writer == "jax" else t_dir
    j_params, j_tok, j_cfg, j_meta = jd.load_encoder_checkpoint(ckpt)
    t_params, t_tok, t_cfg, t_meta = td.load_encoder_checkpoint(ckpt)
    assert j_tok.vocab == t_tok.vocab and j_meta == t_meta
    assert (j_cfg.vocab_size, j_cfg.num_layers, j_cfg.max_position) == (
        t_cfg.vocab_size, t_cfg.num_layers, t_cfg.max_position)
    assert j_cfg.num_layers == 2 and j_meta["steps"] == 8
    e_j, e_t = _embed_f32("jax", ckpt), _embed_f32("torch", ckpt)
    assert float(np.max(np.abs(e_j - e_t))) <= F32_TOL
    b_j = j_make_embedder("trained", checkpoint=ckpt).encode_texts(TEXTS)
    b_t = t_make_embedder("trained", checkpoint=ckpt, device="cpu").encode_texts(TEXTS)
    assert b_t.shape == b_j.shape == (len(TEXTS), 384)
    assert float((b_j * b_t).sum(axis=1).min()) >= BF16_COS


def test_warm_start_from_jax_checkpoint_matches_jax(tiny, tmp_path):
    j_parent, _, _, _ = tiny
    kw = dict(steps=4, batch_size=8, scan_chunk=2, learning_rate=1e-3, warmup=1, log=quiet)
    j_res = jd.train_domain_encoder(ckpt_dir=str(tmp_path / "j"), init_from=j_parent, **kw)
    t_res = td.train_domain_encoder(ckpt_dir=str(tmp_path / "t"), init_from=j_parent, device="cpu", **kw)
    assert len(t_res["history"]) == len(j_res["history"]) == 2
    for j, t in zip(j_res["history"], t_res["history"]):
        assert t["step"] == j["step"]
        for key in ("loss", "loss_mean"):
            assert abs(t[key] - j[key]) <= WARM_RTOL * abs(j[key]), (key, j, t)
    # drop-in compatible: the parent's vocabulary and architecture
    _, p_tok, p_cfg, _ = jd.load_encoder_checkpoint(j_parent)
    _, c_tok, c_cfg, c_meta = jd.load_encoder_checkpoint(str(tmp_path / "t"))
    assert c_tok.vocab == p_tok.vocab and c_cfg == p_cfg
    assert c_meta["init_from"] == j_parent and c_meta["steps"] == 4


def test_warm_start_clamps_lengths_to_the_parent(tiny, tmp_path):
    _, _, t_parent, _ = tiny
    lines = []
    res = td.train_domain_encoder(steps=2, batch_size=4, scan_chunk=2, warmup=1, query_len=100,
                                  doc_len=500, ckpt_dir=str(tmp_path / "c"), init_from=t_parent,
                                  log=lines.append, device="cpu")
    assert any("lens q=64/d=64" in line for line in lines), lines
    assert np.isfinite(res["final_loss"])


def test_trainer_refuses_the_cpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        td.train_domain_encoder(steps=1, ckpt_dir=str(tmp_path / "x"), log=quiet)
    assert not (tmp_path / "x").exists()


def test_training_script_on_the_cpu(tmp_path):
    """scripts/train_encoder_torch.py with TRAIN_PLATFORM=cpu warm-starts
    from the committed checkpoint into CKPT_DIR and prints its result."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ckpt = tmp_path / "enc"
    env = {k: v for k, v in os.environ.items() if not k.startswith("RAGFIN_")}
    env.update(PYTHONPATH=root, TRAIN_PLATFORM="cpu", STEPS="2", BATCH="8", SCAN_CHUNK="1",
               CKPT_DIR=str(ckpt), INIT_FROM=td.DEFAULT_CKPT_DIR)
    out = subprocess.run([sys.executable, os.path.join(root, "scripts", "train_encoder_torch.py")],
                         cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = next(x for x in out.stdout.splitlines() if x.startswith("TRAIN_RESULT "))
    result = json.loads(line[len("TRAIN_RESULT "):])
    assert result["platform"] == "cpu" and result["steps"] == 2 and result["ckpt_dir"] == str(ckpt)
    assert sorted(os.listdir(ckpt)) == ["config.json", "params.npz", "vocab.txt"]
