"""The ``minilm`` backend: HF-layout checkpoints, the port's safetensors
reader and writer, ``load_hf_weights`` and ``MiniLMEmbedder`` against the
JAX package (Flax forward), on the CPU.

The checkpoints are synthetic: seeded weights (``init_params``) written in
the HF BERT layout as ``model.safetensors`` and ``pytorch_model.bin`` with a
generated ``vocab.txt``; nothing is downloaded. The forward in bf16 is held
to Flax by per-row cosine >= 0.999 (the two round at different places, see
``tests/test_torch_minilm.py``); loaded weights must be equal.
"""

import dataclasses
import os

import numpy as np
import pytest
import safetensors.numpy as stn
import torch

import jax.numpy as jnp

from ragfin_tpu.models import minilm as jm
from ragfin_tpu.models.embedder import MiniLMEmbedder as JMiniLM
from ragfin_tpu_torch.eval.distractors import generate_distractors
from ragfin_tpu_torch.models import minilm as tm
from ragfin_tpu_torch.models.embedder import MiniLMEmbedder as TMiniLM
from ragfin_tpu_torch.models.embedder import make_embedder
from ragfin_tpu_torch.models.tokenizer import WordPieceTokenizer
from ragfin_tpu_torch.utils.synthetic import wordpiece_vocab

COS = 0.999
SMALL = dict(vocab_size=600, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_position=64)
TEXTS = [c.text[:300] for c in generate_distractors(10, seed=4)] + [
    "What was HDFC Bank's net profit in Q2 FY2027?",
    "total customer deposits",
    "x",
]
WORDS = sorted({w.strip(".,?':;()%") for t in TEXTS for w in t.lower().split()} - {""})


def _min_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)).min())


@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("small_hf"))
    sd = tm.init_params(tm.MiniLMConfig(**SMALL), seed=3)
    tm.save_hf_weights(path, sd, vocab=wordpiece_vocab(WORDS, SMALL["vocab_size"]))
    return path, sd


@pytest.fixture(scope="module")
def full_ckpt(tmp_path_factory):
    """The public all-MiniLM-L6-v2 widths, safetensors only."""
    path = str(tmp_path_factory.mktemp("full_hf"))
    sd = tm.init_params(tm.MiniLMConfig(), seed=1)
    tm.save_hf_weights(path, sd, vocab=wordpiece_vocab(WORDS), formats=("safetensors",))
    return path


def test_config_defaults_are_minilm_l6_and_equal_jax():
    t, j = tm.MiniLMConfig(), jm.MiniLMConfig()
    assert (t.num_layers, t.hidden_size, t.num_heads, t.intermediate_size, t.vocab_size,
            t.max_position) == (6, 384, 12, 1536, 30522, 512)
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size",
              "max_position", "type_vocab_size", "layer_norm_eps", "pooling"):
        assert getattr(t, f) == getattr(j, f), f


def test_safetensors_reader_equals_the_package(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {
        "f32": rng.standard_normal((5, 7)).astype(np.float32),
        "f16": rng.standard_normal((3,)).astype(np.float16),
        "f64": rng.standard_normal((2, 2)),
        "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
        "i8": np.array([-3, 4], np.int8),
        "empty": np.zeros((0, 4), np.float32),
    }
    stn.save_file(arrays, str(tmp_path / "a.safetensors"), metadata={"format": "pt"})
    ref = stn.load_file(str(tmp_path / "a.safetensors"))
    got = tm.read_safetensors(str(tmp_path / "a.safetensors"))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
    # And the port's writer reads back in the package.
    tm.write_safetensors(str(tmp_path / "b.safetensors"), arrays)
    back = stn.load_file(str(tmp_path / "b.safetensors"))
    for k in arrays:
        assert back[k].dtype == arrays[k].dtype and np.array_equal(back[k], arrays[k]), k


def test_safetensors_reader_rejects_a_truncated_file(tmp_path):
    tm.write_safetensors(str(tmp_path / "a.safetensors"),
                         {"w": np.ones((64, 64), np.float32)})
    raw = (tmp_path / "a.safetensors").read_bytes()
    (tmp_path / "b.safetensors").write_bytes(raw[: len(raw) - 100])
    with pytest.raises(ValueError):
        tm.read_safetensors(str(tmp_path / "b.safetensors"))


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_load_hf_weights_equals_jax_and_forward_matches_flax(small_ckpt, tmp_path, fmt):
    src, sd = small_ckpt
    path = str(tmp_path)
    tm.save_hf_weights(path, sd, formats=(fmt,))
    t_cfg, j_cfg = tm.MiniLMConfig(**SMALL), jm.MiniLMConfig(**SMALL)
    got = tm.load_hf_weights(path, t_cfg)
    ref = jm.load_hf_weights(path, j_cfg)
    assert set(got) == set(tm.MiniLMEncoder(t_cfg).state_dict())
    for name, t in sd.items():
        assert torch.equal(got[name], t), name
    # Linear weights stay [out, in]: the Flax kernel is their transpose.
    np.testing.assert_array_equal(
        got["layers.1.intermediate.weight"].numpy(),
        np.asarray(ref["params"]["layer_1"]["intermediate"]["kernel"]).T,
    )
    tok = WordPieceTokenizer.find_checkpoint_vocab(src, max_len=48)
    ids, mask = tok.encode_batch(TEXTS)
    flax = np.asarray(jm.MiniLMEncoder(j_cfg).apply(ref, jnp.asarray(ids), jnp.asarray(mask)))
    model = tm.MiniLMEncoder(t_cfg)
    model.load_state_dict(got)
    with torch.inference_mode():
        port = model.eval()(torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask)).numpy()
        side = {"input_ids": torch.from_numpy(ids.astype(np.int64)),
                "attention_mask": torch.from_numpy(mask)}
        assert np.array_equal(tm.minilm_apply(model, side).numpy(), port)
    assert _min_cos(port, flax) >= COS
    f32 = tm.MiniLMEncoder(dataclasses.replace(t_cfg, dtype=torch.float32))
    f32.load_state_dict(got)
    flax32 = jm.MiniLMEncoder(dataclasses.replace(j_cfg, dtype=jnp.float32)).apply(ref, ids, mask)
    with torch.inference_mode():
        out32 = f32.eval()(torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask))
    assert np.abs(out32.numpy() - np.asarray(flax32)).max() <= 1e-4


def test_load_hf_weights_takes_a_bert_prefix_and_names_a_missing_tensor(small_ckpt, tmp_path):
    _, sd = small_ckpt
    tm.save_hf_weights(str(tmp_path), sd, formats=("bin",))
    state = torch.load(str(tmp_path / "pytorch_model.bin"), weights_only=True)
    torch.save({"bert." + k: v for k, v in state.items()}, str(tmp_path / "pytorch_model.bin"))
    got = tm.load_hf_weights(str(tmp_path), tm.MiniLMConfig(**SMALL))
    assert torch.equal(got["word_embeddings.weight"], sd["word_embeddings.weight"])
    state.pop("encoder.layer.1.output.dense.bias")
    torch.save(state, str(tmp_path / "pytorch_model.bin"))
    with pytest.raises(KeyError, match="encoder.layer.1.output.dense.bias"):
        tm.load_hf_weights(str(tmp_path), tm.MiniLMConfig(**SMALL))
    with pytest.raises(FileNotFoundError):
        tm.load_hf_weights(str(tmp_path / "nowhere"))


def test_init_params_is_seeded_and_shaped():
    cfg = tm.MiniLMConfig(**SMALL)
    a, b, c = tm.init_params(cfg, 0), tm.init_params(cfg, 0), tm.init_params(cfg, 1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.0.attention.query.weight"], c["layers.0.attention.query.weight"])
    w = a["layers.0.intermediate.weight"]  # [out, in], truncated at 2 sigma
    assert w.shape == (128, 64) and float(w.abs().max()) <= 2 / np.sqrt(64) / 0.8796 + 1e-6
    assert torch.all(a["layers.1.ffn_norm.weight"] == 1) and torch.all(a["layers.1.ffn_norm.bias"] == 0)


def test_minilm_embedder_matches_flax_embedder(full_ckpt):
    t = TMiniLM(checkpoint=full_ckpt, device="cpu")
    j = JMiniLM(checkpoint=full_ckpt)
    assert t.pretrained and j.pretrained
    assert t.state_dict() == j.state_dict() == {
        "backend": "minilm", "checkpoint": full_ckpt, "pretrained": True}
    got, ref = t.encode_texts(TEXTS), np.asarray(j.encode_texts(TEXTS))
    assert got.shape == ref.shape == (len(TEXTS), 384) and got.dtype == np.float32
    assert _min_cos(got, ref) >= COS
    emb = make_embedder("minilm", checkpoint=full_ckpt, batch_size=4, device="cpu")
    assert emb.pretrained and _min_cos(emb.encode_texts(TEXTS), got) >= COS


def test_random_init_fallback_reports_not_pretrained(full_ckpt, tmp_path):
    os.makedirs(tmp_path / "no_vocab")
    os.link(os.path.join(full_ckpt, "model.safetensors"),
            tmp_path / "no_vocab" / "model.safetensors")
    os.makedirs(tmp_path / "truncated")
    raw = open(os.path.join(full_ckpt, "model.safetensors"), "rb").read()
    (tmp_path / "truncated" / "model.safetensors").write_bytes(raw[: len(raw) // 2])
    (tmp_path / "truncated" / "vocab.txt").write_text("[PAD]\n[UNK]\n")
    for ckpt in (None, str(tmp_path / "missing"), str(tmp_path / "no_vocab"),
                 str(tmp_path / "truncated")):
        t = TMiniLM(checkpoint=ckpt, device="cpu")
        assert t.pretrained is False and t.state_dict()["pretrained"] is False, ckpt
        assert JMiniLM(checkpoint=ckpt).pretrained is False, ckpt
        out = t.encode_texts(TEXTS[:3])
        assert out.shape == (3, 384) and np.allclose(np.linalg.norm(out, axis=1), 1, atol=1e-5)
    seeded = TMiniLM(seed=5, device="cpu").encode_texts(TEXTS[:2])
    assert np.array_equal(seeded, TMiniLM(seed=5, device="cpu").encode_texts(TEXTS[:2]))


def test_minilm_index_persists_in_both_packages(full_ckpt, tmp_path):
    from ragfin_tpu.index.vector_index import DeviceVectorIndex as JIndex
    from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex as TIndex

    chunks = generate_distractors(40, seed=8)
    idx = TIndex.build(chunks, embedder=TMiniLM(checkpoint=full_ckpt, device="cpu"), device="cpu")
    assert idx.featurizer is None and idx.encoder is None
    idx.save(str(tmp_path))
    t = TIndex.load(str(tmp_path), device="cpu")
    j = JIndex.load(str(tmp_path))
    assert isinstance(t.embedder, TMiniLM) and t.embedder.pretrained and j.embedder.pretrained
    q = ["What was the net profit?", "total customer deposits"]
    for a, b in zip(t.search_texts(q, top_k=3), j.search_texts(q, top_k=3)):
        assert a[0].id == b[0].id and abs(a[0].score - b[0].score) <= 2e-3
