"""The port's hashed backend (featurizer, native featurizer, bag encoder,
HashedEmbedder) against the JAX package's, on the CPU.

- ``init_table`` must equal ``jax.random.normal(PRNGKey(seed)) / sqrt(D)``
  bitwise: an untuned index saved by either package keeps only the seed.
- The featurizer copy must give JAX's arrays bitwise, on the native path
  (the port's own build of ``native/fasthash.cpp``) and on the Python path.
- ``bag_encode`` (torch ``embedding_bag``) must be within 2e-6 of JAX's
  gather + einsum (f32 sums in another order), and rows with equal feature
  multisets must be bitwise equal in the port.
"""

import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ragfin_tpu.eval.distractors import generate_distractors as j_distractors
from ragfin_tpu.models import bag_encoder as jb
from ragfin_tpu.models import fasthash as j_fasthash
from ragfin_tpu.models.embedder import HashedEmbedder as JHashed
from ragfin_tpu.models.featurizer import HashedFeaturizer as JFeat
from ragfin_tpu_torch.eval.distractors import generate_distractors as t_distractors
from ragfin_tpu_torch.models import bag_encoder as tb
from ragfin_tpu_torch.models import fasthash as t_fasthash
from ragfin_tpu_torch.models.embedder import HashedEmbedder as THashed
from ragfin_tpu_torch.models.embedder import make_embedder
from ragfin_tpu_torch.models.featurizer import HashedFeaturizer as TFeat

ENCODE_TOL = 2e-6

ODD_TEXTS = [
    "",
    "Net profit of ₹10,636 crore in Q1 FY2024, up 44.0% YoY.",
    "KELVIN SIGN K and ÉLAN: mixed-case Unicode net profit",
    "numbers 12345 123 1.5 2024 and words net profit net profit",
    "a" * 300 + " bottom line",
]


@pytest.fixture(scope="module")
def texts():
    j, t = j_distractors(600, seed=5), t_distractors(600, seed=5)
    assert [c.text for c in j] == [c.text for c in t]
    return [c.text for c in t] + ODD_TEXTS


def test_init_table_is_jax_draw_at_full_width():
    port = tb.init_table(device="cpu")
    ref = np.asarray(jb.init_table())
    assert port.shape == (65536, 384) and port.dtype == torch.float32
    assert np.array_equal(port.numpy(), ref)


@pytest.mark.parametrize("seed", [1, 7, 2**32 + 3])
@pytest.mark.parametrize("shape", [(100, 384), (33, 5)])
def test_init_table_is_jax_draw_for_other_seeds(seed, shape):
    port = tb.init_table(*shape, seed=seed, device="cpu").numpy()
    assert np.array_equal(port, np.asarray(jb.init_table(*shape, seed=seed)))
    # The draw itself, before the 1/sqrt(D) scale.
    raw = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))
    assert np.array_equal(tb._normal_f32(seed, math.prod(shape)).reshape(shape), raw)


def test_native_library_is_the_ports_own_build():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert t_fasthash.available()
    assert t_fasthash.LIB_PATH == os.path.join(root, "build", "ragfin_tpu_torch", "libfasthash.so")
    assert os.path.exists(t_fasthash.LIB_PATH)


@pytest.fixture(params=["native", "python"])
def path(request, monkeypatch):
    if request.param == "python":
        for mod in (t_fasthash, j_fasthash):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_load_attempted", True)
    else:
        assert t_fasthash.available() and j_fasthash.available()
    return request.param


def test_featurizer_equals_jax_bitwise(texts, path):
    tf, jf = TFeat().fit(texts[:500]), JFeat().fit(texts[:500])
    assert tf.idf == jf.idf and tf.n_docs == jf.n_docs == 500
    for batch in (texts[500:], texts[:64], ["net profit"]):
        ti, tw = tf.encode_batch(batch)
        ji, jw = jf.encode_batch(batch)
        assert ti.dtype == ji.dtype == np.int32 and tw.dtype == jw.dtype == np.float32
        assert np.array_equal(ti, ji) and np.array_equal(tw, jw)
    state = tf.state_dict()
    assert state == jf.state_dict()
    again = TFeat.from_state_dict(state)
    assert np.array_equal(again.encode_batch(texts[:32])[1], tf.encode_batch(texts[:32])[1])


def test_native_and_python_paths_agree(texts, monkeypatch):
    feat = TFeat().fit(texts)
    native = feat.encode_batch(texts)
    monkeypatch.setattr(t_fasthash, "_lib", None)
    monkeypatch.setattr(t_fasthash, "_load_attempted", True)
    python = TFeat().fit(texts).encode_batch(texts)
    assert np.array_equal(native[0], python[0]) and np.array_equal(native[1], python[1])


def test_bag_encode_matches_jax(texts):
    feat = TFeat().fit(texts)
    ids, wts = feat.encode_batch(texts)
    table = tb.init_table(device="cpu")
    port = tb.bag_encode(table, torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(wts))
    ref = np.asarray(jb.bag_encode(jb.init_table(), jnp.asarray(ids), jnp.asarray(wts)))
    assert port.dtype == torch.float32 and port.shape == (len(texts), 384)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=ENCODE_TOL)
    raw = tb.bag_encode(table, torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(wts),
                        normalize=False)
    ref_raw = np.asarray(jb.bag_encode(jb.init_table(), jnp.asarray(ids), jnp.asarray(wts),
                                       normalize=False))
    np.testing.assert_allclose(raw.numpy(), ref_raw, rtol=0, atol=ENCODE_TOL)


def test_equal_feature_multisets_encode_bitwise_equal(texts):
    """Dropped data-value numbers and word order change a text's emission
    order but not its features: canonical order makes the rows identical,
    in one batch and across batches padded to other widths."""
    base = "net profit rose in Q1 FY2024 for the retail segment of the bank"
    variants = [
        base,
        "net profit rose 10636 in Q1 FY2024 for the retail 44.5 segment of the bank",
        "Net Profit rose in Q1 FY2024 for the retail segment of the bank 99.9",
    ]
    feat = TFeat().fit(texts + variants)
    enc = THashed(featurizer=feat, device="cpu")
    together = enc.encode_texts(variants + texts[:40])
    alone = enc.encode_texts(variants[1:2])
    assert np.array_equal(together[0], together[1]) and np.array_equal(together[0], together[2])
    assert np.array_equal(together[1], alone[0])
    assert not np.array_equal(together[0], together[3])


def test_hashed_embedder_matches_jax(texts):
    t = THashed(device="cpu").fit(texts[:400])
    j = JHashed().fit(texts[:400])
    got = t.encode_texts(texts)
    ref = np.asarray(j.encode_texts(texts))
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=ENCODE_TOL)
    assert t.state_dict() == j.state_dict()
    again = THashed.from_state_dict(t.state_dict(), device="cpu")
    assert np.array_equal(again.encode_texts(texts[:50]), got[:50])


def test_bag_encoder_state_and_tuned_table():
    enc = tb.BagEncoder(vocab_size=64, dim=8, seed=3, device="cpu")
    assert enc.state_dict() == jb.BagEncoder(vocab_size=64, dim=8, seed=3).state_dict()
    assert not enc.tuned
    with pytest.raises(ValueError, match="tuned"):
        tb.BagEncoder.from_state_dict({**enc.state_dict(), "tuned": True}, device="cpu")
    table = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    tuned = tb.BagEncoder.from_state_dict({**enc.state_dict(), "tuned": True}, table=table,
                                          device="cpu")
    assert tuned.tuned and np.array_equal(tuned.table.numpy(), table)
    out = tuned.encode(np.array([[1, 2, 0]], np.int32), np.array([[1.0, 0.5, 0.0]], np.float32))
    want = table[1] + 0.5 * table[2]
    np.testing.assert_allclose(out.numpy()[0], want / np.linalg.norm(want), atol=1e-6)


def test_make_embedder_hashed_on_the_cpu_and_not_without_a_card():
    emb = make_embedder("hashed", vocab_size=256, seed=2, device="cpu")
    assert isinstance(emb, THashed) and emb.encoder.table.shape == (256, 384)
    assert emb.featurizer.vocab_size == 256 and str(emb.device) == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_embedder("hashed")
