"""The MiniLM presets, ``init_params(seq_len=...)`` and the single-device
``entry()`` of the port against the JAX package, on the CPU.

The presets must equal ``ragfin_tpu.models.minilm``'s field by field, the
activation dtype mapped (``jnp.bfloat16`` -> ``torch.bfloat16``).
``tests/test_misc.py``'s cls-pooling case runs through the port on the Flax
module's weights (``params_from_flax``), within 1e-5 at f32. The port's
``entry()`` draws the same example ids as ``__graft_entry__.entry()``, and
its forward on the JAX entry's weights, at f32, equals the Flax forward
within 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ragfin_tpu.models import minilm as jm
from ragfin_tpu_torch.models import minilm as tm
from ragfin_tpu_torch.parallel.dryrun import entry

TOL = 1e-5
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


@pytest.mark.parametrize("name", sorted(jm.ENCODER_PRESETS))
def test_preset_equals_jax(name):
    j, t = jm.ENCODER_PRESETS[name], tm.ENCODER_PRESETS[name]
    assert set(tm.ENCODER_PRESETS) == set(jm.ENCODER_PRESETS)
    for field in dataclasses.fields(jm.MiniLMConfig):
        jv, tv = getattr(j, field.name), getattr(t, field.name)
        assert (DTYPES[jv] if field.name == "dtype" else jv) == tv, field.name
    assert t.head_dim == j.head_dim


def test_named_presets_are_the_dict_entries():
    assert tm.MINILM_L6 is tm.ENCODER_PRESETS["minilm-l6"] and tm.MINILM_L6 == tm.MiniLMConfig()
    assert tm.MINILM_L12 is tm.ENCODER_PRESETS["minilm-l12"]
    assert tm.BGE_SMALL is tm.ENCODER_PRESETS["bge-small"]
    assert tm.BERT_BASE is tm.ENCODER_PRESETS["bert-base"]


def test_init_params_accepts_and_ignores_seq_len():
    cfg = tm.MiniLMConfig(num_layers=1, hidden_size=64, num_heads=4, intermediate_size=128,
                          vocab_size=500)
    a, b = tm.init_params(cfg, seed=3), tm.init_params(cfg, seed=3, seq_len=8)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_cls_pooling_forward_against_flax():
    """tests/test_misc.py's TestEncoderPresets case (cls pooling,
    seq_len=8) through the port, on the Flax module's weights."""
    kw = dict(num_layers=1, hidden_size=64, num_heads=4, intermediate_size=128, vocab_size=500,
              pooling="cls")
    jcfg = jm.MiniLMConfig(dtype=jnp.float32, **kw)
    tcfg = tm.MiniLMConfig(dtype=torch.float32, **kw)
    params = jm.init_params(jcfg, seq_len=8)
    ids = np.random.default_rng(5).integers(0, 500, (2, 8))
    mask = np.ones((2, 8), np.int32)
    mask[1, 5:] = 0
    side = {"input_ids": jnp.asarray(ids, jnp.int32), "attention_mask": jnp.asarray(mask)}
    want = np.asarray(jm.minilm_apply(params, side, jcfg))

    model = tm.MiniLMEncoder(tcfg)
    model.load_state_dict(tm.params_from_flax(params))
    got = tm.minilm_apply(model, {"input_ids": torch.from_numpy(ids),
                                  "attention_mask": torch.from_numpy(mask)})
    assert got.shape == (2, 64)
    np.testing.assert_allclose(np.linalg.norm(got.detach().numpy(), axis=1), 1.0, rtol=TOL)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL, rtol=0)


def test_entry_against_graft_entry():
    """The port's entry() on the JAX entry's weights at MiniLMConfig(dtype=f32)."""
    jfn, (jparams, jids, jmask) = graft.entry()
    tfn, (tparams, tids, tmask) = entry(config=tm.MiniLMConfig(dtype=torch.float32), device="cpu")
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert tids.shape == (8, 32) and tparams.keys() == tm.init_params(tm.MiniLMConfig()).keys()

    want = np.asarray(jm.MiniLMEncoder(jm.MiniLMConfig(dtype=jnp.float32)).apply(jparams, jids, jmask))
    got = tfn(tm.params_from_flax(jparams), tids, tmask)
    assert got.shape == (8, 384) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_entry_default_is_bf16_and_matches_f32():
    """The flagship config's bf16 forward against the f32 forward from the
    same init_params (the card check's reference, here on the CPU)."""
    fn, args = entry(device="cpu")
    fn32, args32 = entry(config=tm.MiniLMConfig(dtype=torch.float32), device="cpu")
    assert all(torch.equal(args[0][k], args32[0][k]) for k in args[0])
    cos = torch.nn.functional.cosine_similarity(fn(*args).float(), fn32(*args32), dim=1)
    assert float(cos.min()) >= 0.999


def test_entry_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
