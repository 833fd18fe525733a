"""The port's MiniLM encoder and tokenizer against the Flax reference, both
loading the committed checkpoints/domain_encoder.

Tolerances: in f32 mode (MiniLMConfig(dtype=float32) on both sides) the
embeddings agree within 1e-4 max abs (only summation order differs). In the
served bf16 mode XLA and torch round at different places (XLA may keep f32
between fused element-wise ops), so the check is per-row cosine >= 0.999.
Token ids must be identical.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ragfin_tpu.models.domain_encoder import DEFAULT_CKPT_DIR as J_CKPT
from ragfin_tpu.models.domain_encoder import load_encoder_checkpoint as j_load
from ragfin_tpu.models.minilm import MiniLMEncoder as FlaxEncoder
from ragfin_tpu_torch.eval.distractors import generate_distractors
from ragfin_tpu_torch.models.domain_encoder import DEFAULT_CKPT_DIR as T_CKPT
from ragfin_tpu_torch.models.domain_encoder import load_encoder_checkpoint as t_load
from ragfin_tpu_torch.models.minilm import MiniLMEncoder, params_from_flax

TEXTS = [c.text for c in generate_distractors(12, seed=3)] + [
    "What was HDFC Bank's net profit in Q2 FY2027?",
    "total customer deposits",
    "x",
    "Retail banking segment revenue and margin, 44.5% YoY",
]


@pytest.fixture(scope="module")
def loaded():
    assert T_CKPT == J_CKPT
    j_params, j_tok, j_cfg, _ = j_load(J_CKPT)
    t_params, t_tok, t_cfg, _ = t_load(T_CKPT)
    return j_params, j_tok, j_cfg, t_params, t_tok, t_cfg


def test_tokenizer_identical(loaded):
    _, j_tok, _, _, t_tok, _ = loaded
    for pad in (16, 64):
        ji, jm = j_tok.encode_batch(TEXTS, pad_multiple=pad)
        ti, tm = t_tok.encode_batch(TEXTS, pad_multiple=pad)
        np.testing.assert_array_equal(ji, ti)
        np.testing.assert_array_equal(jm, tm)


def _port_model(t_params, t_cfg, dtype):
    model = MiniLMEncoder(dataclasses.replace(t_cfg, dtype=dtype))
    model.load_state_dict(params_from_flax(t_params))
    return model.eval()


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_encoder_matches_flax(loaded, mode):
    j_params, j_tok, j_cfg, t_params, _, t_cfg = loaded
    ids, mask = j_tok.encode_batch(TEXTS, pad_multiple=16)
    j_dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[mode]
    ref = np.asarray(FlaxEncoder(dataclasses.replace(j_cfg, dtype=j_dtype)).apply(j_params, ids, mask))
    model = _port_model(t_params, t_cfg, getattr(torch, mode))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask)).numpy()
    assert got.shape == ref.shape == (len(TEXTS), 384)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    if mode == "float32":
        assert np.abs(got - ref).max() <= 1e-4
    else:
        assert (got * ref).sum(axis=1).min() >= 0.999


def test_params_from_flax_layout(loaded):
    _, _, _, t_params, _, t_cfg = loaded
    sd = params_from_flax(t_params)
    kernel = t_params["params"]["layer_0"]["intermediate"]["kernel"]  # [in, out]
    assert tuple(sd["layers.0.intermediate.weight"].shape) == (kernel.shape[1], kernel.shape[0])
    np.testing.assert_array_equal(sd["layers.0.intermediate.weight"].numpy(), kernel.T)
    np.testing.assert_array_equal(
        sd["layers.0.ffn_norm.weight"].numpy(), t_params["params"]["layer_0"]["ffn_norm"]["scale"]
    )
    assert set(sd) == set(MiniLMEncoder(t_cfg).state_dict())


def test_trained_embedder_matches_flax_embedder():
    """The two embedders end to end (row and sequence buckets included),
    bf16 mode: per-row cosine >= 0.999."""
    from ragfin_tpu.models.embedder import TrainedEmbedder as JEmbedder
    from ragfin_tpu_torch.models.embedder import TrainedEmbedder as TEmbedder

    ref = JEmbedder().encode_texts(TEXTS[:9])
    got = TEmbedder(device="cpu").encode_texts(TEXTS[:9])
    assert got.shape == ref.shape and got.dtype == np.float32
    assert (got * ref).sum(axis=1).min() >= 0.999


def test_make_embedder_rejects_unported_backends():
    from ragfin_tpu_torch.models.embedder import make_embedder

    for backend in ("hashed", "minilm"):
        with pytest.raises(NotImplementedError, match="Queue A item 6"):
            make_embedder(backend)
    with pytest.raises(ValueError):
        make_embedder("bogus")
