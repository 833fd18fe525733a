"""The port's sequence-parallel MiniLM forward (ragfin_tpu_torch.parallel.
minilm_sp) against the JAX package's and the port's single-device encoder.

JAX's Flax parameters are carried across with ``params_from_flax``; the
JAX program runs on conftest's virtual CPU mesh at P devices, the port's on
the CPU listed P times. Tolerance: f32 within 1e-5 absolute (the pooled sum
is split over shards; only summation order differs).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ragfin_tpu.models import minilm as jm
from ragfin_tpu.parallel.mesh import make_mesh as j_make_mesh
from ragfin_tpu.parallel.minilm_sp import make_minilm_sp_forward as j_sp
from ragfin_tpu_torch.models import minilm as tm
from ragfin_tpu_torch.parallel.mesh import make_mesh as t_make_mesh
from ragfin_tpu_torch.parallel.minilm_sp import make_minilm_sp_forward as t_sp

TOL = 1e-5
ARCH = dict(vocab_size=128, hidden_size=32, num_heads=4, intermediate_size=64, max_position=64)


def _configs(**kw):
    return (jm.MiniLMConfig(**ARCH, dtype=jnp.float32, **kw),
            tm.MiniLMConfig(**ARCH, dtype=torch.float32, **kw))


def _meshes(p):
    return (j_make_mesh(("sp",), devices=jax.devices()[:p]),
            t_make_mesh(("sp",), devices=["cpu"] * p))


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("pooling,layers,seed", [("mean", 2, 3), ("cls", 1, 5)])
def test_forward_matches_jax(p, pooling, layers, seed):
    jcfg, tcfg = _configs(num_layers=layers, pooling=pooling)
    jparams = jm.init_params(jcfg, seed=seed)
    params = tm.params_from_flax(jparams)
    rng = np.random.default_rng(0)
    b, s = 3, 32  # 4 tokens a shard on sp = 8
    ids = rng.integers(1, jcfg.vocab_size, (b, s)).astype(np.int32)
    mask = (rng.uniform(size=(b, s)) > 0.2).astype(np.int32)
    mask[:, 0] = 1  # at least one real token per row
    jm_, tm_ = _meshes(p)
    want = np.asarray(j_sp(jm_, jcfg)(jparams, jnp.asarray(ids), jnp.asarray(mask)))
    got = t_sp(tm_, tcfg)(params, torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    model = tm.MiniLMEncoder(tcfg)
    model.load_state_dict(params)
    with torch.no_grad():
        ref = model(torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL, rtol=0)


def test_rejects_indivisible_sequence():
    _, tcfg = _configs(num_layers=2)
    fwd = t_sp(_meshes(8)[1], tcfg)
    with pytest.raises(ValueError, match="not divisible"):
        fwd(tm.init_params(tcfg, seed=3), torch.ones((1, 30), dtype=torch.int64),
            torch.ones((1, 30), dtype=torch.int32))
