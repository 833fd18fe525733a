"""The port's pipeline parallelism (ragfin_tpu_torch.parallel.pipeline and
minilm_pipeline) against the JAX package's on the same weights and inputs.

JAX's parameters (``init_pipeline_params``, Flax ``init_params``) are
carried across with ``pipeline_params_from_numpy`` and ``params_from_flax``;
the JAX programs run on conftest's virtual CPU mesh, the port's on the CPU
listed once per stage. Tolerance: f32 within 1e-5 absolute for outputs,
losses, gradients and the parameters after SGD steps (the largest gaps
seen are about 1e-7: only summation order differs).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

from ragfin_tpu.models import minilm as jm
from ragfin_tpu.parallel import minilm_pipeline as jpp
from ragfin_tpu.parallel import pipeline as jpipe
from ragfin_tpu.parallel.mesh import make_mesh as j_make_mesh
from ragfin_tpu_torch.models import minilm as tm
from ragfin_tpu_torch.parallel import minilm_pipeline as tpp
from ragfin_tpu_torch.parallel import pipeline as tpipe
from ragfin_tpu_torch.parallel.mesh import make_mesh as t_make_mesh

TOL = 1e-5


def _j_mesh(shape, names):
    return Mesh(np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape), names)


def _t_mesh(shape, names):
    return t_make_mesh(names, shape, devices=["cpu"] * int(np.prod(shape)))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL, rtol=0)


# --- residual-MLP pipeline --------------------------------------------------


@pytest.fixture(scope="module")
def mlp():
    L, d, M, B = 8, 16, 3, 4
    params = np.asarray(jpipe.init_pipeline_params(jax.random.PRNGKey(0), L, d))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (M, B, d)))
    return params, x


@pytest.mark.parametrize("stages", [1, 2, 4])
def test_pipeline_forward_matches_jax(mlp, stages):
    params, x = mlp
    jmesh = j_make_mesh(("pp",), (stages,), devices=jax.devices()[:stages])
    want = jpipe.make_pipeline_forward(jmesh)(jpipe.place_pipeline_params(jnp.asarray(params), jmesh),
                                               jnp.asarray(x))
    tmesh = _t_mesh((stages,), ("pp",))
    p = tpipe.pipeline_params_from_numpy(params)
    fwd = tpipe.make_pipeline_forward(tmesh)
    got = fwd(p, torch.from_numpy(x.copy()))
    _close(got, want)
    _close(fwd(tpipe.place_pipeline_params(p, tmesh), torch.from_numpy(x)), got)
    for mb in range(x.shape[0]):
        _close(got[mb], tpipe.sequential_forward(p, torch.from_numpy(x[mb])))


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_train_step_matches_jax(mlp, stages):
    params, x = mlp
    targets = 0.1 * np.asarray(jax.random.normal(jax.random.PRNGKey(2), x.shape))
    jmesh = j_make_mesh(("pp",), (stages,), devices=jax.devices()[:stages])
    jstep = jpipe.make_pipeline_train_step(jmesh, learning_rate=0.05)
    tstep = tpipe.make_pipeline_train_step(_t_mesh((stages,), ("pp",)), learning_rate=0.05)
    jp = jpipe.place_pipeline_params(jnp.asarray(params), jmesh)
    tp = tpipe.pipeline_params_from_numpy(params)
    losses = []
    for _ in range(6):
        jp, jloss = jstep(jp, jnp.asarray(x), jnp.asarray(targets))
        tp, tloss = tstep(tp, torch.from_numpy(x), torch.from_numpy(targets))
        _close(tloss, jloss)
        losses.append(float(tloss))
    _close(tp, jp)
    assert losses[-1] < losses[0]


def test_init_pipeline_params_seeded():
    a = tpipe.init_pipeline_params(torch.Generator().manual_seed(3), 4, 8)
    b = tpipe.init_pipeline_params(torch.Generator().manual_seed(3), 4, 8)
    assert a.shape == (4, 8, 8) and a.dtype == torch.float32 and torch.equal(a, b)
    assert abs(float(a.std()) - 0.1) < 0.03


def test_pipeline_rejects_uneven_split(mlp):
    params, x = mlp
    fwd = tpipe.make_pipeline_forward(_t_mesh((3,), ("pp",)))
    with pytest.raises(ValueError, match="evenly"):
        fwd(tpipe.pipeline_params_from_numpy(params), torch.from_numpy(x))


# --- pipeline-parallel MiniLM ---------------------------------------------

J_CFG = jm.MiniLMConfig(vocab_size=211, hidden_size=48, num_layers=6, num_heads=4,
                        intermediate_size=96, max_position=32, dtype=jnp.float32)
T_CFG = tm.MiniLMConfig(vocab_size=211, hidden_size=48, num_layers=6, num_heads=4,
                        intermediate_size=96, max_position=32, dtype=torch.float32)


# Two layers for the train steps and gradients (one a stage).
J_CFG2 = jm.MiniLMConfig(vocab_size=211, hidden_size=32, num_layers=2, num_heads=4,
                         intermediate_size=64, max_position=16, dtype=jnp.float32)
T_CFG2 = tm.MiniLMConfig(vocab_size=211, hidden_size=32, num_layers=2, num_heads=4,
                         intermediate_size=64, max_position=16, dtype=torch.float32)


@pytest.fixture(scope="module")
def minilm_params():
    jparams = jm.init_params(J_CFG, seed=1, seq_len=16)
    return jparams, tm.params_from_flax(jparams)


@pytest.fixture(scope="module")
def small_params():
    jparams = jm.init_params(J_CFG2, seed=1, seq_len=16)
    return jparams, tm.params_from_flax(jparams)


def _batch(m, b, s, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, J_CFG.vocab_size, (m, b, s)).astype(np.int32)
    mask = np.ones((m, b, s), np.int32)
    mask[:, :, s - 3:] = 0  # ragged tail: the mask of the microbatch in flight
    mask[0, 0, 5:] = 0
    return ids, mask


def _t(ids, mask):
    return torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask)


def test_split_merge_roundtrip(minilm_params):
    _, params = minilm_params
    outer, stacked = tpp.split_minilm_params(params, T_CFG)
    assert not any(k.startswith("layers.") for k in outer)
    assert stacked["attention.query.weight"].shape == (6, 48, 48)
    torch.testing.assert_close(stacked["ffn_norm.bias"][4], params["layers.4.ffn_norm.bias"], atol=0, rtol=0)
    again = tpp.merge_minilm_params(outer, stacked, T_CFG)
    assert set(again) == set(params)
    for k in params:
        assert torch.equal(again[k], params[k])


@pytest.mark.parametrize("stages", [2, 3])
def test_pp_forward_matches_jax(minilm_params, stages):
    jparams, params = minilm_params
    ids, mask = _batch(m=4, b=3, s=16)
    want = jpp.make_minilm_pp_forward(_j_mesh((stages,), ("pp",)), J_CFG)(jparams, ids, mask)
    fwd = tpp.make_minilm_pp_forward(_t_mesh((stages,), ("pp",)), T_CFG)
    with torch.no_grad():
        got = fwd(params, *_t(ids, mask))
    _close(got, want)
    model = tm.MiniLMEncoder(T_CFG)
    model.load_state_dict(params)
    with torch.no_grad():
        for mb in range(4):
            _close(got[mb], model(*_t(ids[mb], mask[mb])))


def test_pp_placed_params_same_result(minilm_params):
    _, params = minilm_params
    mesh = _t_mesh((2,), ("pp",))
    fwd = tpp.make_minilm_pp_forward(mesh, T_CFG)
    ids, mask = _t(*_batch(m=2, b=2, s=16))
    with torch.no_grad():
        base = fwd(params, ids, mask)
        placed = tpp.place_minilm_pp_params(params, mesh, T_CFG)
        assert set(placed) == set(params)
        assert torch.equal(fwd(placed, ids, mask), base)


def test_pp_indivisible_layer_split_raises():
    with pytest.raises(ValueError, match="do not split"):
        tpp.make_minilm_pp_forward(_t_mesh((4,), ("pp",)), T_CFG)  # 6 layers over 4 stages


@pytest.mark.parametrize("shape,dp", [((2, 2), "dp"), ((2,), None)])
def test_pp_train_step_matches_jax(small_params, shape, dp):
    jparams, params = small_params
    names = ("pp", "dp") if dp else ("pp",)
    jstep = jpp.make_minilm_pp_train_step(_j_mesh(shape, names), J_CFG2, dp_axis=dp, learning_rate=1e-2)
    tstep = tpp.make_minilm_pp_train_step(_t_mesh(shape, names), T_CFG2, dp_axis=dp, learning_rate=1e-2)
    ids, mask = _batch(m=2, b=4, s=12, seed=3)
    targets = np.random.default_rng(4).standard_normal((2, 4, 32)).astype(np.float32)
    jp, tp, losses = jparams, params, []
    for _ in range(3):
        jp, jloss = jstep(jp, ids, mask, targets)
        tp, tloss = tstep(tp, *_t(ids, mask), torch.from_numpy(targets))
        _close(tloss, jloss)
        losses.append(float(tloss))
    assert losses[-1] < losses[0]
    carried = tm.params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    for k in carried:
        _close(tp[k], carried[k])


def test_pp_grads_reach_every_stage(small_params):
    jparams, params = small_params
    ids, mask = _batch(m=2, b=2, s=12, seed=5)
    jfwd = jpp.make_minilm_pp_forward(_j_mesh((2,), ("pp",)), J_CFG2)
    jgrads = jax.grad(lambda p: jnp.sum(jfwd(p, ids, mask) ** 2))(jparams)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    fwd = tpp.make_minilm_pp_forward(_t_mesh((2,), ("pp",)), T_CFG2)
    loss = (fwd(leaves, *_t(ids, mask)) ** 2).sum()
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    _, stacked = tpp.split_minilm_params(grads, T_CFG2)
    per_layer = stacked["intermediate.weight"].abs().sum(dim=(1, 2))
    assert (per_layer > 0).all()  # every layer of both stages
    carried = tm.params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    for k in carried:
        _close(grads[k], carried[k])
