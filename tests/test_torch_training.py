"""The port's training step (models/training.py) against the JAX package's
and optax, on the CPU, at small sizes.

Tolerances, each measured before it was set:
- ``info_nce_loss``: 1e-6 absolute (f32 log-softmax in another order).
- The schedule: 1e-7 absolute at every count (the port computes in f64,
  optax in f32; the largest gap seen is 7e-11).
- Clipping, AdamW and the full chain over 20 updates on the same seeded
  gradients: each parameter tensor within 1e-6 relative in the L2 norm. The
  two differ only in f32 rounding (in f64 they agree to 4e-15): torch
  applies the decay as ``p * (1 - lr * wd)`` before the Adam step, optax adds
  ``wd * p`` to the update, so single elements drift by a few ulp.
- The bag step for 5 steps from the same ``init_table``: loss and accuracy
  within 1e-5.
- A MiniLM step at f32 activations (JAX's parameters carried across with
  ``params_from_flax``): loss within 1e-4 relative at each of 5 steps and
  every parameter within 1e-4 max abs afterwards (the largest gap seen is
  2e-7), but the attention key biases, whose true gradient is 0 (see the
  test).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ragfin_tpu.models import bag_encoder as jb
from ragfin_tpu.models import minilm as jm
from ragfin_tpu.models import training as jt
from ragfin_tpu_torch.eval.distractors import generate_distractors
from ragfin_tpu_torch.models import bag_encoder as tb
from ragfin_tpu_torch.models import minilm as tm
from ragfin_tpu_torch.models import training as tt
from ragfin_tpu_torch.models.featurizer import HashedFeaturizer

NCE_TOL = 1e-6
SCHEDULE_TOL = 1e-7
OPT_RTOL = 1e-6
BAG_TOL = 1e-5
MINILM_RTOL = 1e-4
MINILM_PARAM_TOL = 1e-4


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("batch,temperature", [(2, 0.05), (8, 0.05), (16, 0.1), (64, 1.0)])
def test_info_nce_loss(batch, temperature):
    rng = np.random.default_rng(batch)
    q, d = _unit(rng, (batch, 32)), _unit(rng, (batch, 32))
    want = float(jt.info_nce_loss(jnp.asarray(q), jnp.asarray(d), temperature))
    got = float(tt.info_nce_loss(torch.from_numpy(q), torch.from_numpy(d), temperature))
    assert abs(got - want) <= NCE_TOL


@pytest.mark.parametrize("peak,warmup,steps", [(3e-4, 100, 2000), (3e-4, 10, 100), (1e-3, 1, 8), (1.0, 3, 4)])
def test_schedule_equals_optax_at_every_count(peak, warmup, steps):
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=peak, warmup_steps=warmup, decay_steps=steps
    )
    got = tt.warmup_cosine_decay_schedule(0.0, peak, warmup, steps)
    counts = np.arange(steps + 1)
    ref = np.asarray(jax.vmap(want)(jnp.asarray(counts)), np.float64)
    assert np.max(np.abs(np.array([got(int(c)) for c in counts]) - ref)) <= SCHEDULE_TOL
    assert got(0) == 0.0


def test_scheduler_gives_optax_rate_to_each_update():
    """LambdaLR stepped after the optimizer: update n runs at schedule(n),
    so the first update (count 0) runs at 0 and moves no parameter."""
    schedule = tt.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 10)
    p = torch.ones(4, requires_grad=True)
    opt, sched = tt.AdamW(schedule, weight_decay=0.01).init([p])
    seen = []
    for n in range(10):
        seen.append(opt.param_groups[0]["lr"])
        p.grad = torch.full((4,), 0.5)
        before = p.detach().clone()
        opt.step()
        sched.step()
        if n == 0:
            assert torch.equal(p.detach(), before)
            assert torch.count_nonzero(opt.state[p]["exp_avg"]) == 4
    assert seen == [schedule(n) for n in range(10)]


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 100.0])
def test_clip_by_global_norm(max_norm):
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((7, 5), (5,), (2, 3, 4))]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = tt.clip_by_global_norm(got, max_norm)
    assert abs(float(norm) - float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads)))) < 1e-5
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


CHAINS = {
    "adamw wd 1e-4": dict(weight_decay=1e-4, clip=None, schedule=False),
    "adamw wd 1e-2": dict(weight_decay=1e-2, clip=None, schedule=False),
    "clip 1.0 + adamw(schedule, wd 1e-2)": dict(weight_decay=1e-2, clip=1.0, schedule=True),
    "clip 0.5 + adamw wd 1e-4": dict(weight_decay=1e-4, clip=0.5, schedule=False),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_optimizer_matches_optax_over_20_updates(name):
    cfg = CHAINS[name]
    rng = np.random.default_rng(11)
    shapes = ((33, 16), (16,), (3, 4, 6))
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * rng.uniform(0.01, 3.0)).astype(np.float32) for s in shapes]
             for _ in range(20)]
    if cfg["schedule"]:
        j_lr = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 20)
        t_lr = tt.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 20)
    else:
        j_lr = t_lr = 1e-2
    parts = [optax.clip_by_global_norm(cfg["clip"])] if cfg["clip"] else []
    j_opt = optax.chain(*parts, optax.adamw(j_lr, weight_decay=cfg["weight_decay"]))
    j_params = [jnp.asarray(p) for p in p0]
    j_state = j_opt.init(j_params)

    t_params = [torch.from_numpy(p.copy()).requires_grad_(True) for p in p0]
    spec = tt.AdamW(t_lr, weight_decay=cfg["weight_decay"], max_grad_norm=cfg["clip"])
    opt, sched = spec.init(t_params)
    for g in grads:
        updates, j_state = j_opt.update([jnp.asarray(x) for x in g], j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for p, x in zip(t_params, g):
            p.grad = torch.from_numpy(x.copy())
        if spec.max_grad_norm is not None:
            tt.clip_by_global_norm([p.grad for p in t_params], spec.max_grad_norm)
        opt.step()
        if sched is not None:
            sched.step()
    for j, t in zip(j_params, t_params):
        j = np.asarray(j, np.float64)
        rel = np.linalg.norm(t.detach().numpy() - j) / np.linalg.norm(j)
        assert rel <= OPT_RTOL, (name, rel)


def test_init_train_state_copies_a_tensor():
    table = torch.zeros(4, 3)
    state = tt.init_train_state(table, tt.AdamW(1e-3))
    assert state.params is not table and state.params.requires_grad and state.step == 0
    assert state.scheduler is None


@pytest.fixture(scope="module")
def bag_batches():
    texts = [c.text for c in generate_distractors(40, seed=9)]
    feat = HashedFeaturizer(vocab_size=4096).fit(texts)
    ids, w = feat.encode_batch(texts)
    rng = np.random.default_rng(2)
    out = []
    for _ in range(5):
        sel = rng.permutation(len(texts))[:8]
        # queries: the first half of each text's features, docs: all of them
        q_w = w[sel].copy()
        q_w[:, q_w.shape[1] // 2:] = 0
        out.append({"query": {"ids": ids[sel], "weights": q_w}, "doc": {"ids": ids[sel], "weights": w[sel]}})
    return out


def test_bag_step_matches_jax_for_5_steps(bag_batches):
    j_table = jb.BagEncoder(vocab_size=4096, dim=64, seed=5).table
    t_table = tb.init_table(4096, 64, seed=5, device="cpu")
    assert np.array_equal(np.asarray(j_table), t_table.numpy())

    j_opt = optax.adamw(3e-3)
    j_step = jax.jit(jt.make_train_step(jt.bag_apply, j_opt, temperature=0.1))
    j_state = jt.init_train_state(j_table, j_opt)
    t_opt = tt.AdamW(3e-3)
    t_step = tt.make_train_step(tt.bag_apply, t_opt, temperature=0.1)
    t_state = tt.init_train_state(t_table, t_opt)
    for batch in bag_batches:
        j_state, jm_ = j_step(j_state, batch)
        t_batch = {side: {"ids": torch.from_numpy(np.asarray(b["ids"], np.int64)),
                          "weights": torch.from_numpy(np.asarray(b["weights"], np.float32))}
                   for side, b in batch.items()}
        t_state, tm_ = t_step(t_state, t_batch)
        assert abs(float(tm_["loss"]) - float(jm_["loss"])) <= BAG_TOL
        assert abs(float(tm_["accuracy"]) - float(jm_["accuracy"])) <= BAG_TOL
    assert t_state.step == 5 and int(j_state.step) == 5
    np.testing.assert_allclose(t_state.params.detach().numpy(), np.asarray(j_state.params), atol=1e-6)
    # the caller's table is not trained in place
    assert np.array_equal(t_table.numpy(), np.asarray(j_table))


SMALL = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
             max_position=24)


def test_minilm_step_matches_flax_at_f32():
    j_cfg = jm.MiniLMConfig(**SMALL, dtype=jnp.float32)
    t_cfg = tm.MiniLMConfig(**SMALL, dtype=torch.float32)
    j_params = jm.init_params(j_cfg, seed=3)
    model = tm.MiniLMEncoder(t_cfg)
    model.load_state_dict(tm.params_from_flax(jax.tree_util.tree_map(np.asarray, j_params)))

    j_sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 5)
    j_opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(j_sched, weight_decay=0.01))
    j_step = jax.jit(jt.make_train_step(
        lambda p, s: jm.MiniLMEncoder(j_cfg).apply(p, s["input_ids"], s["attention_mask"]),
        j_opt, temperature=0.05))
    j_state = jt.init_train_state(j_params, j_opt)
    t_opt = tt.AdamW(tt.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 5), weight_decay=0.01,
                     max_grad_norm=1.0)
    t_step = tt.make_train_step(tm.minilm_apply, t_opt, temperature=0.05)
    t_state = tt.init_train_state(model, t_opt)

    rng = np.random.default_rng(4)
    for n in range(5):
        batch = {}
        for side, s in (("query", 8), ("doc", 16)):
            ids = rng.integers(1, SMALL["vocab_size"], (6, s)).astype(np.int32)
            mask = (np.arange(s)[None, :] < rng.integers(2, s + 1, (6, 1))).astype(np.int32)
            batch[side] = {"input_ids": ids * mask, "attention_mask": mask}
        j_state, j_metrics = j_step(j_state, batch)
        t_batch = {side: {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}
                   for side, b in batch.items()}
        t_state, t_metrics = t_step(t_state, t_batch)
        want = float(j_metrics["loss"])
        assert abs(float(t_metrics["loss"]) - want) <= MINILM_RTOL * abs(want), n
        assert float(t_metrics["accuracy"]) == float(j_metrics["accuracy"])
    sd = tm.params_from_flax(jax.tree_util.tree_map(np.asarray, j_state.params))
    for name, value in model.state_dict().items():
        err = float((value - sd[name]).abs().max())
        if name.endswith("attention.key.bias"):
            # A bias added to every key shifts each query's scores by one
            # constant, which the softmax removes: its true gradient is 0,
            # so both sides move it only by Adam-normalised rounding noise.
            # Bounded by the steps' total learning rate instead.
            assert err <= 2 * sum(t_opt.learning_rate(n) for n in range(5)), (name, err)
        else:
            assert err <= MINILM_PARAM_TOL, (name, err)
