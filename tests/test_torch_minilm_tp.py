"""The port's dp x tp MiniLM encoder and training step
(ragfin_tpu_torch.parallel.minilm_tp) against JAX's GSPMD program: stage 1
of ``__graft_entry__.dryrun_multichip``, parameters placed with its
``_param_spec`` on a ("dp", "tp") mesh of conftest's virtual CPU devices.

Shapes: hidden 384, 12 heads, FFN 1536 (the split rule's width), 2 layers,
32 positions, batch 2 * dp, 16 tokens, f32. The vocabulary is 1,538 (split,
and uneven at tp = 4) or 30,522 (at tp = 2). The port's meshes list the CPU
once per shard. JAX refuses a ``device_put`` whose split does not divide
(``ValueError``: "should be divisible by 4"), so at 1,538 rows over tp = 4
JAX's side holds the word table replicated; the port pads its last shard.

Tolerances, each measured before it was set: forward 1e-5 absolute; loss
and accuracy 1e-5 absolute; the global norm after a step 1e-5 relative;
each tensor's gradient (Adam's first moment, ``0.1 * g`` after one step)
within 5e-5 relative L2 of JAX's (largest seen 5.7e-6); each tensor's
update (new - old) within 5e-3 relative L2 of JAX's (largest seen 2.1e-3).
The update's bound is not 1e-3: Adam's first update is about
``lr * sign(g)``, so an element whose gradient is near its rounding noise
flips, and the port's single-device step is as far from JAX's (up to 2.3e-3
on the same batches). The attention key biases are held only to the steps'
learning rate: their true gradient is 0 (a bias added to every key shifts
each query's scores by one constant), so Adam normalises rounding noise on
both sides.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import __graft_entry__ as graft
from ragfin_tpu.models import minilm as jm
from ragfin_tpu.models import training as jt
from ragfin_tpu_torch.models import minilm as tm
from ragfin_tpu_torch.models import training as tt
from ragfin_tpu_torch.models.domain_encoder import load_encoder_checkpoint
from ragfin_tpu_torch.parallel import mesh as tmesh
from ragfin_tpu_torch.parallel import minilm_tp as ttp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
GRAD_RTOL = 5e-5
UPDATE_RTOL = 5e-3
LR = 1e-4


def _configs(vocab, dtype=torch.float32):
    arch = dict(vocab_size=vocab, num_layers=2, max_position=32)
    return jm.MiniLMConfig(**arch, dtype=jnp.float32), tm.MiniLMConfig(**arch, dtype=dtype)


@pytest.fixture(scope="module")
def flax_params():
    cache = {}

    def get(vocab):
        if vocab not in cache:
            j = jm.init_params(_configs(vocab)[0], seed=0, seq_len=16)
            cache[vocab] = (j, tm.params_from_flax(jax.tree_util.tree_map(np.asarray, j)))
        return cache[vocab]

    return get


def _t_mesh(dp, tp):
    return tmesh.make_mesh(("dp", "tp"), (dp, tp), devices=["cpu"] * (dp * tp))


def _batch(b, vocab, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for side in ("query", "doc"):
        ids = rng.integers(0, vocab, (b, 16)).astype(np.int32)
        mask = (np.arange(16)[None, :] < rng.integers(3, 17, (b, 1))).astype(np.int32)
        out[side] = {"input_ids": ids * mask, "attention_mask": mask}
    return out


def _t_batch(batch):
    return {s: {k: torch.from_numpy(v.astype(np.int64)) for k, v in side.items()} for s, side in batch.items()}


def _torch_name(path) -> tuple[str, bool]:
    """A Flax parameter path -> (the port's state_dict name, transposed)."""
    keys = [p.key for p in path][1:]  # below "params"
    leaf = keys[-1]
    if keys[0].startswith("layer_"):
        prefix = f"layers.{keys[0][len('layer_'):]}."
        inner = "/".join(keys[1:-1])
        if inner in tm._FLAX_LINEARS:
            return prefix + tm._FLAX_LINEARS[inner] + (".weight" if leaf == "kernel" else ".bias"), leaf == "kernel"
        return prefix + inner + (".weight" if leaf == "scale" else ".bias"), False
    return keys[0] + (".weight" if leaf in ("embedding", "scale") else ".bias"), False


def _spec_dim(spec):
    return next((d for d, axis in enumerate(spec) if axis == "tp"), None)


# --- the split rule -------------------------------------------------------------


def _flax_tree(which):
    if which == "MiniLMConfig()":
        return jax.eval_shape(lambda: jm.init_params(jm.MiniLMConfig(), seed=0, seq_len=16))
    params, _, _, _ = load_encoder_checkpoint(os.path.join(ROOT, "checkpoints", "domain_encoder"))
    return {"params": params["params"]} if "params" in params else {"params": params}


@pytest.mark.parametrize("which", ["MiniLMConfig()", "checkpoints/domain_encoder"])
def test_split_rule_matches_param_spec(which):
    leaves = jax.tree_util.tree_flatten_with_path(_flax_tree(which))[0]
    seen = {}
    for path, leaf in leaves:
        name, transposed = _torch_name(path)
        shape = tuple(leaf.shape)[::-1] if transposed else tuple(leaf.shape)
        want = _spec_dim(graft._param_spec(path, leaf))
        if want is not None and transposed:
            want = 1 - want
        seen[name] = ttp.tp_split_dim(name, shape)
        assert seen[name] == want, (name, shape)
    n_layers = 6 if which == "MiniLMConfig()" else 4
    with torch.device("meta"):
        names = set(tm.MiniLMEncoder(tm.MiniLMConfig(num_layers=n_layers)).state_dict())
    assert set(seen) == names
    split = {k: v for k, v in seen.items() if v is not None}
    assert split == {"word_embeddings.weight": 0,
                     **{f"layers.{i}.intermediate.weight": 0 for i in range(n_layers)},
                     **{f"layers.{i}.ffn_output.weight": 1 for i in range(n_layers)}}


# --- placement ------------------------------------------------------------------


@pytest.mark.parametrize("vocab,tp", [(1538, 4), (1538, 2), (30522, 4), (211, 2)])
def test_place_gather_round_trip_is_bitwise(vocab, tp):
    _, cfg = _configs(vocab)
    if vocab < 1536:  # all replicated: a width below the rule's threshold
        cfg = tm.MiniLMConfig(vocab_size=vocab, hidden_size=32, num_layers=2, num_heads=4,
                              intermediate_size=64, max_position=32, dtype=torch.float32)
    params = tm.init_params(cfg, seed=1)
    mesh = _t_mesh(1, tp)
    placed = ttp.place_minilm_tp_params(params, mesh, cfg)
    rows = -(-vocab // tp)
    table = placed["word_embeddings.weight"]
    if vocab >= 1536:
        assert [t.shape for t in table] == [(rows, 384)] * tp
        assert torch.equal(table[-1][vocab - (tp - 1) * rows:], torch.zeros(tp * rows - vocab, 384))
        assert [t.shape for t in placed["layers.1.ffn_output.weight"]] == [(384, 1536 // tp)] * tp
        assert [t.shape for t in placed["layers.1.intermediate.weight"]] == [(1536 // tp, 384)] * tp
    else:
        assert all(len(shards) == 1 for shards in placed.values())
    assert len(placed["position_embeddings.weight"]) == 1 and len(placed["layers.0.intermediate.bias"]) == 1
    back = ttp.gather_minilm_tp_params(placed, cfg)
    assert set(back) == set(params)
    for k in params:
        assert back[k].shape == params[k].shape and torch.equal(back[k], params[k]), k
    placed["word_embeddings.weight"][0].add_(1.0)  # shards are copies
    assert torch.equal(back["word_embeddings.weight"], params["word_embeddings.weight"])
    expect = torch.linalg.vector_norm(torch.stack([v.double().norm() for v in params.values()]))
    assert abs(float(ttp.global_norm(ttp.place_minilm_tp_params(params, mesh, cfg))) - float(expect)) <= 1e-6 * float(expect)


def test_place_rejects_other_state_dicts():
    _, cfg = _configs(1538)
    params = tm.init_params(cfg, seed=1)
    with pytest.raises(ValueError, match="not a 2-layer encoder"):
        ttp.place_minilm_tp_params({k: v for k, v in params.items() if "layers.1." not in k}, _t_mesh(1, 2), cfg)
    # A hidden width of 1536 would split attention too: the encoder has no such program.
    with pytest.raises(ValueError, match="splits only the word table and the FFN"):
        ttp._split_dim("layers.0.attention.query.weight", (1536, 1536))


# --- forward --------------------------------------------------------------------


@pytest.mark.parametrize("dp,tp", [(1, 1), (2, 2), (1, 4), (4, 2)])
def test_forward_matches_flax(flax_params, dp, tp):
    jcfg, cfg = _configs(1538)
    jparams, params = flax_params(1538)
    side = _batch(2 * dp, 1538, seed=dp * 10 + tp)["query"]
    want = np.asarray(jm.MiniLMEncoder(jcfg).apply(jparams, side["input_ids"], side["attention_mask"]))
    mesh = _t_mesh(dp, tp)
    t = _t_batch({"q": side})["q"]
    with torch.no_grad():
        got = ttp.make_minilm_tp_forward(mesh, cfg)(ttp.place_minilm_tp_params(params, mesh, cfg),
                                                    t["input_ids"], t["attention_mask"])
    assert got.shape == (2 * dp, 384) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_bf16_forward_against_the_encoder(flax_params):
    """bf16: at (1, 1) the same ops as the encoder, bitwise; at (2, 2) the
    FFN partials are rounded to bf16 per shard, so per-row cosine."""
    _, cfg = _configs(1538, torch.bfloat16)
    _, params = flax_params(1538)
    model = tm.MiniLMEncoder(cfg)
    model.load_state_dict(params)
    t = _t_batch(_batch(4, 1538, seed=7))["query"]
    with torch.no_grad():
        ref = model(t["input_ids"], t["attention_mask"])
        for dp, tp in ((1, 1), (2, 2)):
            mesh = _t_mesh(dp, tp)
            got = ttp.make_minilm_tp_forward(mesh, cfg)(ttp.place_minilm_tp_params(params, mesh, cfg),
                                                        t["input_ids"], t["attention_mask"])
            if tp == 1:
                assert torch.equal(got, ref)
            else:
                assert float((got * ref).sum(dim=1).min()) >= 0.999


def test_forward_rejects_uneven_batch(flax_params):
    _, cfg = _configs(1538)
    _, params = flax_params(1538)
    mesh = _t_mesh(2, 1)
    with pytest.raises(ValueError, match="does not split over dp=2"):
        ttp.make_minilm_tp_forward(mesh, cfg)(ttp.place_minilm_tp_params(params, mesh, cfg),
                                              torch.zeros((3, 16), dtype=torch.int64),
                                              torch.ones((3, 16), dtype=torch.int64))


# --- the training step against JAX's GSPMD step ----------------------------------


def _jax_step(jcfg, jparams, batch, dp, tp):
    """``_dryrun_impl``'s stage 1: the parameters placed by ``_param_spec``
    (replicated where the split would not divide), the batch on dp."""
    mesh = Mesh(np.array(jax.devices()[: dp * tp]).reshape(dp, tp), ("dp", "tp"))

    def sharding(path, leaf):
        spec = graft._param_spec(path, leaf)
        dim = _spec_dim(spec)
        return NamedSharding(mesh, P() if dim is not None and leaf.shape[dim] % tp else spec)

    params = jax.device_put(jparams, jax.tree_util.tree_map_with_path(sharding, jparams))
    optimizer = optax.adamw(LR)
    step = jt.make_train_step(lambda p, side: jm.minilm_apply(p, side, jcfg), optimizer)
    rows = NamedSharding(mesh, P("dp", None))
    jbatch = jax.tree_util.tree_map(lambda a: jax.device_put(jnp.asarray(a), rows), batch)
    with mesh:
        state, metrics = jax.jit(step)(jt.init_train_state(params, optimizer), jbatch)
    return state, metrics, params


@pytest.mark.parametrize("dp,tp,vocab", [(2, 2, 1538), (1, 4, 1538), (4, 2, 1538), (1, 2, 30522)])
def test_train_step_matches_gspmd(flax_params, dp, tp, vocab):
    jcfg, cfg = _configs(vocab)
    jparams, params = flax_params(vocab)
    batch = _batch(2 * dp, vocab, seed=dp + tp)
    j_state, j_metrics, j_placed = _jax_step(jcfg, jparams, batch, dp, tp)
    table_spec = j_placed["params"]["word_embeddings"]["embedding"].sharding.spec
    assert _spec_dim(table_spec) == (None if vocab % tp else 0)  # JAX did shard what divides

    mesh = _t_mesh(dp, tp)
    opt = tt.AdamW(LR)
    state = tt.init_train_state(ttp.place_minilm_tp_params(params, mesh, cfg), opt)
    state, metrics = ttp.make_minilm_dp_tp_train_step(mesh, cfg, opt)(state, _t_batch(batch))
    for key in ("loss", "accuracy"):
        assert abs(float(metrics[key]) - float(j_metrics[key])) <= TOL, key
    want_norm = float(optax.global_norm(j_state.params))
    assert abs(float(ttp.global_norm(state.params)) - want_norm) <= TOL * want_norm

    new = ttp.gather_minilm_tp_params(state.params, cfg)
    mu = ttp.gather_minilm_tp_params(
        {k: [state.optimizer.state[t]["exp_avg"] for t in shards] for k, shards in state.params.items()}, cfg)
    j_new, j_mu = (tm.params_from_flax(jax.tree_util.tree_map(np.asarray, tree))
                   for tree in (j_state.params, j_state.opt_state[0].mu))
    for name, old in params.items():
        got, want = (new[name] - old).double(), (j_new[name] - old).double()
        if name.endswith("attention.key.bias"):
            assert float((got - want).abs().max()) <= 2 * LR, name
            continue
        assert float((got - want).norm()) <= UPDATE_RTOL * float(want.norm()), name
        g, jg = mu[name].double(), j_mu[name].double()
        assert float((g - jg).norm()) <= GRAD_RTOL * float(jg.norm()), name


@pytest.mark.parametrize("dp,tp", [(2, 2), (1, 4)])
def test_three_steps_equal_single_device_replay(flax_params, dp, tp):
    """AdamW's moments on shards, with the trainer's clip and decay:
    three steps on three batches against the encoder's own step."""
    _, cfg = _configs(1538)
    _, params = flax_params(1538)
    opt = tt.AdamW(tt.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 4), weight_decay=0.01, max_grad_norm=1.0)
    mesh = _t_mesh(dp, tp)
    state = tt.init_train_state(ttp.place_minilm_tp_params(params, mesh, cfg), opt)
    step = ttp.make_minilm_dp_tp_train_step(mesh, cfg, opt)
    model = tm.MiniLMEncoder(cfg)
    model.load_state_dict(params)
    ref_state = tt.init_train_state(model, opt)
    ref_step = tt.make_train_step(tm.minilm_apply, opt)
    for n in range(3):
        batch = _t_batch(_batch(2 * dp, 1538, seed=100 + n))
        state, metrics = step(state, batch)
        ref_state, ref_metrics = ref_step(ref_state, batch)
        for key in ("loss", "accuracy"):
            assert abs(float(metrics[key]) - float(ref_metrics[key])) <= TOL, (n, key)
    assert state.step == ref_state.step == 3
    ref_norm = float(tt.global_norm(ref_state.tensors()))
    assert abs(float(ttp.global_norm(state.params)) - ref_norm) <= TOL * ref_norm
    got = ttp.gather_minilm_tp_params(state.params, cfg)
    lr_sum = sum(opt.learning_rate(n) for n in range(3))
    for name, value in model.state_dict().items():
        err = float((got[name] - value).abs().max())
        assert err <= (2 * lr_sum if name.endswith("attention.key.bias") else TOL), (name, err)
    # The padding rows of the last word-table shard stay exactly zero.
    table = state.params["word_embeddings.weight"]
    pad_from = 1538 - (tp - 1) * table[0].shape[0]
    assert torch.equal(table[-1][pad_from:].detach(), torch.zeros(table[-1].shape[0] - pad_from, 384))


def test_step_runs_within_one_process(flax_params, monkeypatch):
    _, cfg = _configs(1538)
    _, params = flax_params(1538)
    mesh = _t_mesh(1, 2)
    opt = tt.AdamW(LR)
    state = tt.init_train_state(ttp.place_minilm_tp_params(params, mesh, cfg), opt)
    step = ttp.make_minilm_dp_tp_train_step(mesh, cfg, opt)
    monkeypatch.setattr(tmesh, "process_span", lambda: (0, 2))
    with pytest.raises(ValueError, match="runs within one process, not across 2"):
        step(state, _t_batch(_batch(2, 1538, seed=0)))
