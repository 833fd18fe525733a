"""The single-device entry and a multi-device dryrun of the parallel layer.

:func:`entry` is the counterpart of ``__graft_entry__.py:entry``: the
flagship encoder's forward and its example arguments.

:func:`dryrun_multichip` is the counterpart of
``__graft_entry__.py:dryrun_multichip`` (stages 1-6) at tiny shapes. Every
stage runs a parallel program over an ``n_devices`` mesh and asserts it
against the single-device path:

1. one InfoNCE training step of the MiniLM encoder (real widths, 2 layers,
   f32) over a dp x tp mesh (:mod:`.minilm_tp`) gives the loss and accuracy
   of the single-device step within 1e-5, and the parameters' global norm
   after it within 1e-5 relative;
2. the pipeline-parallel (pp = 2, with dp over the rest) MiniLM forward
   equals the encoder, and one pp train step gives a finite loss;
3. the corpus-sharded exact top-k retrieves each query's own column;
4. the cell-sharded IVF does the same at full probe;
5. the sequence-parallel MiniLM forward equals the encoder;
6. the row-sharded graph match equals ``GraphIndex.match``, and
   ``ops.fusion.fuse_results`` fuses the sharded vector and graph results.

The default devices are the card(s), listed as often as needed to fill the
mesh; it raises without a card unless ``devices`` (e.g. ``["cpu"] * 4``)
are given.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device


def entry(config=None, device: DeviceLike = None):
    """``(fn, example_args)`` for one forward of the flagship model: the
    MiniLM-class encoder at ``MiniLMConfig()`` (bf16 activations) with
    ``init_params(config, seed=0, seq_len=32)``, on a batch of 8 x 32 token
    ids drawn by ``np.random.default_rng(0)`` and a full attention mask.
    ``fn(params, input_ids, attention_mask)`` runs the module with the given
    ``state_dict`` (``torch.func.functional_call``), as the JAX entry's
    ``model.apply(params, ...)`` does. The arguments lie on the card unless
    ``device`` asks for the CPU; ``config`` overrides the model's (the f32
    reference of a check)."""
    from ..models.minilm import MiniLMConfig, MiniLMEncoder, init_params

    dev = resolve_device(device)
    config = config or MiniLMConfig()
    model = MiniLMEncoder(config).to(dev).eval()
    params = {name: t.to(dev) for name, t in init_params(config, seed=0, seq_len=32).items()}

    def forward(params, input_ids, attention_mask):
        with torch.inference_mode():
            return torch.func.functional_call(model, params, (input_ids, attention_mask))

    batch, seq = 8, 32
    ids = np.random.default_rng(0).integers(0, config.vocab_size, (batch, seq))
    input_ids = torch.from_numpy(ids.astype(np.int64)).to(dev)
    attention_mask = torch.ones((batch, seq), dtype=torch.int32, device=dev)
    return forward, (params, input_ids, attention_mask)


def dryrun_multichip(n_devices: int, devices: Optional[Sequence[DeviceLike]] = None) -> None:
    from ..index.graph_index import METRIC, GraphIndex
    from ..models.minilm import MiniLMConfig, MiniLMEncoder, init_params, minilm_apply
    from ..models.training import AdamW, global_norm as module_norm, init_train_state, make_train_step
    from ..ops.fusion import fuse_results
    from ..ops.ivf import build_ivf
    from .mesh import factor_mesh_shape, make_mesh, shard
    from .minilm_pipeline import make_minilm_pp_forward, make_minilm_pp_train_step, place_minilm_pp_params
    from .minilm_tp import global_norm, make_minilm_dp_tp_train_step, place_minilm_tp_params
    from .minilm_sp import make_minilm_sp_forward
    from .sharded import sharded_cosine_topk
    from .sharded_graph import ShardedGraphIndex
    from .sharded_ivf import shard_ivf_arrays, sharded_ivf_topk

    if devices is None:
        resolve_device(None)  # raises without a card
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count) for i in range(n_devices)]
    devices = [resolve_device(d) for d in devices][:n_devices]
    if len(devices) < n_devices:
        raise ValueError(f"{len(devices)} devices for a {n_devices}-device dryrun")
    first = devices[0]
    rng = np.random.default_rng(0)

    def check(ok, msg: str) -> None:
        if not ok:
            raise AssertionError(msg)

    def encoder(cfg, params):
        model = MiniLMEncoder(cfg).to(first)
        model.load_state_dict(params)
        return model.eval()

    # ---- 1. full contrastive training step, dp x tp sharded --------------
    dp, tp = factor_mesh_shape(n_devices, 2)
    mesh = make_mesh(("dp", "tp"), (dp, tp), devices=devices)
    config = MiniLMConfig(num_layers=2, dtype=torch.float32)  # tiny depth, real widths
    params = init_params(config, seed=0)
    optimizer = AdamW(1e-4)  # optax.adamw(1e-4)
    batch_size, seq = 2 * dp, 16
    batch = {side: {"input_ids": torch.from_numpy(rng.integers(0, config.vocab_size, (batch_size, seq))).to(first),
                    "attention_mask": torch.ones((batch_size, seq), dtype=torch.int64, device=first)}
             for side in ("query", "doc")}
    state, metrics = make_minilm_dp_tp_train_step(mesh, config, optimizer)(
        init_train_state(place_minilm_tp_params(params, mesh, config), optimizer), batch)
    check(torch.isfinite(metrics["loss"]), "training step produced a non-finite loss")
    # The single-device replay of the same batch.
    ref_state, ref_metrics = make_train_step(minilm_apply, optimizer)(
        init_train_state(encoder(config, params).train(), optimizer), batch)
    for key in ("loss", "accuracy"):
        check(abs(float(metrics[key]) - float(ref_metrics[key])) <= 1e-5,
              f"dp x tp {key} {float(metrics[key])} diverged from the single-device {float(ref_metrics[key])}")
    norm, ref_norm = float(global_norm(state.params)), float(module_norm(ref_state.tensors()))
    check(abs(norm - ref_norm) <= 1e-5 * abs(ref_norm),
          f"dp x tp post-step parameter norm {norm} diverged from the single-device {ref_norm}")
    del state, ref_state

    # ---- 2. pipeline-parallel MiniLM train step over a pp(+dp) mesh ------
    if n_devices >= 2 and n_devices % 2 == 0:
        pp, pp_dp = 2, n_devices // 2
        pp_cfg = MiniLMConfig(
            vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=16, dtype=torch.float32,
        )
        pp_mesh = make_mesh(("pp", "dp"), (pp, pp_dp), devices=devices)
        params = init_params(pp_cfg, seed=2)
        m, b, s = 2, 2 * pp_dp, 12
        ids = torch.from_numpy(rng.integers(1, pp_cfg.vocab_size, (m, b, s))).to(first)
        amask = torch.ones((m, b, s), dtype=torch.int32, device=first)
        placed = place_minilm_pp_params(params, pp_mesh, pp_cfg)
        with torch.no_grad():
            out_pp = make_minilm_pp_forward(pp_mesh, pp_cfg, dp_axis="dp")(placed, ids, amask)
            ref = encoder(pp_cfg, params)(ids[0], amask[0])
        torch.testing.assert_close(out_pp[0], ref, atol=1e-5, rtol=0)
        step = make_minilm_pp_train_step(pp_mesh, pp_cfg, dp_axis="dp")
        targets = torch.zeros((m, b, pp_cfg.hidden_size), device=first)
        _, loss = step(placed, ids, amask, targets)
        check(torch.isfinite(loss), "pp-MiniLM step produced a non-finite loss")

    # ---- 3. corpus-sharded exact top-k over a 1-D mesh -------------------
    mesh1d = make_mesh(("data",), devices=devices)
    n, d, q, k = 64 * n_devices, 128, 4, 5
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = torch.from_numpy(corpus[:q]).to(first)  # self-queries: top-1 is the identity
    ct = torch.from_numpy(corpus.T.copy()).to(first)
    _, top_ids = sharded_cosine_topk(mesh1d, "data", queries, shard(mesh1d, "data", ct, 1), k,
                                     n_valid=n, method="dense")
    check(top_ids[:, 0].tolist() == list(range(q)), f"sharded top-1 self-retrieval: {top_ids[:, 0]}")

    # ---- 4. cell-sharded IVF over the same mesh ---------------------------
    ivf = build_ivf(ct, cell=32, iters=1)  # 2P cells
    cells, scales, cell_ids, centroids, n_real = shard_ivf_arrays(mesh1d, "data", ivf)
    _, ivf_ids = sharded_ivf_topk(mesh1d, "data", queries, cells, scales, cell_ids, centroids,
                                  k=k, nprobe=ivf.n_cells, block_q=4, n_cells_real=n_real)
    check(ivf_ids[:, 0].tolist() == list(range(q)), f"sharded-IVF top-1 self-retrieval: {ivf_ids[:, 0]}")

    # ---- 5. sequence-parallel MiniLM forward ------------------------------
    sp_mesh = make_mesh(("sp",), devices=devices)
    sp_cfg = MiniLMConfig(
        vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
        intermediate_size=64, max_position=8 * n_devices, dtype=torch.float32,
    )
    sp_params = init_params(sp_cfg, seed=4)
    s_len = 4 * n_devices
    sp_ids = torch.from_numpy(rng.integers(1, sp_cfg.vocab_size, (2, s_len))).to(first)
    sp_mask = torch.ones((2, s_len), dtype=torch.int32, device=first)
    out_sp = make_minilm_sp_forward(sp_mesh, sp_cfg)(sp_params, sp_ids, sp_mask)
    with torch.no_grad():
        ref_sp = encoder(sp_cfg, sp_params)(sp_ids, sp_mask)
    torch.testing.assert_close(out_sp, ref_sp, atol=1e-5, rtol=0)

    # ---- 6. row-sharded graph match + fusion over sharded results --------
    g = GraphIndex(device=first)
    g_quarters = [f"Q{qq}_FY{y}" for y in (2023, 2024) for qq in range(1, 5)]
    qv = g.intern_quarters(g_quarters)
    ev = g.intern_entities([f"Metric {i}" for i in range(9)] + ["Net Profit"])
    ng = 96 * n_devices
    g.add_facts_bulk(
        quarter_ids=qv[rng.integers(0, len(qv), ng)],
        entity_ids=ev[rng.integers(0, len(ev), ng)],
        type_ids=rng.integers(0, 4, ng).astype(np.int32),
        values=rng.uniform(1, 1e5, ng).astype(np.float32),
        dataset_id="dryrun",
    )
    sharded_g = ShardedGraphIndex(g, mesh=mesh1d, axis="data")
    for match_kwargs in (
        dict(names=["Net Profit"], limit=8),
        dict(quarters=["Q1_FY2024", "Q2_FY2024"], types=[METRIC], limit=16),
    ):
        check(sharded_g.match(**match_kwargs) == g.match(**match_kwargs),
              f"sharded graph match diverged from single-device for {match_kwargs}")
    rows, valid, _ = sharded_g.match_rows(names=["Net Profit"], limit=8)
    graph_rows = torch.where(valid, rows, torch.full_like(rows, -1))
    fused_rows, origin = fuse_results(top_ids[:, :k], graph_rows, k_out=k + 4)
    check(bool((origin[:, 0] == 0).all()), "vector hits must lead fusion")
    check(bool((fused_rows[:, 0] == top_ids[:, 0]).all()), "fusion dropped the top vector hit")
