"""Data- and tensor-parallel (dp x tp) MiniLM encoder and its InfoNCE step.

Counterpart of stage 1 of ``__graft_entry__.dryrun_multichip``. The JAX
package has no module for it: GSPMD builds that program from the shardings
of ``_param_spec`` (``__graft_entry__.py:43-57``). Here the program is
written out over a :class:`~.mesh.Mesh` with a ``dp`` and a ``tp`` axis:

- the parameters: the 1536-wide FFN weights and the word table are split
  over tp (:func:`tp_split_dim`), everything else is replicated. A split
  whose size does not divide by tp is padded at its end with zero rows,
  which no id reaches: their gradient is 0, so AdamW keeps them 0;
- each dp group encodes its rows of the batch. The word lookup is
  vocabulary-parallel: each tp shard looks up the ids of its row range,
  zeros the others, and a psum over tp adds exact zeros, so the rows equal
  the whole table's. Attention, the LayerNorms and the pooling run once per
  dp group on its first device. ``intermediate`` runs column-parallel and
  ``ffn_output`` row-parallel: the partial products are summed in f32 over
  tp, cast once to the activation dtype, and the bias is added once after
  the sum;
- the step gathers both sides' embeddings over dp (the in-batch negatives
  are the global batch) and takes the loss on the mesh's first device
  (``models.training.make_train_step``).

Every piece computes what ``models/minilm.py`` computes. The program runs
within one process.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..models.minilm import MiniLMConfig, MiniLMEncoder, _linear, _normalize, attend, embed_rows, pool_tokens
from ..models.training import AdamW, global_norm as _global_norm, make_train_step
from .mesh import Mesh, all_gather, on_device, psum, require_one_process

Placed = dict[str, list[torch.Tensor]]

_SPLIT_MIN = 1536  # _param_spec's width, on Flax's layout
# The splits the forward implements: the entry (without "layers.{i}.") and its dim.
_SPLITS = {"word_embeddings.weight": 0, "intermediate.weight": 0, "ffn_output.weight": 1}


def _role(name: str) -> str:
    return name.split(".", 2)[2] if name.startswith("layers.") else name


def _is_linear_weight(name: str) -> bool:
    return name.startswith("layers.") and name.endswith(".weight") and "norm" not in name


def tp_split_dim(name: str, shape: Sequence[int]) -> Optional[int]:
    """The dim of the encoder entry ``name`` (of ``shape``) that is split
    over tp, or None where it is replicated.

    The port's copy of ``__graft_entry__._param_spec``, which follows that
    function's code and not its docstring: a 2-D leaf whose Flax shape has
    a dim of at least 1536 is split on it (dim 1 first), all else is
    replicated. So the word table ``[V, H]`` splits by vocabulary rows when
    V >= 1536 (the docstring says by H), and the position and type tables
    and every 1-D entry stay replicated. Flax's Dense kernels are ``[in,
    out]`` and the port's Linear weights ``[out, in]``, so the dim is mapped
    through the transpose: ``intermediate.weight [1536, 384]`` splits on
    dim 0 (column-parallel), ``ffn_output.weight [384, 1536]`` on dim 1
    (row-parallel)."""
    if len(shape) != 2:
        return None
    linear = _is_linear_weight(name)
    flax_shape = tuple(shape)[::-1] if linear else tuple(shape)
    for dim in (1, 0):
        if flax_shape[dim] >= _SPLIT_MIN:
            return 1 - dim if linear else dim
    return None


def _split_dim(name: str, shape) -> Optional[int]:
    dim = tp_split_dim(name, shape)
    if dim is not None and _SPLITS.get(_role(name)) != dim:
        raise ValueError(f"{name} {tuple(shape)}: the tp encoder splits only the word table and the FFN")
    return dim


def place_minilm_tp_params(params: dict, mesh: Mesh, config: MiniLMConfig, tp_axis: str = "tp") -> Placed:
    """An encoder ``state_dict`` as lists of shards: a split entry becomes
    tp parts (the last padded with zero rows where tp does not divide it),
    part j on the j-th device of ``tp_axis``; a replicated entry one copy on
    the mesh's first device. Every shard is a copy. ``config`` is the
    encoder's; :func:`gather_minilm_tp_params` inverts this."""
    devices = mesh.axis_devices(tp_axis)
    n = len(devices)
    expected = _shapes(config)
    if set(params) != set(expected):
        raise ValueError(f"not a {config.num_layers}-layer encoder state_dict: {sorted(set(params) ^ set(expected))}")
    placed = {}
    for name, t in params.items():
        t = t.detach()
        dim = _split_dim(name, t.shape)
        if dim is None:
            placed[name] = [_copy(t, devices[0])]
            continue
        pad = -t.shape[dim] % n
        if pad:
            shape = list(t.shape)
            shape[dim] = pad
            t = torch.cat([t, t.new_zeros(shape)], dim)
        placed[name] = [_copy(p, d) for p, d in zip(torch.chunk(t, n, dim), devices)]
    return placed


def _copy(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t.to(device, copy=True, memory_format=torch.contiguous_format)


def _shapes(config: MiniLMConfig) -> dict[str, torch.Size]:
    with torch.device("meta"):
        return {k: v.shape for k, v in MiniLMEncoder(config).state_dict().items()}


def gather_minilm_tp_params(placed: Placed, config: MiniLMConfig) -> dict[str, torch.Tensor]:
    """The whole ``state_dict`` back from :func:`place_minilm_tp_params`'s
    shards (padding dropped), on the first shard's device, detached."""
    out = {}
    for name, shape in _shapes(config).items():
        shards = placed[name]
        dim = _split_dim(name, shape)
        if dim is None:
            out[name] = shards[0].detach().clone()
        else:
            whole = torch.cat([s.detach().to(shards[0].device) for s in shards], dim)
            out[name] = whole.narrow(dim, 0, shape[dim]).contiguous()
    return out


def global_norm(placed: Placed) -> torch.Tensor:
    """The L2 norm of all the encoder's parameters, each counted once: a
    replicated entry is held once and padding rows are zero."""
    return _global_norm([t for shards in placed.values() for t in shards])


def make_minilm_tp_forward(mesh: Mesh, config: MiniLMConfig, dp_axis: str = "dp", tp_axis: str = "tp"):
    """Build ``forward(placed, input_ids [B, S], attention_mask [B, S]) ->
    unit embeddings [B, H]`` on the mesh's first device: the batch split
    over ``dp_axis`` by rows, the parameters as
    :func:`place_minilm_tp_params` lays them out over ``tp_axis``."""
    n_dp, n_tp = mesh.shape[dp_axis], mesh.shape[tp_axis]
    axes = mesh.axis_names
    grid = [[mesh.devices[tuple(r if a == dp_axis else j if a == tp_axis else 0 for a in axes)]
             for j in range(n_tp)] for r in range(n_dp)]
    cfg, dt, eps = config, config.dtype, config.layer_norm_eps

    def encode(placed: Placed, devs: list, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """One dp group's rows, on its devices ``devs`` (one per tp shard)."""
        home = devs[0]
        # A weight moved to each device that uses it: on other devices
        # `.to()` is a copy that autograd differentiates, so the weight's
        # gradient is the sum over every shard and dp group it reached (the
        # psum over dp x tp that GSPMD inserts); on the same device it is
        # the weight itself.
        p = {name: [t.to(d) for t, d in zip(shards, devs)] for name, shards in placed.items()}
        one = {name: shards[0] for name, shards in p.items()}
        ids, mask = ids.to(home), mask.to(home).bool()

        # Vocabulary-parallel lookup: ids outside a shard's rows (and its
        # padding) read row 0 and are zeroed; the psum adds exact zeros.
        table = p["word_embeddings.weight"]
        rows = table[0].shape[0]
        words = []
        for j, (t, d) in enumerate(zip(table, devs)):
            with on_device(d):
                local = ids.to(d) - j * rows
                hit = (local >= 0) & (local < min(rows, cfg.vocab_size - j * rows))
                e = F.embedding(torch.where(hit, local, 0), t.to(dt))
                words.append(torch.where(hit[..., None], e, torch.zeros((), dtype=dt, device=d)))
        positions = torch.arange(ids.shape[1], device=home)
        x = embed_rows(one, psum(words, home), positions, cfg)

        for i in range(cfg.num_layers):
            w = {name[len(f"layers.{i}."):]: t for name, t in one.items() if name.startswith(f"layers.{i}.")}

            def dense(n, h):
                return _linear(h, w[f"{n}.weight"], w[f"{n}.bias"])

            ctx = attend(cfg, dense("attention.query", x), dense("attention.key", x),
                         dense("attention.value", x), mask)
            x = _normalize(x + dense("attention.output", ctx), w["attention_norm.weight"],
                           w["attention_norm.bias"], eps, dt)
            w_in, w_out = p[f"layers.{i}.intermediate.weight"], p[f"layers.{i}.ffn_output.weight"]
            width = w_in[0].shape[0]
            b_in = F.pad(w["intermediate.bias"], (0, width * len(w_in) - cfg.intermediate_size))
            partials = []
            for j, (a, c, d) in enumerate(zip(w_in, w_out, devs)):
                with on_device(d):
                    h = F.gelu(_linear(x.to(d), a, b_in[j * width:(j + 1) * width].to(d)))
                    partials.append(F.linear(h, c.to(dt)).float())
            # Row-parallel: the f32 sum over tp, one cast, the bias once.
            y = psum(partials, home).to(dt) + w["ffn_output.bias"].to(dt)
            x = _normalize(x + y, w["ffn_norm.weight"], w["ffn_norm.bias"], eps, dt)
        return pool_tokens(x, mask, cfg)

    def forward(placed: Placed, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        require_one_process("the dp x tp encoder")
        b = input_ids.shape[0]
        if b % n_dp:
            raise ValueError(f"batch {b} does not split over dp={n_dp}")
        rows = b // n_dp
        out = []
        for r, devs in enumerate(grid):
            with on_device(devs[0]):
                out.append(encode(placed, devs, input_ids[r * rows:(r + 1) * rows],
                                  attention_mask[r * rows:(r + 1) * rows]))
        return all_gather(out, grid[0][0])

    return forward


def make_minilm_dp_tp_train_step(mesh: Mesh, config: MiniLMConfig, optimizer: AdamW, temperature: float = 0.05):
    """``(state, batch) -> (state, metrics)``, the contract of
    ``models.training.make_train_step``, over a state whose ``params`` are
    :func:`place_minilm_tp_params`' shards (``init_train_state(placed,
    optimizer)``). Both sides are encoded per dp group and gathered over dp;
    the loss and the accuracy (over the global batch) are taken on the
    mesh's first device. AdamW steps each shard (it is elementwise), and a
    global-norm clip counts each parameter once."""
    forward = make_minilm_tp_forward(mesh, config)
    return make_train_step(lambda placed, side: forward(placed, side["input_ids"], side["attention_mask"]),
                           optimizer, temperature)
