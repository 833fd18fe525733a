"""The port's merge cases (ragfin_tpu_torch.ops.merge_cases) against the
Pallas cases of scripts/mosaic_bisect.py, run in interpret mode with the
script's own specs (the script is imported by path and not changed), bit for
bit, on seeded tiles: uniform values, the script's all-ones tile, heavy ties,
and columns of -inf. The four cases of the queue selection (queue push,
bitonic sort, bitonic merge, pass 2's bound filter) have no Pallas
counterpart: their plain versions are held against numpy on the same tiles.
On the card, chip_smoke.py and scripts/mosaic_bisect_torch.py hold the CUDA
kernels against the same plain versions."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ragfin_tpu_torch.ops import merge_cases as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bisect_module():
    spec = importlib.util.spec_from_file_location(
        "mosaic_bisect", os.path.join(ROOT, "scripts", "mosaic_bisect.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MB = _bisect_module()


def _jax_case(name, x):
    """scripts/mosaic_bisect.py:_run with the tile as input, in interpret mode."""
    kern, scratch = MB.CASES[name]
    out = pl.pallas_call(
        kern,
        grid=(1,),
        in_specs=[pl.BlockSpec((MB.TQ, MB.TN), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((MB.TQ, 128), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((MB.TQ, 128), jnp.float32),
        scratch_shapes=list(scratch),
        interpret=True,
    )(jnp.asarray(x))
    return np.asarray(out)


def _tile(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.random((64, 256), dtype=np.float32)
    if kind == "ones":
        return np.ones((64, 256), np.float32)
    if kind == "ties":
        # Five values only: every row max and most walk steps are ties.
        return rng.choice(np.array([0.0, 0.25, 0.5, 0.75, 1.0], np.float32), (64, 256))
    x = rng.random((64, 256), dtype=np.float32)  # -inf columns, across both sub-blocks
    x[:, rng.choice(256, 40, replace=False)] = -np.inf
    x[:, 1] = -np.inf
    x[rng.choice(64, 8, replace=False), 128:] = -np.inf  # rows with an all -inf sub-block
    return x


TILES = [("uniform", 0), ("uniform", 1), ("ones", 0), ("ties", 2), ("ties", 3), ("neginf", 4)]


def test_case_names_match_the_script():
    assert tuple(MB.CASES) == M.PALLAS_CASES
    assert M.CASES == M.PALLAS_CASES + M.NEW_CASES and not set(M.NEW_CASES) & set(MB.CASES)
    assert (MB.TQ, MB.TN, MB.SUB) == (M.TQ, M.TN, M.SUB)


@pytest.mark.parametrize("name", M.PALLAS_CASES)
@pytest.mark.parametrize("kind,seed", TILES)
def test_plain_equals_pallas_case_bitwise(name, kind, seed):
    x = _tile(kind, seed)
    want = _jax_case(name, x)
    got = M.merge_case(name, torch.from_numpy(x))  # CPU tensor: the plain version
    assert got.shape == (64, 128) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _best_numpy(x, k, first_id=0):
    """Each row's best k in (score desc, id asc) order, as lexsort gives it."""
    ids = np.broadcast_to(np.arange(x.shape[1]), x.shape)
    order = np.lexsort((ids, -x.astype(np.float64)), axis=1)[:, :k]
    return np.take_along_axis(x, order, 1), order + first_id


def _queue_case_numpy(name, x):
    out = np.zeros((64, 128), np.float32)
    if name == "queue_push":
        return ((x[:, :128] > 0.5).astype(np.float32) + 2 * (x[:, 128:] > 0.5)).astype(np.float32)
    if name in ("bitonic_sort", "bitonic_merge"):
        s, i = _best_numpy(x, 64)
        out[:, :64], out[:, 64:] = i, s
        return out
    parts = [_best_numpy(x[:, c * 64 : (c + 1) * 64], 16, c * 64) for c in range(4)]
    bound = np.max([s[:, 15] for s, _ in parts], axis=0)
    for r in range(64):
        surv = sorted((-float(s), int(i)) for ps, pi in parts for s, i in zip(ps[r], pi[r])
                      if s > -np.inf and s >= bound[r])
        top = surv[:16] + [(np.inf, 0x7FFFFFFF)] * (16 - min(16, len(surv)))
        out[r, :16] = [i for _, i in top]
        out[r, 16:32] = [-s for s, _ in top]
        out[r, 32], out[r, 33] = bound[r], len(surv)
    return out


@pytest.mark.parametrize("name", M.NEW_CASES)
@pytest.mark.parametrize("kind,seed", TILES)
def test_queue_cases_plain_equals_numpy(name, kind, seed):
    """The selection's cases: what each keeps (ties by the lower id, -inf
    entries after every real one, the bound filter's survivors) against
    numpy's lexsort on the same tile, bitwise."""
    x = _tile(kind, seed)
    got = M.merge_case(name, torch.from_numpy(x))  # CPU tensor: the plain version
    np.testing.assert_array_equal(got.numpy(), _queue_case_numpy(name, x))


@pytest.mark.parametrize("first", [-np.inf, np.inf, -3.7, 0.2, 1.9, 5.0])
@pytest.mark.parametrize("name", ["bufload", "retire"])
def test_runtime_block_index_saturates_and_clamps(name, first):
    """int(x[0, 0]) saturates (-inf -> INT32_MIN); a dynamic slice clamps the
    index into range, the retire compare matches no block out of range."""
    x = _tile("uniform", 5)
    x[0, 0] = first
    np.testing.assert_array_equal(M.merge_case_plain(name, torch.from_numpy(x)).numpy(),
                                  _jax_case(name, x))


def test_wrapper_validates_and_counts_only_launches():
    before = M.merge_case.launches
    x = torch.zeros((64, 256))
    M.merge_case("submax", x)
    assert M.merge_case.launches == before
    with pytest.raises(ValueError, match="unknown merge case"):
        M.merge_case("nested", x)
    with pytest.raises(ValueError, match="tile"):
        M.merge_case("submax", torch.zeros((64, 128)))
    with pytest.raises(ValueError, match="tile"):
        M.merge_case("submax", x.double())
    with pytest.raises(ValueError, match="CUDA card or the CPU"):
        M.merge_case("submax", x.to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", M.CASES)
def test_kernel_equals_plain_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU has no kernel to launch")
    for kind, seed in TILES:
        x = torch.from_numpy(_tile(kind, seed))
        before = M.merge_case.launches
        got = M.merge_case(name, x.cuda())
        torch.cuda.synchronize()
        assert M.merge_case.launches == before + 1
        assert torch.equal(got.cpu(), M.merge_case_plain(name, x)), (name, kind, seed)
