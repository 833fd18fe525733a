"""The port's cell-sharded IVF (ragfin_tpu_torch.parallel.sharded_ivf)
against the JAX package's on the same index.

JAX's ``build_ivf`` clusters each corpus; ``ivf_from_numpy`` carries the
index into the port, so both sides scan identical cells. The JAX program
runs on conftest's virtual CPU mesh at P devices, the port's on the CPU
listed P times. Tolerances: scores within 1e-5 (f32 products in another
summation order; int8 cells are scaled in f32 on both sides) and ids equal
wherever neighbouring scores differ by more than 1e-5. Pad cells (a cell
count that the shard count does not divide) must never be probed or
returned.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ragfin_tpu.ops.ivf import build_ivf as j_build_ivf
from ragfin_tpu.parallel.mesh import make_mesh as j_make_mesh
from ragfin_tpu.parallel.sharded_ivf import shard_ivf_arrays as j_shard, sharded_ivf_topk as j_topk
from ragfin_tpu_torch.ops import ivf as tivf
from ragfin_tpu_torch.ops.topk import INT32_MAX
from ragfin_tpu_torch.parallel.mesh import make_mesh as t_make_mesh
from ragfin_tpu_torch.parallel.sharded_ivf import pad_cells_for_mesh, shard_ivf_arrays, sharded_ivf_topk

TOL = 1e-5
SHARDS = [1, 2, 4, 8]


def _clustered(seed=7, n=2048, d=64, n_centers=16):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * 4.0
    pts = np.concatenate(
        [c + 0.3 * rng.standard_normal((n // n_centers, d)).astype(np.float32) for c in centers]
    )
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    return pts[rng.permutation(n)].T.copy()  # [D, N]


def _port_index(jivf):
    return tivf.ivf_from_numpy(
        np.asarray(jivf.cells), None if jivf.scales is None else np.asarray(jivf.scales),
        np.asarray(jivf.centroids), np.asarray(jivf.orig_ids), jivf.n_valid, device="cpu",
    )


def _queries(ct, seed, n_q, noise=0.1):
    rng = np.random.default_rng(seed)
    base = ct.T[rng.integers(0, ct.shape[1], n_q)]
    q = base + noise * rng.standard_normal(base.shape).astype(np.float32)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _both(p, jivf, q, **kw):
    jm = j_make_mesh(("cells",), devices=jax.devices()[:p])
    tm = t_make_mesh(("cells",), devices=["cpu"] * p)
    cells, scales, ids, cents, n_real = j_shard(jm, "cells", jivf)
    want = j_topk(jm, "cells", jnp.asarray(q), cells, scales, ids, cents, n_cells_real=n_real, **kw)
    cells, scales, ids, cents, n_real = shard_ivf_arrays(tm, "cells", _port_index(jivf))
    got = sharded_ivf_topk(tm, "cells", torch.from_numpy(q), cells, scales, ids, cents,
                           n_cells_real=n_real, **kw)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


def _same(got, want):
    (gs, gi), (ws, wi) = got, want
    assert gi.dtype == np.int32 and gs.shape == ws.shape
    np.testing.assert_allclose(gs, ws, atol=TOL, rtol=0)
    gaps = np.abs(np.diff(ws.astype(np.float64), axis=1))
    inf = np.full((ws.shape[0], 1), np.inf)
    strict = (np.concatenate([inf, gaps], 1) > TOL) & (np.concatenate([gaps, inf], 1) > TOL)
    np.testing.assert_array_equal(gi[strict], wi[strict])


@pytest.fixture(scope="module")
def setup():
    ct = _clustered()
    return ct, j_build_ivf(jnp.asarray(ct), cell=128, iters=2)  # 16 cells


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("nprobe", [4, 16])
def test_matches_jax(setup, p, nprobe):
    ct, jivf = setup
    q = _queries(ct, 3, 16)
    want, got = _both(p, jivf, q, k=10, nprobe=nprobe, block_q=8)
    _same(got, want)


@pytest.mark.parametrize("p", [2, 8])
def test_exhaustive_equals_single_device(setup, p):
    """nprobe == n_cells: the sharded scan equals the port's single-device
    IVF tier (its pruned kernel's plain version) over the same index."""
    ct, jivf = setup
    q = _queries(ct, 3, 16)
    index = _port_index(jivf)
    tm = t_make_mesh(("cells",), devices=["cpu"] * p)
    arrays = shard_ivf_arrays(tm, "cells", index)
    got = sharded_ivf_topk(tm, "cells", torch.from_numpy(q), *arrays[:4], k=10,
                           nprobe=index.n_cells, block_q=8, n_cells_real=arrays[4])
    want = tivf.ivf_topk(torch.from_numpy(q), index, 10, nprobe=index.n_cells, block_q=8,
                         precision="exact")
    _same([x.numpy() for x in got], [x.numpy() for x in want])


def test_pruned_recall(setup):
    ct, jivf = setup
    q = _queries(ct, 5, 32)
    exact = np.argsort(-(q @ ct), axis=1)[:, :10]
    _, (_, got) = _both(8, jivf, q, k=10, nprobe=4, block_q=8)
    recall = np.mean([len(set(got[r]) & set(exact[r])) / 10 for r in range(len(q))])
    assert recall >= 0.85, f"sharded pruned recall {recall}"


@pytest.mark.parametrize("p", [2, 8])
def test_int8_cells(p):
    ct = _clustered(seed=9)
    jivf = j_build_ivf(jnp.asarray(ct), cell=128, iters=2, quantize=True)
    q = _queries(ct, 4, 8, noise=0.0)
    want, got = _both(p, jivf, q, k=5, nprobe=jivf.n_cells, block_q=8)
    _same(got, want)


@pytest.mark.parametrize("p", [4, 8])
def test_cell_padding_to_mesh(p):
    """10 cells over 4 or 8 shards: pad cells can never win."""
    ct = _clustered(seed=11, n=1280, n_centers=10)
    jivf = j_build_ivf(jnp.asarray(ct), cell=128, iters=1)
    cells, scales, ids, c_total = pad_cells_for_mesh(_port_index(jivf), p)
    assert c_total % p == 0 and cells.shape[0] == c_total and (ids[10:] == INT32_MAX).all()
    q = (ct.T[:4] / np.linalg.norm(ct.T[:4], axis=1, keepdims=True)).astype(np.float32)
    want, got = _both(p, jivf, q, k=5, nprobe=c_total, block_q=4)
    _same(got, want)
    assert got[1].max() < ct.shape[1] and list(got[1][:, 0]) == [0, 1, 2, 3]


def test_pad_cells_never_steal_probes():
    """Queries with negative coordinate sums, pruned probing, pad cells
    present: every query still retrieves (JAX's round-3 regression)."""
    rng = np.random.default_rng(13)
    d, n = 32, 1280  # 10 cells of 128 -> 6 pads over 8 shards
    pts = rng.standard_normal((n, d)).astype(np.float32) - 0.5
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    jivf = j_build_ivf(jnp.asarray(pts.T.copy()), cell=128, iters=1)
    q = pts[:8]
    assert float(q.sum(axis=1).min()) < 0
    want, got = _both(8, jivf, q, k=5, nprobe=6, block_q=4)
    _same(got, want)
    assert (got[1][:, 0] < n).all()
    assert (got[1][:, 0] == np.arange(8)).mean() >= 0.75
