"""The port's row-sharded graph match (ragfin_tpu_torch.parallel.
sharded_graph) against the JAX package's on the same seeded fact table.

Both packages build the same store; the JAX view runs on conftest's virtual
CPU mesh at P devices, the port's on the CPU listed P times. The gate is
exact: equal result rows (CSR order, every field) and equal hit counts,
also equal to the single-device ``GraphIndex.match``. The port's shards
take the first-k route from ``FIRST_K_MIN_ROWS`` rows (its plain version
here) and the rank top-k below it; both are held to JAX.
"""

import numpy as np
import pytest

import jax
import torch

from ragfin_tpu.index.graph_index import METRIC, RATIO, GraphIndex as JGraph
from ragfin_tpu.parallel.mesh import make_mesh as j_make_mesh
from ragfin_tpu.parallel.sharded_graph import ShardedGraphIndex as JSharded
from ragfin_tpu_torch.index.graph_index import GraphIndex as TGraph
from ragfin_tpu_torch.parallel import sharded_graph as tsg
from ragfin_tpu_torch.parallel.mesh import make_mesh as t_make_mesh

MATCH_CASES = [
    dict(names=["Net Profit"], limit=10),
    dict(quarters=["Q1_FY2024"], limit=30),
    dict(quarters=["Q2_FY2023", "Q3_FY2023"], types=[METRIC], limit=16),
    dict(types=[RATIO], limit=50),
    dict(names=["Metric 7", "Metric 12"], quarters=["Q4_FY2022"], limit=30),
    dict(limit=25),  # unmasked: first 25 rows in CSR order
    dict(names=["No Such Entity"], limit=10),  # empty result
    dict(names=["Metric 3"], companies=["Other Bank"], limit=20),
    dict(companies=["ICICI Bank"], limit=5),
    dict(companies=["No Bank"], limit=5),
]
SHARDS = [1, 2, 4, 8]


def _fill(g):
    rng = np.random.default_rng(3)
    quarters = [f"Q{q}_FY{y}" for y in range(2022, 2025) for q in range(1, 5)]
    qv = g.intern_quarters(quarters)
    ev = g.intern_entities([f"Metric {i}" for i in range(31)] + ["Net Profit"])
    n = 4000
    for company, rows in (("ICICI Bank", n - 300), ("Other Bank", 300)):
        g.add_facts_bulk(
            quarter_ids=qv[rng.integers(0, len(qv), rows)],
            entity_ids=ev[rng.integers(0, len(ev), rows)],
            type_ids=rng.integers(0, 4, rows).astype(np.int32),
            values=rng.uniform(1, 1e5, rows).astype(np.float32),
            dataset_id="synthetic", company=company,
        )
    return g


@pytest.fixture(scope="module")
def graphs():
    return _fill(JGraph()), _fill(TGraph(device="cpu"))


@pytest.fixture(scope="module")
def views(graphs):
    jg, tg = graphs
    out = {}
    for p in SHARDS:
        out[p] = (
            JSharded(jg, mesh=j_make_mesh(("shards",), devices=jax.devices()[:p]), axis="shards"),
            tsg.ShardedGraphIndex(tg, mesh=t_make_mesh(("shards",), devices=["cpu"] * p), axis="shards"),
        )
    return out


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("kwargs", MATCH_CASES)
def test_match_equals_jax(graphs, views, p, kwargs):
    jg, tg = graphs
    jv, tv = views[p]
    got = tv.match(**kwargs)
    assert got == jv.match(**kwargs) == jg.match(**kwargs)
    assert got == tg.match(**kwargs)


@pytest.mark.parametrize("p", SHARDS)
def test_rows_and_count_equal_jax(views, p):
    jv, tv = views[p]
    for kwargs in (dict(names=["Net Profit"], limit=10), dict(types=[METRIC], limit=20)):
        j_rows, j_valid, j_count = (np.asarray(x) for x in jv.match_rows(**kwargs))
        t_rows, t_valid, t_count = (x.numpy() for x in tv.match_rows(**kwargs))
        np.testing.assert_array_equal(t_valid, j_valid)
        np.testing.assert_array_equal(t_rows[t_valid], j_rows[j_valid])
        assert int(t_count) == int(j_count) > kwargs["limit"]
        assert (np.diff(t_rows[t_valid]) > 0).all()  # ascending global CSR rank


@pytest.mark.parametrize("p", [1, 4])
def test_first_k_route_equals_jax(graphs, monkeypatch, p):
    """Shards of at least FIRST_K_MIN_ROWS rows select with masked_first_k."""
    jg, tg = graphs
    calls = []
    real = tsg.masked_first_k
    monkeypatch.setattr(tsg, "FIRST_K_MIN_ROWS", 256)
    monkeypatch.setattr(tsg, "masked_first_k", lambda hit, k: calls.append(k) or real(hit, k))
    tv = tsg.ShardedGraphIndex(tg, mesh=t_make_mesh(("shards",), devices=["cpu"] * p))
    for kwargs in MATCH_CASES:
        assert tv.match(**kwargs) == jg.match(**kwargs)
    assert len(calls) == p * len(MATCH_CASES)


def test_default_mesh(graphs):
    """JAX's default mesh raises TypeError (it calls ``make_mesh(axis_name=
    ...)``); the port's is every CUDA device: it matches on a card and
    refuses to run without one."""
    jg, tg = graphs
    with pytest.raises(TypeError):
        JSharded(jg)
    if torch.cuda.is_available():
        assert tsg.ShardedGraphIndex(tg).match(limit=7) == tg.match(limit=7)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsg.ShardedGraphIndex(tg)


def test_empty_graph():
    mesh = t_make_mesh(("shards",), devices=["cpu"] * 2)
    assert tsg.ShardedGraphIndex(TGraph(device="cpu"), mesh=mesh).match(limit=5) == []
