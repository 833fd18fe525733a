"""The port's graph store against the JAX package's, on the CPU.

``masked_first_k``: the port's plain version against the JAX Pallas kernel
in interpret mode, exact equality. ``GraphIndex``: both sides are built from
the same ``rule_based_extract`` output over 300 generated filings of several
banks (and from the same bulk arrays for the first-k route, which starts at
2^18 padded rows); every query returns equal dicts, the aggregate's mean
agrees within 1e-5 relative (f32 sums in another order), and a store saved
by either package loads in the other with equal answers.
"""

import numpy as np
import pytest
import torch

from ragfin_tpu.extraction.service import rule_based_extract as j_extract
from ragfin_tpu.index import graph_index as J
from ragfin_tpu_torch.eval.distractors import generate_distractors
from ragfin_tpu_torch.extraction.service import rule_based_extract as t_extract
from ragfin_tpu_torch.index import graph_index as T

MEAN_RTOL = 1e-5


def _hit_cases():
    rng = np.random.default_rng(1)
    sparse = (rng.uniform(size=300_000) < 0.001).astype(np.int8)
    last = np.zeros((300_000,), np.int8)
    last[-3:] = 1
    ragged = (rng.uniform(size=131_072 + 77) < 0.01).astype(np.int8)  # not a block multiple
    dense = np.ones((140_000,), np.int8)
    # Hits spread over the last 32 KB span only (300,000 = 9 spans + 5,088 bytes).
    last_span = np.zeros((300_000,), np.int8)
    last_span[rng.choice(np.arange(9 * 32768, 300_000), 12, replace=False)] = 1
    single = np.zeros((100_000,), np.int8)
    single[0] = 1
    return {
        "sparse": (sparse, 20),
        "none": (np.zeros((200_000,), np.int8), 5),
        "last_tile": (last, 5),
        "k_above_hits": (last, 30),
        "ragged": (ragged, 30),
        "all_hits": (dense, 30),
        "bool": (sparse.astype(bool), 20),
        "k_1": (sparse, 1),
        "single_hit_at_0": (single, 8),
        "last_span_only": (last_span, 5),
        "k_equals_hits": (ragged, int(np.count_nonzero(ragged))),
    }


@pytest.mark.parametrize("case", list(_hit_cases()))
def test_masked_first_k_plain_vs_jax_interpret(case):
    hit, k = _hit_cases()[case]
    j_ids, j_cnt = J.masked_first_k(np.asarray(hit), k, interpret=True)
    t_ids, t_cnt = T.masked_first_k(torch.from_numpy(hit), k)
    assert t_ids.dtype == torch.int32 and t_ids.shape == (k,)
    assert np.array_equal(np.asarray(j_ids), t_ids.numpy())
    assert int(j_cnt) == int(t_cnt) == min(int(hit.astype(bool).sum()), k)


def test_masked_first_k_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        T.masked_first_k(torch.zeros(8), 2)
    with pytest.raises(ValueError):
        T.masked_first_k(torch.zeros((2, 4), dtype=torch.int8), 2)
    with pytest.raises(ValueError):
        T.masked_first_k(torch.zeros(8, dtype=torch.int8), 0)


@pytest.fixture(scope="module")
def filings():
    return generate_distractors(300, seed=3)


@pytest.fixture(scope="module")
def graphs(filings):
    """Both stores from the same extraction; one fact is doubled so the
    maximum of NET PROFIT is tied between two rows."""
    t, j = T.GraphIndex(device="cpu"), J.GraphIndex()
    for r in filings:
        te, je = t_extract(r.text), j_extract(r.text)
        assert te.model_dump() == je.model_dump()
        n_t = t.save_entities(te, r.id, dataset_id="gen", company_name=r.company)
        n_j = j.save_entities(je, r.id, dataset_id="gen", company_name=r.company)
        assert n_t == n_j
    peak = t.aggregate(names=["NET PROFIT"])["max"]
    for g in (t, j):
        g.add_facts_bulk(
            g.intern_quarters(["Q4_FY2031"]), g.intern_entities(["NET PROFIT"]),
            np.array([T.METRIC], np.int32), np.array([peak["value"]], np.float32),
            dataset_id="tie", company="Tie Bank",
        )
    return t, j


def _companies(filings):
    return sorted({r.company for r in filings})


MATCH_CASES = {
    "all": {},
    "one_quarter": dict(quarters=["Q1_FY2020"]),
    "name": dict(names=["NET PROFIT"], limit=50),
    "segments": dict(types=[T.SEGMENT], limit=7),
    "unknown_name": dict(names=["No Such Metric"]),
    "unknown_quarter": dict(quarters=["Q1_FY1999"]),
    "limit_above_rows": dict(names=["Total Income"], limit=100_000),
}


@pytest.mark.parametrize("case", list(MATCH_CASES))
def test_match_small_route(graphs, case):
    t, j = graphs
    assert t._pack()["quarter_ids"].shape[0] < T.FIRST_K_MIN_ROWS
    got, want = t.match(**MATCH_CASES[case]), j.match(**MATCH_CASES[case])
    assert got == want
    if case in ("all", "name", "segments"):
        assert got


def test_company_scope(graphs, filings):
    t, j = graphs
    banks = _companies(filings)
    assert len(banks) >= 3
    for companies in ([banks[0]], banks[1:3], ["No Such Bank"]):
        kw = dict(names=["Total Income"], companies=companies, limit=40)
        got = t.match(**kw)
        assert got == j.match(**kw)
        assert all(r["company"] in companies for r in got)
        assert _agg_equal(
            t.aggregate(names=["Total Income"], companies=companies),
            j.aggregate(names=["Total Income"], companies=companies),
        )


def _agg_equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    assert a["max"] == b["max"] and a["min"] == b["min"]
    assert a["count"] == b["count"] and a["field"] == b["field"]
    assert a["mean"] == pytest.approx(b["mean"], rel=MEAN_RTOL)
    return True


@pytest.mark.parametrize("kw", [
    dict(names=["NET PROFIT"]),
    dict(names=["NET PROFIT"], quarters=["Q1_FY2020", "Q2_FY2021"]),
    dict(types=[T.SEGMENT], field="aux"),
    dict(names=["Basic EPS"], field="growth"),
    dict(names=["No Such Metric"]),
], ids=["value", "quarters", "aux", "growth", "none"])
def test_aggregate(graphs, kw):
    t, j = graphs
    assert _agg_equal(t.aggregate(**kw), j.aggregate(**kw))


def test_aggregate_tie_takes_first_row(graphs):
    t, j = graphs
    got, want = t.aggregate(names=["NET PROFIT"]), j.aggregate(names=["NET PROFIT"])
    assert _agg_equal(got, want)
    # The doubled peak sits in a later quarter: the earlier row wins.
    assert got["max"]["quarter"] != "Q4_FY2031"


@pytest.mark.parametrize("hops", [1, 2, 3])
def test_expand(graphs, hops):
    t, j = graphs
    for names in (["NET PROFIT"], ["RETAIL BANKING SEGMENT", "Basic EPS"], ["No Such Metric"]):
        assert t.expand(names, limit=40, hops=hops) == j.expand(names, limit=40, hops=hops)


def test_stats_and_vocabularies(graphs):
    t, j = graphs
    assert t.stats() == j.stats()
    assert t.quarters == j.quarters and t.entities == j.entities
    assert t.n_facts == j.n_facts > 1500


def _bulk(g, n=270_000):
    rng = np.random.default_rng(0)
    quarters = [f"Q{q}_FY{y}" for y in range(2018, 2025) for q in range(1, 5)]
    qv = g.intern_quarters(quarters)
    ev = g.intern_entities([f"Metric {i}" for i in range(64)] + ["Net Profit"])
    g.add_facts_bulk(
        quarter_ids=qv[rng.integers(0, len(qv), n)],
        entity_ids=ev[rng.integers(0, len(ev), n)],
        type_ids=rng.integers(0, 4, n).astype(np.int32),
        values=rng.uniform(1, 1e5, n).astype(np.float32),
        dataset_id="synthetic",
    )
    g.add_facts_bulk(
        quarter_ids=g.intern_quarters(["Q4_FY2024"]),
        entity_ids=g.intern_entities(["Unique Sentinel Metric"]),
        type_ids=np.array([T.METRIC], np.int32),
        values=np.array([777.0], np.float32),
        dataset_id="sentinel", company="Sentinel Bank",
    )
    return g


@pytest.fixture(scope="module")
def big_graphs():
    return _bulk(T.GraphIndex(device="cpu")), _bulk(J.GraphIndex())


@pytest.mark.parametrize("kw", [
    dict(names=["Net Profit"], limit=30),
    dict(names=["Metric 7"], types=[T.SEGMENT], limit=25),
    dict(quarters=["Q4_FY2024"], names=["Unique Sentinel Metric"], types=[T.METRIC]),
    dict(names=["Unique Sentinel Metric"], companies=["Sentinel Bank"]),
    dict(names=["Metric 3"], companies=["Sentinel Bank"]),
    dict(names=["No Such Metric"]),
], ids=["name", "typed", "sentinel_last_rows", "company", "company_none", "none"])
def test_match_first_k_route(big_graphs, kw, monkeypatch):
    t, j = big_graphs
    assert t._pack()["quarter_ids"].shape[0] >= T.FIRST_K_MIN_ROWS
    calls = []
    real = T.masked_first_k
    monkeypatch.setattr(T, "masked_first_k", lambda hit, k: calls.append(k) or real(hit, k))
    got = t.match(**kw)
    assert calls, "match() must take the first-k route at this size"
    assert got == j.match(**kw)


def test_first_k_route_against_numpy_oracle(big_graphs):
    t, _ = big_graphs
    host = t._pack()["host"]
    rows = np.nonzero(
        (host["entity_ids"] == t._entity_id["Metric 7"]) & (host["type_ids"] == T.SEGMENT)
    )[0][:25]
    got = t.match(names=["Metric 7"], types=[T.SEGMENT], limit=25)
    assert [r["revenue"] for r in got] == [float(host["value"][i]) for i in rows]


def test_big_aggregate_and_expand(big_graphs):
    t, j = big_graphs
    assert _agg_equal(t.aggregate(names=["Metric 5"], types=[T.RATIO]),
                      j.aggregate(names=["Metric 5"], types=[T.RATIO]))
    assert t.expand(["Unique Sentinel Metric"], hops=2, limit=10) == \
        j.expand(["Unique Sentinel Metric"], hops=2, limit=10)


QUERIES = [
    ("match", dict(names=["NET PROFIT"], limit=25)),
    ("match", dict(types=[T.BALANCE], quarters=["Q2_FY2021"])),
    ("aggregate", dict(names=["Total Income"])),
    ("expand", dict(names=["Advances"], hops=2)),
]


def _answers(g):
    out = [getattr(g, name)(**kw) for name, kw in QUERIES]
    return out, g.stats()


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_save_in_one_package_load_in_the_other(graphs, tmp_path, direction):
    t, j = graphs
    if direction == "jax_to_torch":
        j.save(str(tmp_path))
        loaded, source = T.GraphIndex.load(str(tmp_path), device="cpu"), j
    else:
        t.save(str(tmp_path))
        loaded, source = J.GraphIndex.load(str(tmp_path)), t
    (got, got_stats), (want, want_stats) = _answers(loaded), _answers(source)
    assert got_stats == want_stats
    assert got[0] == want[0] and got[1] == want[1] and got[3] == want[3]
    assert _agg_equal(got[2], want[2])
    assert loaded.organizations == source.organizations
    assert loaded.quarter_sources == source.quarter_sources


def test_round_one_json_rows_load(tmp_path):
    import json

    rows = [[0, 1, 0, 12.5, 3.0, None, "crore", "c1", "d1"], [1, 2, 2, 0.5, None, None, "ratio", "c2", "d1"]]
    base = T.GraphIndex(device="cpu")
    data = {"company": "ICICI Bank", "quarters": base.quarters, "entities": base.entities, "rows": rows}
    with open(tmp_path / "graph.json", "w") as f:
        json.dump(data, f)
    t, j = T.GraphIndex.load(str(tmp_path), device="cpu"), J.GraphIndex.load(str(tmp_path))
    assert t.match() == j.match() and len(t.match()) == 2


def test_clear_data(filings):
    t, j = T.GraphIndex(device="cpu"), J.GraphIndex()
    for g, extract in ((t, t_extract), (j, j_extract)):
        for i, r in enumerate(filings[:60]):
            g.save_entities(extract(r.text), r.id, dataset_id="a" if i % 2 else "b", company_name=r.company)
    for g in (t, j):
        g.clear_data("a")
    assert t.stats() == j.stats()
    assert t.match(limit=500) == j.match(limit=500)
    assert t.organizations == j.organizations and t.quarter_sources == j.quarter_sources
    for g in (t, j):
        g.clear_data()
    assert t.match() == j.match() == []
    assert t.stats() == j.stats() and t.aggregate() is None and t.expand(["NET PROFIT"]) == []


def test_device_is_explicit():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal is for machines without one")
    with pytest.raises(RuntimeError):
        T.GraphIndex()


def test_cpu_calls_count_no_launch():
    before = T.masked_first_k.launches
    T.masked_first_k(torch.ones(64, dtype=torch.int8), 3)
    assert T.masked_first_k.launches == before


@pytest.mark.cuda
class TestOnCard:
    """Runs only where a CUDA card is present (chip_smoke.py covers the same
    comparison at 10,000,000 rows)."""

    @pytest.fixture(autouse=True)
    def _need_card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card; the CPU has no kernel to launch")

    @pytest.mark.parametrize("case", list(_hit_cases()))
    def test_first_k_kernel_matches_plain(self, case):
        hit, k = _hit_cases()[case]
        dev_hit = torch.from_numpy(hit).cuda()
        before = T.masked_first_k.launches
        ids, cnt = T.masked_first_k(dev_hit, k)
        pids, pcnt = T.masked_first_k_plain(dev_hit, k)
        assert T.masked_first_k.launches == before + 1
        assert torch.equal(ids, pids) and int(cnt) == int(pcnt)

    @pytest.mark.parametrize("rate", [0.0, 1e-7, 1e-3])
    def test_first_k_more_blocks_than_resident(self, rate):
        """80M bytes are 2,442 blocks, more than the card holds at once: the
        look-back also waits on spans whose blocks start in a later wave."""
        g = torch.Generator(device="cuda").manual_seed(11)
        hit = (torch.rand(80_000_000, generator=g, device="cuda") < rate).to(torch.int8)
        for k in (1, 30, 5000):
            ids, cnt = T.masked_first_k(hit, k)
            pids, pcnt = T.masked_first_k_plain(hit, k)
            assert torch.equal(ids, pids) and int(cnt) == int(pcnt), k

    def test_first_k_back_to_back_calls(self):
        """Twenty calls on different vectors and k with no sync between
        them: each call's scratch state must not leak into the next."""
        rng = np.random.default_rng(3)
        calls = []
        for _ in range(20):
            n = int(rng.integers(1, 400_000))
            hit = torch.from_numpy((rng.uniform(size=n) < 10 ** rng.uniform(-5, 0)).astype(np.int8))
            calls.append((hit.cuda(), int(rng.integers(1, 200))))
        got = [T.masked_first_k(h, k) for h, k in calls]
        torch.cuda.synchronize()
        for (h, k), (ids, cnt) in zip(calls, got):
            pids, pcnt = T.masked_first_k_plain(h, k)
            assert torch.equal(ids, pids) and int(cnt) == int(pcnt)

    def test_first_k_two_streams(self):
        """Calls on two streams at once each use their own scratch."""
        cases = list(_hit_cases().values())
        streams = [torch.cuda.Stream(), torch.cuda.Stream()]
        dev = [(torch.from_numpy(h).cuda(), k) for h, k in cases]
        torch.cuda.synchronize()
        got = []
        for rep in range(4):
            for i, (h, k) in enumerate(dev):
                with torch.cuda.stream(streams[(i + rep) % 2]):
                    got.append((h, k, T.masked_first_k(h, k)))
        torch.cuda.synchronize()
        for h, k, (ids, cnt) in got:
            pids, pcnt = T.masked_first_k_plain(h, k)
            assert torch.equal(ids, pids) and int(cnt) == int(pcnt)
        keys = {key for key in T._first_k_scratch if key[1] in {s.cuda_stream for s in streams}}
        assert len(keys) == 2

    def test_first_k_scratch_is_reused(self):
        hit = torch.ones(1_000_000, dtype=torch.int8, device="cuda")
        T.masked_first_k(hit, 3)
        key = (hit.get_device(), torch.cuda.current_stream().cuda_stream)
        ptr = T._first_k_scratch[key][1]
        for k in (1, 5, 30):
            ids, cnt = T.masked_first_k(hit, k)
            assert ids.tolist() == list(range(k)) and int(cnt) == k
        assert T._first_k_scratch[key][1] == ptr

    def test_match_on_the_card_equals_the_cpu(self, big_graphs):
        cpu, _ = big_graphs
        card = _bulk(T.GraphIndex(device="cuda"))
        for kw in (dict(names=["Metric 7"], types=[T.SEGMENT], limit=25), dict(names=["Net Profit"])):
            assert card.match(**kw) == cpu.match(**kw)
