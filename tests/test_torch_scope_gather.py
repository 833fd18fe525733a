"""Scoped searches scored on their scope's columns alone, on the CPU.

``DeviceVectorIndex`` scores a masked search (``search_texts`` with a
cached filter, ``search_texts_tiers``) on the gathered columns of its tiers'
union when that union holds R rows with ``k <= R <= N / 16``, and on every
column, masked, otherwise. Both routes must return the same hits. The corpus
lays its 384 scopes (8 banks x 12 quarters x 4 types) round robin over
7,680 rows, as the benchmark's corpus does, with every row of its second
half a copy of a row of the same scope, to force ties. Its vectors and the
queries' are sixteenths of small integers, so every f32 score (and every
bf16 one: the entries are exact in bf16) is exact in any summation order:
the two routes, a host oracle and the JAX package must agree bitwise. The
int8 index repairs its shortlists on the host.
"""

import zlib

import numpy as np
import pytest

from ragfin_tpu.data.models import IndexedChunk as JChunk
from ragfin_tpu.index.vector_index import DeviceVectorIndex as JIndex
from ragfin_tpu.retrieval.queryfilter import FilteredSearch as JFiltered
from ragfin_tpu_torch.data.models import IndexedChunk
from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex
from ragfin_tpu_torch.retrieval.queryfilter import FilteredSearch
from ragfin_tpu_torch.utils.profiling import METRICS

BANKS = ["ICICI Bank", "HDFC Bank", "Axis Bank", "Kotak Mahindra Bank",
         "State Bank of India", "Yes Bank", "IndusInd Bank", "Federal Bank"]
PERIODS = [f"Q{q}_FY{fy}" for fy in (2022, 2023, 2024) for q in (1, 2, 3, 4)]
TYPES = ["profitability", "key_ratios", "balance_sheet", "asset_quality"]
SCOPES = len(BANKS) * len(PERIODS) * len(TYPES)
ROWS_PER_SCOPE = 20
N = SCOPES * ROWS_PER_SCOPE  # 7,680 rows; padded width 8,192, so R <= 512 gathers
DIM = 384
FY23 = PERIODS[4:8]
# EPS pairs that pass, fail and cannot be checked: multipliers 1, 1 - w, 1.
EPS = ["Basic EPS ₹5.00, Diluted EPS ₹4.90", "Basic EPS ₹5.00, Diluted EPS ₹5.90",
       "EPS not disclosed"]


def _scope(i):
    s = i % SCOPES
    return BANKS[s // 48], PERIODS[(s // 4) % 12], TYPES[s % 4]


def _fields(i):
    bank, period, ctype = _scope(i)
    return dict(id=f"c{i:05d}", period=period, chunk_type=ctype, company=bank,
                text=f"{bank} {period} {ctype}: {EPS[i % 3]}")


@pytest.fixture(scope="module")
def embeddings():
    rng = np.random.default_rng(17)
    emb = rng.integers(-3, 4, size=(N, DIM)).astype(np.float32) / 16
    emb[N // 2:] = emb[: N // 2]  # row i + N/2 copies row i, in the same scope
    return emb


class _Embedder:
    """Query vectors from the text alone, sixteenths of small integers."""

    def encode_texts(self, texts):
        return np.stack([
            np.random.default_rng(zlib.crc32(t.encode())).integers(-3, 4, DIM).astype(np.float32) / 16
            for t in texts
        ])


def _index(embeddings, dtype):
    index = DeviceVectorIndex(embeddings, [IndexedChunk(**_fields(i)) for i in range(N)],
                              dtype=dtype, normalize=False, device="cpu")
    index.embedder = _Embedder()
    return index


def _gathers():
    return METRICS.summary()["counters"].get("index.scope_gather", 0)


QUESTIONS = ["net profit", "key ratios", "gross NPA", "deposits and advances", "EPS growth"]
TIERS = {
    # A typed and an untyped tier: a union of 320 rows, gathered.
    "typed": [dict(periods=FY23, chunk_type="key_ratios", company="HDFC Bank"),
              dict(periods=FY23, company="HDFC Bank")],
    # A typed tier of 20 rows, fewer than k, inside a gathered union of 320.
    "narrow": [dict(period="Q2_FY2023", chunk_type="asset_quality", company="Axis Bank"),
               dict(periods=FY23, company="Axis Bank")],
    # One bank's 960 rows: above N / 16, so dense.
    "company": [dict(company="Yes Bank"), dict(periods=FY23, company="Yes Bank")],
}
SINGLE = {
    "scoped": dict(periods=PERIODS[8:], chunk_type="asset_quality", company="IndusInd Bank"),  # 80, gathered
    "tiny": dict(period="Q1_FY2022", chunk_type="profitability", company="Federal Bank"),  # 20 < k, dense
}
TOP_K = 30
GATHERED_PER_ROUND = 3  # "typed", "narrow", "scoped"


def _hits(lists):
    return [[(h.id, h.score) for h in hits] for hits in lists]


def _round(index, weight):
    """Every case once: {case: hits}."""
    out = {}
    for name, tiers in TIERS.items():
        out[name] = [_hits(t) for t in index.search_texts_tiers(
            QUESTIONS, tiers, top_k=TOP_K, consistency_weight=weight)]
    for name, flt in SINGLE.items():
        out[name] = _hits(index.search_texts(QUESTIONS, top_k=TOP_K, consistency_weight=weight, **flt))
    out["unfiltered"] = _hits(index.search_texts(QUESTIONS, top_k=TOP_K, consistency_weight=weight))
    return out


@pytest.mark.parametrize("weight", [0.0, 0.5], ids=["plain", "integrity"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_gathered_and_dense_routes_return_the_same_hits(embeddings, dtype, weight, monkeypatch):
    index = _index(embeddings, dtype)
    before = _gathers()
    gathered = _round(index, weight)
    assert _gathers() - before == GATHERED_PER_ROUND
    monkeypatch.setattr(index, "scope_gather_max_share", 0.0)
    before = _gathers()
    dense = _round(index, weight)
    assert _gathers() == before
    assert gathered == dense
    assert all(len(hits) == ROWS_PER_SCOPE for hits in gathered["narrow"][0])
    assert all(len(hits) == TOP_K for hits in gathered["typed"][0] + gathered["scoped"])


def _oracle(embeddings, query, rows, k, mult=None):
    """Stable (score descending, id ascending) top k of exact scores over ``rows``."""
    scores = embeddings[rows].astype(np.float64) @ query.astype(np.float64)
    if mult is not None:
        scores = np.where(scores > 0, scores * mult[rows], scores)
    order = np.argsort(-scores, kind="stable")[:k]
    return [(f"c{rows[o]:05d}", float(scores[o])) for o in order]


def _rows(**flt):
    periods = flt.get("periods") or [flt["period"]]
    return np.array([i for i in range(N) if _scope(i)[0] == flt["company"]
                     and _scope(i)[1] in periods
                     and flt.get("chunk_type") in (None, _scope(i)[2])])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gathered_hits_equal_the_host_oracle_with_lowest_id_first_on_ties(embeddings, dtype):
    index = _index(embeddings, dtype)
    queries = _Embedder().encode_texts(QUESTIONS)
    mult = np.where(np.arange(N) % 3 == 1, 0.5, 1.0)
    ties = 0
    for weight in (0.0, 0.5):
        got = index.search_texts_tiers(QUESTIONS, TIERS["typed"], top_k=TOP_K,
                                       consistency_weight=weight)
        for tier, lists in zip(TIERS["typed"], got):
            rows = _rows(**tier)
            for q, hits in zip(queries, lists):
                want = _oracle(embeddings, q, rows, TOP_K, mult if weight else None)
                assert [(h.id, h.score) for h in hits] == want
                ties += sum(a[1] == b[1] for a, b in zip(want, want[1:]))
    assert ties > 0  # the duplicated rows tie inside the top k


def test_padding_columns_are_never_returned(embeddings, monkeypatch):
    """With the bound raised to the whole width, the unscoped tier gathers
    every row: all N come back, and none of the zero padding columns, which
    would outrank every negative score."""
    index = _index(embeddings, "float32")
    monkeypatch.setattr(index, "scope_gather_max_share", 1.0)
    before = _gathers()
    got = index.search_texts_tiers(QUESTIONS[:2], [dict(company="HDFC Bank"), {}], top_k=N)
    assert _gathers() - before == 1
    for hits in got[1]:
        assert len(hits) == N and hits[-1].score < 0
        assert sorted(h.id for h in hits) == [f"c{i:05d}" for i in range(N)]
    assert all(len(hits) == N // len(BANKS) for hits in got[0])


def test_a_gathered_group_builds_no_dense_mask_and_caches_its_columns(embeddings):
    index = _index(embeddings, "float32")
    builds = lambda: METRICS.summary()["counters"].get("index.mask_build", 0)  # noqa: E731
    b0, g0 = builds(), _gathers()
    first = index.search_texts_tiers(QUESTIONS, TIERS["typed"], top_k=10)
    assert _gathers() - g0 == 1
    cache = dict(index._device_mask_cache)
    assert [key[0] for key in cache] == ["gather"]
    (rows, tier_masks), = cache.values()
    assert rows.shape == (320,) and tier_masks.shape == (2, 320)
    assert bool((rows[1:] > rows[:-1]).all()) and int(rows[-1]) < N
    assert tier_masks[0].sum() == 80 and bool(tier_masks[1].all())
    b1 = builds()
    again = index.search_texts_tiers(QUESTIONS, TIERS["typed"], top_k=10)
    assert builds() == b1 and _hits(again[0]) == _hits(first[0])
    assert all(a is b for a, b in zip(index._device_mask_cache[next(iter(cache))], (rows, tier_masks)))
    index.search_texts_tiers(QUESTIONS, TIERS["company"], top_k=10)  # dense: a [G, N] stack
    assert sorted(key[0] for key in index._device_mask_cache) == ["gather", "group"]
    # Host masks of four filters, then the gathered pair and the dense stack.
    assert builds() - b0 == 6


def test_filtered_search_equals_the_jax_package_where_the_bound_engages(embeddings):
    records = [_fields(i) for i in range(N)]
    tidx = DeviceVectorIndex(embeddings, [IndexedChunk(**r) for r in records],
                             normalize=False, device="cpu")
    jidx = JIndex(embeddings, [JChunk(**r) for r in records], normalize=False)
    tidx.embedder = jidx.embedder = _Embedder()
    questions = [
        "What was HDFC Bank's net profit in Q1 FY2023?",
        "Axis Bank key ratios in FY2024",
        "gross NPA of Yes Bank in Q3 FY2022",
        "What was the net interest margin?",
        "State Bank of India total deposits Q4 FY2023",
    ]
    before = _gathers()
    got = FilteredSearch(tidx).search_texts(questions, top_k=10)
    assert _gathers() > before
    want = JFiltered(jidx).search_texts(questions, top_k=10)
    for q, a, b in zip(questions, got, want):
        assert len(a) == 10, q
        assert [h.id for h in a] == [h.id for h in b], q
        assert [h.score for h in a] == [h.score for h in b], q
