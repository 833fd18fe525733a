"""The port's dataclass records against the JAX package's pydantic models:
each accepts and refuses what the other accepts and refuses, coerces the
same way, and dumps the same dict."""

import pytest

from ragfin_tpu.data import models as J
from ragfin_tpu_torch.data import models as T


def _outcome(cls, kwargs, validate=False):
    try:
        rec = cls.model_validate(kwargs) if validate else cls(**kwargs)
    except Exception as e:  # noqa: BLE001 - the class of failure is the point
        return "refused", isinstance(e, ValueError)
    return "accepted", rec.model_dump()


METRIC_CASES = [
    dict(name="NET PROFIT", value=10636.0, growth_yoy=44.0, unit="crore"),
    dict(name="NET PROFIT", value="12.5"),  # numeric string -> float
    dict(name="NET PROFIT", value=" 7 "),
    dict(name="NET PROFIT", value=3),  # int -> float
    dict(name="NET PROFIT", value=True),
    dict(name="NET PROFIT", value=1.0, unit=None, growth_yoy=None),
    dict(name="NET PROFIT", value=1.0, extra_key="ignored"),
    dict(name="NET PROFIT"),  # missing required field
    dict(value=1.0),
    dict(name="NET PROFIT", value=None),
    dict(name="NET PROFIT", value="twelve"),
    dict(name=7, value=1.0),  # a str field takes only a string
    dict(name="NET PROFIT", value=1.0, unit=3),
    dict(name="NET PROFIT", value=[1.0]),
]


@pytest.mark.parametrize("kwargs", METRIC_CASES, ids=[str(i) for i in range(len(METRIC_CASES))])
@pytest.mark.parametrize("cls", ["FinancialMetric", "FinancialRatio", "BalanceSheetItem"])
def test_scalar_records(cls, kwargs):
    if cls == "BalanceSheetItem":
        kwargs = {("percentage_of_total" if k == "growth_yoy" else k): v for k, v in kwargs.items()}
    got, want = _outcome(getattr(T, cls), kwargs), _outcome(getattr(J, cls), kwargs)
    assert got == want


@pytest.mark.parametrize("kwargs", [
    dict(name="RETAIL", revenue=1.0, margin="13.5", percentage_of_total=35.5),
    dict(name="RETAIL", revenue=1.0),  # margin is required
    dict(name="RETAIL", revenue=None, margin=1.0),
])
def test_segment(kwargs):
    assert _outcome(T.BusinessSegment, kwargs) == _outcome(J.BusinessSegment, kwargs)


ENTITY_CASES = [
    {},
    dict(quarter="Q1_FY2024", financial_metrics=[{"name": "a", "value": "12.5", "zzz": 1}]),
    dict(quarter=None, business_segments=[{"name": "s", "revenue": 1, "margin": 2}],
         financial_ratios=[{"name": "r", "value": 0.5}],
         balance_sheet_items=[{"name": "b", "value": 9, "percentage_of_total": "55.1"}]),
    dict(quarter="Q1_FY2024", financial_metrics=[{"name": "a"}]),  # nested missing field
    dict(quarter="Q1_FY2024", financial_metrics=[{"name": "a", "value": "x"}]),
    dict(quarter="Q1_FY2024", financial_metrics="not a list"),
    dict(quarter="Q1_FY2024", financial_metrics=[3]),
    dict(quarter=5),
]


@pytest.mark.parametrize("kwargs", ENTITY_CASES, ids=[str(i) for i in range(len(ENTITY_CASES))])
def test_extracted_entities(kwargs):
    got, want = _outcome(T.ExtractedEntities, kwargs), _outcome(J.ExtractedEntities, kwargs)
    assert got == want
    if got[0] == "accepted":
        assert T.ExtractedEntities(**kwargs).total_count() == J.ExtractedEntities(**kwargs).total_count()


def test_entities_take_built_records():
    t = T.ExtractedEntities(quarter="Q2_FY2023", financial_metrics=[T.FinancialMetric(name="a", value=1)])
    j = J.ExtractedEntities(quarter="Q2_FY2023", financial_metrics=[J.FinancialMetric(name="a", value=1)])
    assert t.model_dump() == j.model_dump()
    # Default lists are not shared between instances.
    a, b = T.ExtractedEntities(), T.ExtractedEntities()
    a.financial_metrics.append(1)
    assert b.financial_metrics == []


CHUNK_CASES = [
    dict(id="x", period="Q1_FY2024", type="t", size=12, text="0123456789"),
    dict(id="x", period="Q1_FY2024", type="t", size="12", text="0123456789 and more"),
    dict(id="x", period="Q1_FY2024", type="t", size=12.0, text="0123456789"),
    dict(id="x", period="XQ1_FY2024Z", type="t", size=12, text="0123456789"),  # searched, not anchored
    dict(id="x", period="Q5_FY2024", type="t", size=12, text="0123456789"),  # bad period
    dict(id="x", period="Q1_FY24", type="t", size=12, text="0123456789"),
    dict(id="x", period="Q1_FY2024", type="t", size=12, text="too short"),  # short text
    dict(id="x", period="Q1_FY2024", type="t", size=12.5, text="0123456789"),
    dict(id="x", period="Q1_FY2024", type="t", text="0123456789"),  # missing size
    dict(id="x", period=None, type="t", size=1, text="0123456789"),
]


@pytest.mark.parametrize("kwargs", CHUNK_CASES, ids=[str(i) for i in range(len(CHUNK_CASES))])
def test_financial_chunk_validate(kwargs):
    got = _outcome(T.FinancialChunk, kwargs, validate=True)
    assert got == _outcome(J.FinancialChunk, kwargs, validate=True)
    assert got == _outcome(T.FinancialChunk, kwargs)


def test_indexed_chunk_to_financial_chunk():
    kw = dict(id="c1", text="NET PROFIT: 12 crore in the quarter", period="Q3_FY2022",
              chunk_type="profitability_analysis", company="Axis Bank", primary_value="3")
    t, j = T.IndexedChunk(**kw), J.IndexedChunk(**kw)
    assert t.model_dump() == j.model_dump()
    assert t.to_financial_chunk().model_dump() == j.to_financial_chunk().model_dump()
    with pytest.raises(ValueError):
        T.IndexedChunk(id="c", text="short", period="bad", chunk_type="x").to_financial_chunk()


def test_chunk_type_values():
    assert {m.name: m.value for m in T.ChunkType} == {m.name: m.value for m in J.ChunkType}
