"""Data contracts for chunks and extracted entities.

Counterpart of ``ragfin_tpu/data/models.py`` for the records the retrieval
and graph paths use, as dataclasses with the same fields and defaults (the
port does not depend on pydantic). The graph path leans on three pieces of
the pydantic models' behaviour, which :class:`_Record` keeps:

- construction from keyword arguments validates and coerces: a ``float``
  field takes a number or a numeric string, a ``str`` field takes only a
  string, a required field that is missing or ``None`` raises
  :class:`ValidationError`, unknown keys are ignored, and a list field builds
  its records from dicts;
- ``model_validate(dict)`` is the same construction from a mapping, with
  ``FinancialChunk`` checking its period pattern and minimum text length;
- ``model_dump()`` returns the nested field dict that persistence writes.

Of the API request/response models only ``GraphQueryRequest`` is read by the
services (the others document payloads and are not ported).
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, List, Optional


class ValidationError(ValueError):
    """A record was given a missing, mistyped or out-of-contract field."""


_MISSING = dataclasses.MISSING


def _to_float(name: str, v: Any) -> float:
    if isinstance(v, float):
        return v
    if isinstance(v, (int, bool)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v.strip())
        except ValueError:
            pass
    raise ValidationError(f"{name}: not a number: {v!r}")


def _to_int(name: str, v: Any) -> int:
    if isinstance(v, int):
        return int(v)
    if isinstance(v, float) and v.is_integer():
        return int(v)
    if isinstance(v, str):
        try:
            return int(v.strip())
        except ValueError:
            pass
    raise ValidationError(f"{name}: not an integer: {v!r}")


def _to_str(name: str, v: Any) -> str:
    if isinstance(v, str):
        return v
    raise ValidationError(f"{name}: not a string: {v!r}")


_SCALARS = {"float": _to_float, "int": _to_int, "str": _to_str}


class _Record:
    """Keyword construction with pydantic-like validation (see module doc).

    ``_SPEC`` maps a field to ``(kind, optional)`` where kind is ``"float"``,
    ``"int"``, ``"str"`` or a record class (a list of that record)."""

    _SPEC: dict = {}

    @classmethod
    def _plan(cls) -> list:
        """(name, kind, optional, default, default_factory) per field, cached."""
        plan = cls.__dict__.get("_PLAN")
        if plan is None:
            plan = [
                (f.name, *cls._SPEC[f.name], f.default, f.default_factory)
                for f in dataclasses.fields(cls)
            ]
            cls._PLAN = plan
        return plan

    def __init__(self, **data: Any):
        for name, kind, optional, default, factory in self._plan():
            v = data.get(name, _MISSING)
            if v is _MISSING:
                if default is not _MISSING:
                    v = default
                elif factory is not _MISSING:
                    v = factory()
                else:
                    raise ValidationError(f"{name}: field required")
            elif v is None:
                if not optional:
                    raise ValidationError(f"{name}: none is not an allowed value")
            elif isinstance(kind, str):
                v = _SCALARS[kind](name, v)
            else:
                if not isinstance(v, (list, tuple)):
                    raise ValidationError(f"{name}: not a list: {v!r}")
                v = [kind._coerce(name, item) for item in v]
            setattr(self, name, v)
        self._validate()

    def _validate(self) -> None:
        pass

    @classmethod
    def _coerce(cls, name: str, item: Any):
        if isinstance(item, cls):
            return item
        if isinstance(item, dict):
            return cls(**item)
        raise ValidationError(f"{name}: not a {cls.__name__}: {item!r}")

    @classmethod
    def model_validate(cls, data: Any):
        if isinstance(data, cls):
            return data
        if not isinstance(data, dict):
            raise ValidationError(f"{cls.__name__}: not a mapping: {data!r}")
        return cls(**data)

    def model_dump(self) -> dict:
        """Nested field dict (the pydantic method name the JAX records answer to)."""
        return dataclasses.asdict(self)


# ===============================
# CHUNK MODELS
# ===============================


class ChunkType(str, Enum):
    BALANCE_SHEET = "balance_sheet_analysis"
    FINANCIAL_RATIOS = "financial_ratios"
    PROFITABILITY = "profitability_analysis"
    SEGMENT_ANALYSIS = "segment_analysis"


# The pattern is searched for, not anchored, as pydantic applies ``pattern``.
_PERIOD_PATTERN = re.compile(r"Q[1-4]_FY\d{4}")


@dataclass(init=False)
class FinancialChunk(_Record):
    """A chunk of quarterly-report analysis text (period pattern
    ``Q[1-4]_FY\\d{4}``, minimum text length 10)."""

    id: str
    period: str
    type: str
    size: int
    text: str

    _SPEC = {
        "id": ("str", False), "period": ("str", False), "type": ("str", False),
        "size": ("int", False), "text": ("str", False),
    }

    def _validate(self) -> None:
        if not _PERIOD_PATTERN.search(self.period):
            raise ValidationError(f"period: {self.period!r} does not match Q[1-4]_FY\\d{{4}}")
        if len(self.text) < 10:
            raise ValidationError("text: shorter than 10 characters")


@dataclass(init=False)
class IndexedChunk(_Record):
    """Milvus ``fin_chunks`` schema: id, text, period, chunk_type,
    statement_type, primary_value, plus the company scope."""

    id: str
    text: str
    period: str
    chunk_type: str
    statement_type: str = "consolidated"
    primary_value: float = 0.0
    company: str = "ICICI Bank"

    _SPEC = {
        "id": ("str", False), "text": ("str", False), "period": ("str", False),
        "chunk_type": ("str", False), "statement_type": ("str", False),
        "primary_value": ("float", False), "company": ("str", False),
    }

    def to_financial_chunk(self) -> FinancialChunk:
        return FinancialChunk(
            id=self.id,
            period=self.period,
            type=self.chunk_type,
            size=len(self.text),
            text=self.text,
        )


# ===============================
# ENTITY MODELS
# ===============================


@dataclass(init=False)
class FinancialMetric(_Record):
    name: str
    value: float
    growth_yoy: Optional[float] = None
    unit: Optional[str] = "crore"

    _SPEC = {
        "name": ("str", False), "value": ("float", False),
        "growth_yoy": ("float", True), "unit": ("str", True),
    }


@dataclass(init=False)
class BusinessSegment(_Record):
    name: str
    revenue: float
    margin: float
    percentage_of_total: Optional[float] = None

    _SPEC = {
        "name": ("str", False), "revenue": ("float", False),
        "margin": ("float", False), "percentage_of_total": ("float", True),
    }


@dataclass(init=False)
class FinancialRatio(_Record):
    name: str
    value: float
    growth_yoy: Optional[float] = None
    unit: Optional[str] = "ratio"

    _SPEC = {
        "name": ("str", False), "value": ("float", False),
        "growth_yoy": ("float", True), "unit": ("str", True),
    }


@dataclass(init=False)
class BalanceSheetItem(_Record):
    name: str
    value: float
    percentage_of_total: Optional[float] = None
    unit: Optional[str] = "crore"

    _SPEC = {
        "name": ("str", False), "value": ("float", False),
        "percentage_of_total": ("float", True), "unit": ("str", True),
    }


@dataclass(init=False)
class ExtractedEntities(_Record):
    """All entities extracted from a chunk."""

    quarter: Optional[str] = None
    financial_metrics: List[FinancialMetric] = field(default_factory=list)
    business_segments: List[BusinessSegment] = field(default_factory=list)
    financial_ratios: List[FinancialRatio] = field(default_factory=list)
    balance_sheet_items: List[BalanceSheetItem] = field(default_factory=list)

    _SPEC = {
        "quarter": ("str", True),
        "financial_metrics": (FinancialMetric, False),
        "business_segments": (BusinessSegment, False),
        "financial_ratios": (FinancialRatio, False),
        "balance_sheet_items": (BalanceSheetItem, False),
    }

    def total_count(self) -> int:
        return (
            len(self.financial_metrics)
            + len(self.business_segments)
            + len(self.financial_ratios)
            + len(self.balance_sheet_items)
        )


# ===============================
# API REQUEST MODELS
# ===============================


@dataclass(init=False)
class GraphQueryRequest(_Record):
    """Body of the graph service's query endpoint (question of at least 5
    characters, limit in 1..100)."""

    question: str
    limit: int = 10

    _SPEC = {"question": ("str", False), "limit": ("int", False)}

    def _validate(self) -> None:
        if len(self.question) < 5:
            raise ValidationError("question: shorter than 5 characters")
        if not 1 <= self.limit <= 100:
            raise ValidationError(f"limit: {self.limit} is not in 1..100")
