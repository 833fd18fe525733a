"""The sidecar record stored next to each embedding row.

Counterpart of ``ragfin_tpu/data/models.py:IndexedChunk``, as a dataclass
with the same fields and defaults (the port does not depend on pydantic).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass
class IndexedChunk:
    """Milvus ``fin_chunks`` schema: id, text, period, chunk_type,
    statement_type, primary_value, plus the company scope."""

    id: str
    text: str
    period: str
    chunk_type: str
    statement_type: str = "consolidated"
    primary_value: float = 0.0
    company: str = "ICICI Bank"

    def model_dump(self) -> dict:
        """Field dict (the pydantic method name the JAX records answer to)."""
        return dataclasses.asdict(self)
