"""Corpus loading: raw quarterly statement JSON → chunk records.

Host-side equivalent of the main processing loop in the reference index-build
script (``chunking_storing (1).py:335-374``): walk ``extract_data/icici_q*``
folders, parse every JSON file, and run the chunker per quarter. Also loads a
frozen chunk snapshot (the 16-chunk oracle at
``FinRag_knowledge_graph/chunks.json``) for parity testing and offline runs.
"""

from __future__ import annotations

import json
import os
from glob import glob
from typing import Any, Optional

from .chunker import create_complete_context_chunks
from .models import FinancialChunk, IndexedChunk

# Quarter-folder suffix → canonical period (reference :339-345).
DEFAULT_PERIOD_MAPPING = {
    "q1_2023": "Q1_FY2024",
    "q2_2023": "Q2_FY2024",
    "q3_2023": "Q3_FY2024",
    "q4_2023": "Q4_FY2024",
}


def load_quarter_files(quarter_folder: str) -> list[dict[str, Any]]:
    """Load every JSON statement file in one quarter folder."""
    data = []
    for path in sorted(glob(os.path.join(quarter_folder, "*.json"))):
        try:
            with open(path, "r") as f:
                data.append(json.load(f))
        except (OSError, json.JSONDecodeError):
            continue
    return data


def build_corpus(
    data_folder: str,
    period_mapping: Optional[dict[str, str]] = None,
    company_prefix: str = "icici",
) -> list[IndexedChunk]:
    """Chunk all quarters found under ``data_folder``.

    Returns the concatenated chunk list (4 chunks per complete quarter).
    """
    mapping = period_mapping or DEFAULT_PERIOD_MAPPING
    chunks: list[IndexedChunk] = []
    for quarter, period in mapping.items():
        folder = os.path.join(data_folder, f"{company_prefix}_{quarter}")
        if not os.path.isdir(folder):
            continue
        quarterly_data = load_quarter_files(folder)
        # Forward the company prefix into the chunk ids: without it every
        # company's chunks would get "icici_*" ids and collide when two
        # companies are indexed together.
        chunks.extend(
            create_complete_context_chunks(
                quarterly_data, period, id_prefix=company_prefix
            )
        )
    return chunks


def load_chunk_snapshot(path: str) -> list[IndexedChunk]:
    """Load a frozen chunk snapshot in the reference's ``chunks.json`` shape.

    Snapshot records carry ``{id, period, type, size, text}``
    (FinancialChunk shape); we rehydrate the full sidecar record with the
    chunk type mapped back to ``chunk_type``.
    """
    with open(path, "r") as f:
        raw = json.load(f)
    return [
        IndexedChunk(
            id=rec["id"],
            text=rec["text"],
            period=rec["period"],
            chunk_type=rec.get("type") or rec.get("chunk_type", ""),
            primary_value=rec.get("primary_value", 0.0),
        )
        for rec in raw
    ]


def chunks_to_api(chunks: list[IndexedChunk]) -> list[FinancialChunk]:
    """Convert sidecar records to the public FinancialChunk API shape."""
    return [c.to_financial_chunk() for c in chunks]


def save_chunk_snapshot(chunks: list[IndexedChunk], path: str) -> None:
    """Persist chunks in the reference snapshot shape (id/period/type/size/text)."""
    records = [
        {
            "id": c.id,
            "period": c.period,
            "type": c.chunk_type,
            "size": len(c.text),
            "text": c.text,
        }
        for c in chunks
    ]
    with open(path, "w") as f:
        json.dump(records, f, ensure_ascii=False, indent=2)
