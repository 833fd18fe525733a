"""Domain constants: entity vocabulary, quarters, chunk types, model registry.

Behavioral parity with the reference's vocabulary tables
(``graph_rag_mcp/constants.py:6-37``): the knowledge-graph entity names below
are the canonical node names the extraction prompt and graph queries use.
They double as the *fixed integer vocabulary* of the device-resident CSR graph
(:mod:`ragfin_tpu.index.graph_index`).
"""

from __future__ import annotations

FINANCIAL_ENTITY_TYPES: dict[str, list[str]] = {
    "financial_metrics": [
        "NET PROFIT",
        "Operating Profit",
        "Total Income",
        "Interest Income",
        "Other Income",
        "Total Expenses",
        "Interest Expenses",
        "Operating Expenses",
        "Provisions",
    ],
    "business_segments": [
        "RETAIL BANKING SEGMENT",
        "WHOLESALE BANKING SEGMENT",
        "TREASURY SEGMENT",
        "LIFE INSURANCE SEGMENT",
        "OTHERS SEGMENT",
    ],
    "financial_ratios": [
        "Basic EPS",
        "Diluted EPS",
        "Net Margin",
        "Operating Margin",
        "Cost Ratio",
    ],
    "balance_sheet_items": [
        "Advances",
        "Investments",
        "Customer Deposits",
        "Total Assets",
        "Total Equity",
        "Cash & RBI Balances",
        "Borrowings",
        "Share Capital",
        "Reserves & Surplus",
    ],
}

SUPPORTED_QUARTERS = ["Q1_FY2024", "Q2_FY2024", "Q3_FY2024", "Q4_FY2024"]

CHUNK_TYPES = [
    "profitability_analysis",
    "balance_sheet_analysis",
    "financial_ratios",
    "segment_analysis",
]

# Per-model rate limits / token budgets (reference: graph_rag_mcp/constants.py:31-37).
SUPPORTED_MODELS: dict[str, dict[str, float | int]] = {
    "gemini-2.0-flash": {"rate_limit": 4.0, "max_tokens": 8192},
    "gemini-1.5-pro": {"rate_limit": 2.0, "max_tokens": 8192},
    "gpt-3.5-turbo": {"rate_limit": 1.0, "max_tokens": 8192},
    "llama3.1:8b": {"rate_limit": 0.5, "max_tokens": 4096},
    "groq-llama": {"rate_limit": 0.5, "max_tokens": 8192},
    # Deterministic in-process provider for tests / offline runs (no reference
    # counterpart; SURVEY.md §4 calls for a fake provider).
    "fake": {"rate_limit": 0.0, "max_tokens": 8192},
}

# Embedding geometry (reference: chunking_storing (1).py:17 — dim=384 MiniLM).
EMBED_DIM = 384

# Milvus-collection-equivalent name for the packed device index
# (reference: chunking_storing (1).py:28).
DEFAULT_COLLECTION = "fin_chunks"

# Service port registry (reference SURVEY.md §5: 8001 entity, 8002 graph,
# 9001/9002 adapters, 9006/9007/9008 MCP servers).
PORTS = {
    "entity_service": 8001,
    "graph_service": 8002,
    "vector_adapter": 9001,
    "graph_adapter": 9002,
    "vector_mcp": 9006,
    "graph_mcp": 9007,
    "graph_mcp_monolith": 9008,
}


def validate_quarter(quarter: str) -> bool:
    """Validate quarter format (reference: constants.py:40-42)."""
    return quarter in SUPPORTED_QUARTERS


def validate_chunk_type(chunk_type: str) -> bool:
    """Validate chunk type (reference: constants.py:44-46)."""
    return chunk_type in CHUNK_TYPES
