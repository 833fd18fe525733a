"""Loaders for the reference evaluation datasets.

Parses the two labeled QA sets shipped with the reference (SURVEY.md C22):

- ``qa_subset.json`` — 40 questions, 10 per category, each with
  ``expected_relevant_chunks`` (chunk-id relevance labels), ground-truth
  answers and supporting facts (reference ``qa_subset.json:2-9``).
- ``vector_rag_evaluation_dataset.json`` — 15 questions with difficulty
  tiers and ``expected_chunks`` in a period-prefixed naming scheme that is
  normalized here to real chunk ids.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class EvalQuestion:
    id: str
    category: str
    question: str
    expected_chunks: list[str]
    ground_truth_answer: str = ""
    difficulty: Optional[str] = None
    key_supporting_facts: list[str] = field(default_factory=list)


# vector_rag_evaluation_dataset chunk labels look like
# "Q1_FY2024_profitability_analysis"; real corpus ids look like
# "icici_q1_fy2024_profitability_analysis" with type-specific suffixes.
_TYPE_SUFFIX = {
    "profitability_analysis": "profitability_analysis",
    "balance_sheet_analysis": "balance_sheet_health",
    "financial_ratios": "key_ratios",
    "segment_analysis": "segment_performance",
}
_EVAL_LABEL = re.compile(r"^(Q[1-4]_FY\d{4})_(.+)$")


def normalize_chunk_label(label: str) -> str:
    """Map an eval-dataset chunk label to the canonical corpus chunk id."""
    if label.startswith("icici_"):
        return label
    m = _EVAL_LABEL.match(label)
    if not m:
        return label
    period, kind = m.groups()
    suffix = _TYPE_SUFFIX.get(kind, kind)
    return f"icici_{period.lower()}_{suffix}"


def load_qa_subset(path: str) -> list[EvalQuestion]:
    with open(path) as f:
        data = json.load(f)
    out = []
    for q in data["questions"]:
        out.append(
            EvalQuestion(
                id=q["id"],
                category=q.get("category", ""),
                question=q["question"],
                expected_chunks=[normalize_chunk_label(c) for c in q.get("expected_relevant_chunks", [])],
                ground_truth_answer=q.get("ground_truth_answer", ""),
                key_supporting_facts=q.get("key_supporting_facts", []),
            )
        )
    return out


def load_holdout_phrasings(path: Optional[str] = None) -> list[EvalQuestion]:
    """Hand-written held-out phrasings: colloquial,
    abbreviation-heavy, misspelled, and compositional questions AUTHORED BY
    HAND in styles the pairgen/synonyms generators cannot emit — the
    distribution-shift probe the template-trained encoder was never graded
    on. Ships with the package (``eval/holdout_phrasings.json``); the style
    is carried in ``category`` so reports break down by shift type."""
    import os

    if path is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "holdout_phrasings.json")
    with open(path) as f:
        data = json.load(f)
    return [
        EvalQuestion(
            id=q["id"],
            category=q["style"],
            question=q["question"],
            expected_chunks=[normalize_chunk_label(c) for c in q["expected_relevant_chunks"]],
        )
        for q in data["questions"]
    ]


def load_vector_eval(path: str) -> list[EvalQuestion]:
    with open(path) as f:
        data = json.load(f)
    out = []
    for q in data["evaluation_questions"]:
        out.append(
            EvalQuestion(
                id=q["id"],
                category=q.get("category", ""),
                question=q["question"],
                expected_chunks=[normalize_chunk_label(c) for c in q.get("expected_chunks", [])],
                ground_truth_answer=q.get("expected_answer", ""),
                difficulty=q.get("difficulty"),
            )
        )
    return out
