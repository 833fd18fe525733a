"""Answer-quality evaluation (C22 metric definitions).

Implements the evaluation guidelines embedded in the reference's
``qa_subset.json`` (end-of-file guidelines: Answer Accuracy with numerical
tolerance ±2% or ±₹50 crore, answer relevance, faithfulness-by-grounding):
ground-truth figures must appear in the generated answer within tolerance.
Works offline against extractive answers as well as LLM answers.
"""

from __future__ import annotations

import re
import statistics
from dataclasses import dataclass
from typing import Optional, Sequence

from .datasets import EvalQuestion

# A '-' directly preceded by a digit is a RANGE separator ("10,636-11,672"),
# not a sign — without the lookbehind the second endpoint extracted negative.
_NUM_RE = re.compile(r"(?<!\d)-?\d[\d,]*(?:\.\d+)?")
# Scope tokens are retrieval keys, not answer figures: counting Q1/FY2024/
# 2024 as expected numbers penalizes correct paraphrased answers ("the
# first quarter of FY2024") and credits unrelated figures that land in the
# year's tolerance window.
_SCOPE_RE = re.compile(r"\bQ[1-4]\b|\bFY\s?\d{4}\b|\b20\d{2}\b", re.IGNORECASE)

TOLERANCE_PCT = 2.0
TOLERANCE_ABS_CRORE = 50.0
# The ±₹50-crore absolute tolerance only applies to crore-scale absolute
# values (reference guideline: "±2% for percentages, ±₹50 crore for absolute
# values", qa_subset.json evaluation_guidelines) — and only where it is at
# least as TIGHT as the ±2% relative window (crossover at 2500): below that
# it would accept up to ~50% relative error (a 157-crore figure matching
# anything in 107-207). Percentages/ratios/EPS are all < 100 here.
ABS_TOLERANCE_MIN_MAGNITUDE = 2500.0


def extract_numbers(text: str) -> list[float]:
    """All numbers in a text, commas stripped (₹10,636.5 crore → 10636.5)."""
    out = []
    for tok in _NUM_RE.findall(text or ""):
        try:
            out.append(float(tok.replace(",", "")))
        except ValueError:
            continue
    return out


def extract_figures(text: str) -> list[float]:
    """Answer FIGURES: all numbers minus period/scope tokens (see
    _SCOPE_RE)."""
    return extract_numbers(_SCOPE_RE.sub(" ", text or ""))


def number_matches(expected: float, candidates: Sequence[float]) -> bool:
    """Tolerance match per the dataset guidelines: ±2% relative always; the
    ±₹50-crore absolute window only for crore-scale absolute values (applying
    it to a percentage like 69.9 or an EPS like 15.22 would accept wildly
    wrong answers)."""
    for c in candidates:
        if expected == 0:
            if c == 0:
                return True
        elif abs(c - expected) / abs(expected) * 100 <= TOLERANCE_PCT:
            return True
        elif (
            abs(expected) >= ABS_TOLERANCE_MIN_MAGNITUDE
            and abs(c - expected) <= TOLERANCE_ABS_CRORE
        ):
            return True
    return False


def answer_accuracy(answer: str, ground_truth: str) -> Optional[float]:
    """Fraction of ground-truth figures recovered in the answer.

    Returns None when the ground truth contains no numbers (non-numeric
    questions fall back to token overlap)."""
    expected = extract_figures(ground_truth)
    got = extract_figures(answer)
    if not expected:
        return None
    return sum(1 for e in expected if number_matches(e, got)) / len(expected)


def token_overlap(answer: str, ground_truth: str) -> float:
    a = set(re.findall(r"[a-z0-9]+", (answer or "").lower()))
    g = set(re.findall(r"[a-z0-9]+", (ground_truth or "").lower()))
    return len(a & g) / len(g) if g else 0.0


def _derived_pool(context_nums: Sequence[float], cap: int = 256) -> list[float]:
    """Figures derivable from pairs of context numbers: differences and
    percent changes. An analytical answer that reports "+5.4% (from ₹26,306
    to ₹27,719 crore)" is fully grounded — the delta is arithmetic over
    context figures, exactly what an LLM-judge faithfulness check credits."""
    nums = list(dict.fromkeys(context_nums))[:cap]
    out: list[float] = []
    for i, a in enumerate(nums):
        for b in nums[i + 1:]:
            out.append(abs(a - b))
            if a:
                out.append((b - a) / abs(a) * 100)
            if b:
                out.append((a - b) / abs(b) * 100)
    return out


def faithfulness(answer: str, contexts: Sequence[str]) -> Optional[float]:
    """Grounding proxy for the RAGAS faithfulness slot (C23): fraction of
    numbers in the answer that appear in the retrieved contexts (within the
    dataset's numeric tolerance) or are pairwise-derivable from them
    (differences / percent changes — see :func:`_derived_pool`). None when
    the answer has no numbers."""
    nums = extract_figures(answer)
    if not nums:
        return None
    context_nums = extract_numbers(" ".join(contexts))
    grounded = 0
    derived: Optional[list[float]] = None
    for n in nums:
        if number_matches(n, context_nums):
            grounded += 1
            continue
        if derived is None:
            derived = _derived_pool(context_nums)
        if _matches_derived(n, derived):
            grounded += 1
    return grounded / len(nums)


def _matches_derived(n: float, derived: Sequence[float]) -> bool:
    """Match against DERIVED values with a much tighter tolerance than the
    dataset's answer tolerance. The derived pool is O(pairs²) large, so the
    ±2%/±₹50cr windows would credit almost any invented figure (with ~60
    context numbers nearly every magnitude has a pool member within 2%);
    a genuine arithmetic derivation reproduces the pool value to rounding
    precision, so 0.1% relative (plus 0.06 absolute for one-decimal
    percent/pp roundings) keeps real derivations while failing
    hallucinations."""
    for c in derived:
        if abs(c - n) <= 0.06:
            return True
        if n and abs(c - n) / abs(n) * 100 <= 0.1:
            return True
    return False


@dataclass
class AnswerResult:
    id: str
    category: str
    accuracy: float
    mode: str  # "numeric" | "overlap"
    faithfulness: Optional[float] = None


async def evaluate_answers(vector_rag, questions: Sequence[EvalQuestion], top_k: int = 3) -> dict:
    """Run search_and_answer per question and score against ground truth."""
    import asyncio

    results: list[AnswerResult] = []
    detailed: list[dict] = []
    # Concurrent answers (order preserved): search_and_answer offloads its
    # blocking search precisely so concurrent calls coalesce in the query
    # micro-batcher — a sequential await would feed it one query at a time.
    outs = await asyncio.gather(
        *(vector_rag.search_and_answer(q.question, top_k=top_k) for q in questions)
    )
    for q, out in zip(questions, outs):
        answer = out.get("answer", "")
        contexts = [c.get("text", "") for c in out.get("contexts", [])]
        faith = faithfulness(answer, contexts)
        acc = answer_accuracy(answer, q.ground_truth_answer)
        if acc is None:
            results.append(
                AnswerResult(q.id, q.category, token_overlap(answer, q.ground_truth_answer), "overlap", faith)
            )
        else:
            results.append(AnswerResult(q.id, q.category, acc, "numeric", faith))
        # Per-question record in the shape of the reference's detailed-results
        # file (res_ablation/icici_rag_with_ragas_detailed_results.json).
        detailed.append(
            {
                "question_id": q.id,
                "question": q.question,
                "category": q.category,
                "ground_truth_answer": q.ground_truth_answer,
                "generated_answer": answer,
                "retrieved_chunks": [c.get("id") for c in out.get("contexts", [])],
                "answer_accuracy": results[-1].accuracy,
                "faithfulness": faith,
            }
        )
    by_cat: dict[str, list[float]] = {}
    for r in results:
        by_cat.setdefault(r.category, []).append(r.accuracy)
    faith_vals = [r.faithfulness for r in results if r.faithfulness is not None]
    return {
        "questions": len(results),
        "answer_accuracy_mean": statistics.fmean([r.accuracy for r in results]) if results else 0.0,
        "faithfulness_mean": statistics.fmean(faith_vals) if faith_vals else None,
        "numeric_questions": sum(1 for r in results if r.mode == "numeric"),
        "accuracy_by_category": {c: statistics.fmean(v) for c, v in sorted(by_cat.items())},
        "per_question": [
            {"id": r.id, "accuracy": r.accuracy, "mode": r.mode, "faithfulness": r.faithfulness}
            for r in results
        ],
        "detailed_results": detailed,
    }
