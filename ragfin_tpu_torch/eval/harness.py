"""Retrieval evaluation harness: recall@k / precision@k / F1 over labeled QA.

Rebuilds the eval instrument whose *outputs* ship with the reference
(``res_ablation/icici_rag_with_ragas_research_summary.json`` — retrieval
P/R/F1 means+std, per-category and per-difficulty breakdowns) but whose code
does not (SURVEY.md §4). recall@10 on ``qa_subset.json`` is the parity gate
(BASELINE.md rebuild targets).
"""

from __future__ import annotations

import statistics
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional, Sequence

from .datasets import EvalQuestion


@dataclass
class QuestionResult:
    id: str
    category: str
    difficulty: Optional[str]
    expected: list[str]
    retrieved: list[str]
    precision: float
    recall: float
    f1: float
    latency_s: float = 0.0


@dataclass
class EvalReport:
    k: int
    results: list[QuestionResult] = field(default_factory=list)

    def _mean_std(self, vals: list[float]) -> dict:
        return {
            "mean": statistics.fmean(vals) if vals else 0.0,
            "std": statistics.pstdev(vals) if len(vals) > 1 else 0.0,
        }

    def summary(self) -> dict:
        recs = [r.recall for r in self.results]
        precs = [r.precision for r in self.results]
        f1s = [r.f1 for r in self.results]
        by_cat = defaultdict(list)
        by_diff = defaultdict(list)
        for r in self.results:
            by_cat[r.category].append(r.f1)
            if r.difficulty:
                by_diff[r.difficulty].append(r.f1)
        return {
            "questions_evaluated": len(self.results),
            "k": self.k,
            "retrieval_precision": self._mean_std(precs),
            "retrieval_recall": self._mean_std(recs),
            "retrieval_f1": self._mean_std(f1s),
            "perfect_retrievals": sum(1 for r in self.results if r.recall == 1.0),
            "zero_recall_queries": sum(1 for r in self.results if r.recall == 0.0),
            "avg_chunks_retrieved": statistics.fmean(len(r.retrieved) for r in self.results)
            if self.results
            else 0.0,
            "f1_by_category": {c: self._mean_std(v)["mean"] for c, v in sorted(by_cat.items())},
            "f1_by_difficulty": {d: self._mean_std(v)["mean"] for d, v in sorted(by_diff.items())},
            "mean_latency_ms": statistics.fmean(r.latency_s for r in self.results) * 1e3
            if self.results
            else 0.0,
        }


def score_retrieval(expected: Sequence[str], retrieved: Sequence[str]) -> tuple[float, float, float]:
    """Set precision/recall/F1 at the retrieved list (reference ablation metrics)."""
    exp, ret = set(expected), list(retrieved)
    if not ret or not exp:
        return 0.0, 0.0, 0.0
    hits = sum(1 for c in ret if c in exp)
    precision = hits / len(ret)
    recall = len(exp & set(ret)) / len(exp)
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    return precision, recall, f1


def to_research_summary(report: EvalReport, system_type: str = "ragfin_tpu_exact_flat") -> dict:
    """Emit the reference's research-summary shape
    (``res_ablation/icici_rag_with_ragas_research_summary.json``): evaluation
    metadata + retrieval mean/std + per-category and per-difficulty
    performance + system characteristics. RAGAS answer metrics require an
    LLM judge and stay empty offline (the reference also left them empty)."""
    import datetime

    precs = [r.precision for r in report.results]
    recs = [r.recall for r in report.results]
    f1s = [r.f1 for r in report.results]

    # One definition with EvalReport.summary(): the research-summary and
    # summary() artifacts must report identical statistics.
    ms = report._mean_std

    def mean(vals):
        return ms(vals)["mean"]

    def std(vals):
        return ms(vals)["std"]

    retrieval_metrics = {
        "precision_mean": mean(precs),
        "precision_std": std(precs),
        "recall_mean": mean(recs),
        "recall_std": std(recs),
        "f1_mean": mean(f1s),
        "f1_std": std(f1s),
    }
    by_cat: dict[str, list[QuestionResult]] = defaultdict(list)
    by_diff: dict[str, list[QuestionResult]] = defaultdict(list)
    for r in report.results:
        by_cat[r.category or "uncategorized"].append(r)
        if r.difficulty:
            by_diff[r.difficulty].append(r)

    def perf(group: dict[str, list[QuestionResult]]) -> dict:
        return {
            key: {
                "count": len(rs),
                "precision_mean": mean([x.precision for x in rs]),
                "recall_mean": mean([x.recall for x in rs]),
                "f1_mean": mean([x.f1 for x in rs]),
            }
            for key, rs in sorted(group.items())
        }

    return {
        "evaluation_metadata": {
            "total_questions": len(report.results),
            "evaluation_date": datetime.datetime.now().isoformat(),
            "system_type": system_type,
            "k": report.k,
        },
        "retrieval_metrics": retrieval_metrics,
        "ragas_metrics": {},
        "research_summary": {
            "retrieval_metrics": retrieval_metrics,
            "query_type_performance": perf(by_cat),
            "difficulty_performance": perf(by_diff),
            "system_characteristics": {
                "avg_chunks_retrieved": mean([len(r.retrieved) for r in report.results]),
                "perfect_retrievals": sum(1 for r in report.results if r.recall == 1.0),
                "zero_recall_queries": sum(1 for r in report.results if r.recall == 0.0),
                "mean_latency_ms": mean([r.latency_s for r in report.results]) * 1e3,
            },
        },
    }


def tie_aware_agreement(
    exact_wide, approx_ids, k: int = 10, eps: float = 1e-5, wide: Optional[int] = None
):
    """Agreement between an approximate retriever and the exact arm, scored
    ENTIRELY in the exact arm's score scale.

    ``exact_wide``: per-query exact results as ``[(id, score), ...]`` sorted
    score-descending, WIDER than ``k`` — the tie set is read off its tail.
    ``approx_ids``: per-query approximate result ids; only the first ``k``
    are scored (longer lists would otherwise push tie_aware above 1.0 when
    tie groups are large). Approximate-tier scores
    are deliberately not accepted: an approximate system's score scale (e.g.
    IVF's int8 cell scores) must never be compared against exact f32 scores —
    that cross-system epsilon would pollute the tie metric.

    ``wide`` is the width the exact search was ASKED for. With it, a query
    counts as truncated only when its list actually reached that width AND
    the last score still ties — a shorter list means the corpus was
    exhausted and the tie group is complete.
    Without it, any tying last score flags (conservative over-count).

    Returns ``(overlap, tie_aware, truncated)``: plain mean overlap@k; mean
    tie-aware agreement, where an approx id counts iff its EXACT score
    reaches the exact k-th score minus ``eps`` (template near-duplicates
    embed nearly identically, so any member of the exact tie group at rank
    <= k is an equally-correct answer and overlap@k alone is ill-defined);
    and the number of queries whose tie group ran past the wide list (the
    tie-aware number undercounts there — re-run with a wider exact search).
    """
    overlaps, ties_frac, truncated = [], [], 0
    for hits, a_ids in zip(exact_wide, approx_ids):
        top = list(hits[:k])
        if not top:
            continue
        e_ids = {i for i, _ in top}
        floor = min(s for _, s in top) - eps
        tie_set = {i for i, s in hits if s >= floor}
        reached_wide = len(hits) >= wide if wide is not None else len(hits) > k
        if reached_wide and hits[-1][1] >= floor:
            truncated += 1
        a = set(list(a_ids)[:k])
        overlaps.append(len(a & e_ids) / len(e_ids))
        ties_frac.append(len(a & tie_set) / len(e_ids))
    n = max(len(overlaps), 1)
    return sum(overlaps) / n, sum(ties_frac) / n, truncated


def evaluate_retrieval(
    index,
    questions: Sequence[EvalQuestion],
    k: int = 10,
    batch_size: int = 64,
    method: str = "auto",
) -> EvalReport:
    """Run top-k retrieval for every question and score against labels.

    ``index`` is anything with ``search_texts(queries, top_k) ->
    list[list[SearchHit]]`` (DeviceVectorIndex, ShardedVectorIndex, or the
    hybrid engine).
    """
    report = EvalReport(k=k)
    for start in range(0, len(questions), batch_size):
        batch = questions[start : start + batch_size]
        t0 = time.perf_counter()
        hit_lists = index.search_texts([q.question for q in batch], top_k=k, method=method)
        dt = (time.perf_counter() - t0) / max(len(batch), 1)
        for q, hits in zip(batch, hit_lists):
            retrieved = [h.id for h in hits]
            p, r, f1 = score_retrieval(q.expected_chunks, retrieved)
            report.results.append(
                QuestionResult(
                    id=q.id,
                    category=q.category,
                    difficulty=q.difficulty,
                    expected=list(q.expected_chunks),
                    retrieved=retrieved,
                    precision=p,
                    recall=r,
                    f1=f1,
                    latency_s=dt,
                )
            )
    return report
