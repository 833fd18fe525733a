"""Cross-chunk conflict detection, abstention, and continuity adjudication.

Round-3 verdict items #2/#3. The single-document integrity defense
(:mod:`ragfin_tpu.retrieval.consistency`) is provably blind to two attack
classes:

- **scale-consistent tampering** — every ₹ amount in a chunk multiplied by
  one constant preserves all declared shares/margins/ratios/subset sums
  (they are scale-invariant), so in-text arithmetic scores 1.0;
- **fabrication** — internally-consistent regenerated statements.

Both, however, necessarily create the same observable: the scoped candidate
set contains MUTUALLY CONTRADICTORY figure sets for one (company, period,
chunk_type) scope. No ranking function can identify the authentic member
without external evidence (the documented impossibility bound), but the
engine can do two honest things instead of confidently serving a forgery:

1. **Conflict detection** (:func:`detect_conflicts`): cluster co-scoped
   candidates by their labeled figures; if members disagree irreconcilably,
   flag the scope as contested. Serving surfaces carry ``conflict: true``
   and the analytical answerer ABSTAINS rather than answering from a
   contested bucket. This is the buildable core of the provenance gap the
   reference leaves open (its fusion trusts the store unconditionally,
   ``graph_cons.py:268-342``).

2. **Continuity adjudication** (:func:`continuity_score`): best-effort
   cross-period corroboration — rank contested-bucket members by how well
   their absolute scale coheres with adjacent-period chunks of the same
   company/type. MEASURED LIMIT (scripts/scale_adjudication_probe.py,
   eval_results/scale_adjudication_probe.json): authentic quarter-over-
   quarter drift has median |log ratio| ≈ 0.07, larger than the flattest
   adversarial factor combination (≈ 0.025 among 6^4 combos), so neither
   per-member consensus (gold-first 63/160 even with gold-only
   corroborators) nor joint coherent-quarter-set selection (all-gold picked
   0/40) identifies the authentic member reliably. The observable
   equivalence class {gold × factor} is unbreakable in-band: scaling
   attacks join fabrication under the impossibility bound, and flag +
   abstain (above) is the production defense. Adjudication remains useful
   as a tie-break that measurably improves recall under mild attacks
   (sparse-adversary eval arm) — never as an authenticity proof.

Pure host-side text analysis over a small shortlist (tens of chunks); no
device work. Figures are parsed once per chunk and cached by the caller.
"""

from __future__ import annotations

import math
import re
import statistics
from typing import Optional, Sequence

# "• Advances: ₹1,124,875 crore (...)" / "NET PROFIT: ₹10,636 crore" /
# "TOTAL SEGMENT REVENUE: ₹87,473 crore" — labeled currency amounts.
_AMOUNT_LINE = re.compile(
    r"^\s*(?:•\s*)?([A-Za-z][A-Za-z &/()'.-]{1,60}?)\s*:\s*₹\s*([\d,]+(?:\.\d+)?)\s*crore",
    re.MULTILINE,
)
# "• Basic EPS: ₹15.22 per share"
_PER_SHARE_LINE = re.compile(
    r"^\s*(?:•\s*)?([A-Za-z][A-Za-z &/()'.-]{1,60}?)\s*:\s*₹\s*([\d.]+)\s*per share",
    re.MULTILINE,
)
# Inline pairs "Interest: ₹X crore | Operating: ₹Y crore"
_INLINE_AMOUNT = re.compile(
    r"([A-Za-z][A-Za-z &/()'.-]{1,40}?)\s*:\s*₹\s*([\d,]+(?:\.\d+)?)\s*crore"
)


def _norm_label(label: str) -> str:
    return re.sub(r"\s+", " ", label.strip().lower())


def labeled_figures(text: str) -> dict[str, float]:
    """``{normalized line label: ₹ value}`` for every labeled amount.

    First occurrence wins per label (section headers repeat labels like
    "Revenue" across segment blocks; the per-segment context is captured by
    prefixing the enclosing SEGMENT header when present)."""
    figs: dict[str, float] = {}
    segment = None
    for line in text.split("\n"):
        header = re.match(r"^\s*([A-Z][A-Z &]+) SEGMENT\s*:?\s*$", line)
        if header:
            segment = _norm_label(header.group(1))
            continue
        if not line.strip():
            segment = None
        for pat in (_AMOUNT_LINE, _PER_SHARE_LINE, _INLINE_AMOUNT):
            for m in pat.finditer(line):
                label = _norm_label(m.group(1))
                if segment:
                    label = f"{segment}/{label}"
                value = float(m.group(2).replace(",", ""))
                figs.setdefault(label, value)
    return figs


def figures_disagree(
    a: dict[str, float], b: dict[str, float], rel_tol: float = 0.02
) -> tuple[int, int]:
    """(labels disagreeing beyond rel_tol, labels shared)."""
    shared = [k for k in a if k in b]
    disagree = sum(
        1
        for k in shared
        if abs(a[k] - b[k]) > rel_tol * max(abs(a[k]), abs(b[k]), 1.0)
    )
    return disagree, len(shared)


def detect_conflicts(
    hits: Sequence,
    min_shared: int = 3,
    min_disagree: int = 2,
    cache: Optional[dict] = None,
) -> dict:
    """Flag contested scopes in a search shortlist.

    ``hits`` are SearchHit-likes (``.record`` with company/period/chunk_type/
    text/id). Returns ``{scope_key: {"ids": [...], "conflict": bool}}`` for
    every scope with >= 2 members; a scope conflicts when some member pair
    shares >= ``min_shared`` labels and disagrees on >= ``min_disagree`` of
    them (near-duplicate figure sets within print-rounding are NOT
    conflicts — authentic corpora legitimately repeat chunks across
    snapshots)."""
    groups: dict[tuple, list] = {}
    for h in hits:
        rec = h.record
        key = (rec.company, rec.period, rec.chunk_type)
        groups.setdefault(key, []).append(h)

    def figs_for(h):
        if cache is not None and h.record.id in cache:
            return cache[h.record.id]
        f = labeled_figures(h.record.text)
        if cache is not None:
            cache[h.record.id] = f
        return f

    out: dict = {}
    for key, members in groups.items():
        if len(members) < 2:
            continue
        conflict = False
        figs = [figs_for(h) for h in members]
        for i in range(len(members)):
            for j in range(i + 1, len(members)):
                disagree, shared = figures_disagree(figs[i], figs[j])
                if shared >= min_shared and disagree >= min_disagree:
                    conflict = True
                    break
            if conflict:
                break
        out[key] = {"ids": [h.record.id for h in members], "conflict": conflict}
    return out


def continuity_score(
    figs: dict[str, float], corroborators: Sequence[dict[str, float]], min_labels: int = 2
) -> Optional[float]:
    """|median per-label log-ratio| of ``figs`` against the corroborator
    consensus — the uniform-scale displacement statistic.

    An authentic chunk drifts label-by-label against adjacent periods
    (advances +3%, deposits +5%, ...) with a small median displacement; a
    uniformly-scaled forgery shifts EVERY label by log(factor), moving the
    median by that amount. Returns None when fewer than ``min_labels``
    labels have corroborating values (no cross-chunk evidence)."""
    logs = []
    for label, value in figs.items():
        if value <= 0:
            continue
        vals = [c[label] for c in corroborators if c.get(label, 0) > 0]
        if vals:
            logs.append(math.log(value / statistics.median(vals)))
    if len(logs) < min_labels:
        return None
    return abs(statistics.median(logs))


def adjudicate_bucket(
    members: Sequence,
    corroborator_figs: Sequence[dict[str, float]],
    cache: Optional[dict] = None,
) -> list:
    """Order contested bucket members most-corroborated-first.

    Returns ``[(hit, score), ...]`` sorted by ascending continuity
    displacement (None scores sort last). Ties keep input order. This is a
    best-effort ranking signal, NOT proof of authenticity — valid only
    while authentic corroborators dominate the consensus (documented
    density bound)."""

    def figs_for(h):
        if cache is not None and h.record.id in cache:
            return cache[h.record.id]
        f = labeled_figures(h.record.text)
        if cache is not None:
            cache[h.record.id] = f
        return f

    scored = []
    for pos, h in enumerate(members):
        s = continuity_score(figs_for(h), corroborator_figs)
        scored.append((s if s is not None else float("inf"), pos, h))
    scored.sort(key=lambda t: (t[0], t[1]))
    return [(h, (None if s == float("inf") else s)) for s, _, h in scored]


class ContinuityAdjudicatedSearch:
    """Searcher wrapper: adjudicate contested buckets by cross-period
    continuity before trimming to ``top_k``.

    Wraps any ``search_texts``-style searcher (FilteredSearch or a raw
    index). For each query shortlist it detects contested scopes, gathers
    corroborator figure sets for each (same company + chunk_type, OTHER
    periods, in-text-consistency-passing index records), reorders contested
    bucket members most-corroborated-first, and trims. This is the defense
    against the SPARSE scale-consistent forger: valid while authentic
    corroborators dominate the cross-period consensus; at forgery densities
    where they don't, the consensus itself is forged and the documented
    impossibility bound applies (eval arms measure both regimes honestly).
    """

    def __init__(self, searcher, index, fetch_k: int = 32, max_corroborators: int = 16):
        self.searcher = searcher
        self.index = index
        self.fetch_k = fetch_k
        self.max_corroborators = max_corroborators
        self._figure_cache: dict = {}
        self._corrob_cache: dict = {}

    def _corroborator_figs(self, company: str, chunk_type: str, exclude_period: str) -> list:
        key = (company, chunk_type, exclude_period)
        if key in self._corrob_cache:
            return self._corrob_cache[key]
        from .consistency import consistency_checks

        figs = []
        for rec in self.index.records:
            if (
                rec.company == company
                and rec.chunk_type == chunk_type
                and rec.period != exclude_period
            ):
                passed, checks = consistency_checks(rec.text)
                if checks and passed < checks:
                    continue  # crude tampering never corroborates
                figs.append(labeled_figures(rec.text))
                if len(figs) >= self.max_corroborators:
                    break
        self._corrob_cache[key] = figs
        return figs

    def _adjudicate(self, hits: list, top_k: int) -> list:
        scopes = detect_conflicts(hits, cache=self._figure_cache)
        contested = {k for k, info in scopes.items() if info["conflict"]}
        if not contested:
            return hits[:top_k]
        out = list(hits)
        for scope in contested:
            company, period, chunk_type = scope
            positions = [
                i
                for i, h in enumerate(out)
                if (h.record.company, h.record.period, h.record.chunk_type) == scope
            ]
            members = [out[i] for i in positions]
            corroborators = self._corroborator_figs(company, chunk_type, period)
            if not corroborators:
                continue
            ranked = adjudicate_bucket(members, corroborators, cache=self._figure_cache)
            for pos, (h, _score) in zip(positions, ranked):
                out[pos] = h
                h.conflict = True
        for rank, h in enumerate(out[:top_k]):
            h.rank = rank
        return out[:top_k]

    def search_texts(self, queries, top_k: int = 3, **kwargs):
        fetch = max(top_k, self.fetch_k)
        results = self.searcher.search_texts(queries, top_k=fetch, **kwargs)
        return [self._adjudicate(hits, top_k) for hits in results]
