"""In-text figure-consistency scoring for financial chunks.

Motivation (round-2 verdict, Weak #1): metadata filters cannot reject
IN-SCOPE forgeries — chunks with the right company/period/type whose figures
have been perturbed. But financial analysis text is redundant by
construction: it declares both components and derived values ("Advances:
₹1,124,875 crore (55.1% of total assets)" next to "Total: ₹2,039,897
crore"), so tampering with figures independently breaks arithmetic that the
document itself asserts. This module checks only *in-document* relations —
no external knowledge, no reference to the generator — making it a generic
data-integrity signal for any statement-style financial text:

1. **Declared percentages**: every "₹X crore (p% …)" whose base total is
   declared in the same section (or as a trailing TOTAL line) must satisfy
   X / T * 100 ≈ p.
2. **Margin triples**: a section declaring Revenue/Result/Margin (or
   profit/income/margin) must satisfy result / revenue * 100 ≈ p.
3. **Subset sums**: a section that declares a Total must contain some
   subset of its other ₹ amounts summing to it (components are printed
   rounded, so the match tolerance is proportional).

The score is the fraction of checkable relations that hold; documents with
no checkable relations score a neutral 0.5. Internally-consistent forgeries
(fully regenerated statements) pass by construction — consistency detects
*tampering*, not *fabrication*; see eval/distractors.py tier notes.

Reference anchor: the chunker's derived-figure templates
(``chunking_storing (1).py:91-330``) are what make real chunks consistent.

Copied from ``ragfin_tpu/retrieval/consistency.py``: the checks that
:mod:`ragfin_tpu_torch.retrieval.conflict` reads, and the multipliers that
integrity-weighted retrieval scales similarities by (``smooth``,
``strictify``; ``consistency_rerank`` serves the hashed backend's sparse
re-rank, not ported yet).
"""

from __future__ import annotations

import itertools
import re
from typing import Optional

# "₹1,124,875 crore" — the amount grammar of the chunk templates.
_AMOUNT = re.compile(r"₹\s*([\d,]+(?:\.\d+)?)\s*crore")
# "(55.1% of total assets)" / "(35.5%)" — a declared share directly after an
# amount on the same line. YoY growths "(+44.0% YoY…)" are excluded by the
# sign: growth percentages are not checkable in-document.
_AMOUNT_WITH_PCT = re.compile(
    r"₹\s*([\d,]+(?:\.\d+)?)\s*crore\s*\((\d[\d.]*)%[^)]*\)"
)
_PCT = re.compile(r"(-?\d[\d.]*)%")
# [^:₹\n] and [ \t] keep the match on ONE line (\s would consume
# newlines): without this a bare "total" mention binds an unrelated amount
# from a following line as a declared total, handing tampered chunks
# phantom bases/sum targets (checks only ever ADD passes, so spurious
# totals weaken the gate).
_TOTAL_LINE = re.compile(
    r"total[^:₹\n]*:?[ \t]*₹[ \t]*([\d,]+(?:\.\d+)?)[ \t]*crore", re.IGNORECASE
)


def _num(s: str) -> float:
    return float(s.replace(",", ""))


def _close_pct(computed: float, declared: float, tol_pp: float = 0.08) -> bool:
    """Printed percentages carry one decimal (±0.05pp print rounding);
    components are printed rounded to whole crore, which moves crore-scale
    ratios by well under 0.01pp — 0.08pp covers both with margin while
    keeping the accidental-match window for tampered figures tight."""
    return abs(computed - declared) <= tol_pp


def _close_sum(total: float, s: float) -> bool:
    # Components are rounded to whole crore; allow 1 crore per term plus
    # 0.1% relative slack for template-side rounding of the total itself.
    return abs(total - s) <= max(6.0, 0.001 * total)


def _section_blocks(text: str) -> list[str]:
    return [b for b in re.split(r"\n\s*\n", text) if b.strip()]


# "Net Margin: 20.4%" / "Cost Ratio: 69.9%" / "CASA Ratio: 45%" — every
# named ratio declaration; growth percentages carry an explicit sign and a
# "YoY" context and are excluded by the no-sign pattern + the ratio words.
_RATIO_DECL = re.compile(
    r"(?:margin|ratio|spread)\s*:?\s*(\d[\d.]*)%", re.IGNORECASE
)
_EPS_PAIR = re.compile(
    r"basic eps:?\s*₹\s*([\d.]+).*?diluted eps:?\s*₹\s*([\d.]+)",
    re.IGNORECASE | re.DOTALL,
)


def consistency_score(text: str) -> float:
    """Fraction of the document's checkable self-declared relations that
    hold (0.5 when nothing is checkable)."""
    passed, checks = consistency_checks(text)
    if checks == 0:
        return 0.5
    return passed / checks


def consistency_checks(text: str) -> tuple[int, int]:
    """(passed, checkable) relation counts for ``text``.

    Subset-sum matches count only as *positive* evidence: authentic filings
    legitimately list partial component breakdowns (ICICI's balance-sheet
    chunk lists 3 of the assets under Total), so a missing decomposition is
    not an inconsistency — but a found one is earned corroboration a
    figure-tampered copy loses."""
    checks = 0
    passed = 0

    blocks = _section_blocks(text)
    # Document-level totals ("TOTAL SEGMENT REVENUE: ₹87,473 crore",
    # "INCOME: Total ₹52,084 crore") serve as ratio bases for sections that
    # declare only the numerator ("Net Margin" lives two blocks above the
    # income total it divides by).
    doc_totals = [_num(m.group(1)) for m in _TOTAL_LINE.finditer(text)]

    for block in blocks:
        amounts = [_num(m.group(1)) for m in _AMOUNT.finditer(block)]
        block_totals = [_num(m.group(1)) for m in _TOTAL_LINE.finditer(block)]

        # 1. declared share percentages against a declared base total
        for m in _AMOUNT_WITH_PCT.finditer(block):
            x, p = _num(m.group(1)), float(m.group(2))
            if p <= 0:
                continue
            bases = block_totals + doc_totals
            if not bases:
                continue
            checks += 1
            if any(b > 0 and _close_pct(x / b * 100.0, p) for b in bases):
                passed += 1

        # 2. named ratios: some in-document value pair must reproduce them.
        # Numerators: this section's amounts (+ its totals). Denominators:
        # those plus document totals plus pairwise sums of section amounts
        # (funding ratios divide by deposits+borrowings, which is never
        # printed as a single figure).
        numers = amounts + block_totals
        denoms = (
            numers
            + doc_totals
            + [a + b for a, b in itertools.combinations(amounts, 2)]
        )
        for m in _RATIO_DECL.finditer(block):
            p = float(m.group(1))
            if p <= 0 or not numers:
                continue
            checks += 1
            if any(
                x > 0 and y <= x * 1.001 and _close_pct(y / x * 100.0, p)
                for y in numers
                for x in denoms
            ):
                passed += 1

        # 3. subset sums: positive-only evidence (see docstring)
        for t in block_totals:
            comps = [a for a in amounts if a != t and a < t * 1.001]
            comps = comps[:10]  # bound the 2^n scan; sections are tiny
            if len(comps) < 2:
                continue
            found = False
            for r in range(2, len(comps) + 1):
                for sub in itertools.combinations(comps, r):
                    if _close_sum(t, sum(sub)):
                        found = True
                        break
                if found:
                    break
            if found:
                checks += 1
                passed += 1

    # 4. EPS ordering: diluted EPS can never exceed basic EPS, and dilution
    # beyond 20% of basic would be extraordinary for a listed bank — an
    # independent perturbation of the pair lands outside the band ~2/3 of
    # the time.
    eps = _EPS_PAIR.search(text)
    if eps:
        basic, diluted = float(eps.group(1)), float(eps.group(2))
        checks += 1
        if basic * 0.8 <= diluted <= basic * 1.001:
            passed += 1

    return passed, checks


def consistency_multiplier(text: str, weight: float) -> float:
    """Similarity multiplier in [1-weight, 1].

    Documents with NO checkable relations stay at 1.0 (no penalty —
    uncheckable text is not evidence of tampering); a document failing all
    its checks is scaled by ``1 - weight``."""
    passed, checks = consistency_checks(text)
    if checks == 0:
        return 1.0
    return 1.0 - weight * (1.0 - passed / checks)


def smooth(m, weight: float):
    """Multiplier under the SMOOTH mode: scale by the pass fraction —
    ``1 - weight * (1 - m)``. The single definition all scoring paths
    (device column, host rerank, exact bucket) must share, or a future
    formula tweak would silently diverge them. Works elementwise on numpy
    arrays or floats."""
    import numpy as _np

    return 1.0 - weight * (1.0 - _np.asarray(m))


def strictify(m, weight: float):
    """Multiplier under the STRICT integrity gate: authentic statement text
    passes every self-declared arithmetic check by construction (the figures
    are generated by accounting identities), so ANY failed relation is
    evidence of tampering and collapses the multiplier to ``1 - weight``.
    Documents with no checkable relations (m == 1.0 by convention) are not
    penalized. Works elementwise on numpy arrays or floats."""
    import numpy as _np

    return _np.where(_np.asarray(m) >= 1.0, 1.0, 1.0 - weight)


def consistency_rerank(
    hits: list,
    top_k: int,
    weight: float = 0.5,
    cache: Optional[dict] = None,
    strict: bool = True,
) -> list:
    """Re-order a hit shortlist by ``similarity * consistency_multiplier``.
    ``weight=0`` is a no-op. The similarity used is each hit's current
    ``score`` (post sparse re-rank); the multiplier is cached per chunk id
    (``cache``) since chunk text is immutable in an index. ``strict`` applies
    the all-checks-must-pass gate (see :func:`strictify`); smooth mode
    scales by the pass fraction instead."""
    if weight <= 0 or not hits:
        return hits[:top_k]
    rescored = []
    for h in hits:
        key = h.record.id
        if cache is not None and key in cache:
            m = cache[key]
        else:
            m = consistency_multiplier(h.record.text, 1.0)
            if cache is not None:
                cache[key] = m
        # cache stores the weight-1 multiplier == passed/checks (or 1.0);
        # rescale to the requested weight. Negative similarities are left
        # alone — shrinking a negative score toward 0 would RAISE it.
        f = float(strictify(m, weight)) if strict else float(smooth(m, weight))
        rescored.append((h.score * f if h.score > 0 else h.score, h))
    rescored.sort(key=lambda t: -t[0])
    out = []
    for rank, (s, h) in enumerate(rescored[:top_k]):
        h.score = s
        h.rank = rank
        out.append(h)
    return out
