"""Synthetic (query, document) pair generator for training the in-domain
semantic encoder.

A copy of ``ragfin_tpu/models/pairgen.py`` (host-only numpy): the same
``np.random.default_rng(seed)`` gives the same strings in both packages.

The zero-egress image ships no pretrained sentence-encoder weights (the
reference's ``SentenceTransformer('all-MiniLM-L6-v2')``,
``chunking_storing (1).py:8``, cannot be downloaded), so the semantic
encoder is trained FROM SCRATCH on this domain. Training data is free and
unlimited: the statement templates of :mod:`ragfin_tpu_torch.eval.distractors`
(the same four analysis formats as the reference chunker,
``chunking_storing (1).py:91-330``) generate documents over the full
bank × fiscal-period × chunk-type space, and the question templates below —
phrased through the broad banking idiom lexicon
(:mod:`ragfin_tpu_torch.models.synonyms`) — generate matching queries.

In-batch negatives carry the supervision: every batch row has a distinct
scope cell, so InfoNCE teaches the encoder to key jointly on company,
period, and metric semantics while figures (random per generation) are
uncorrelated noise the encoder learns to ignore.

Two batch modes (the FY-wide false-negative rule):

- ``scope``  — rows distinct on (bank, year, type); queries may be
  quarter-specific or FY-wide. An FY-wide query ("How did X's profit move
  over FY2024?") never sees a same-(bank, year, type) other-quarter doc as
  an in-batch negative — that doc would be a legitimate positive.
- ``quarter`` — rows distinct on the full (bank, year, quarter, type) cell;
  queries are always quarter-specific. This mode supplies the
  same-bank-same-year-different-quarter negatives that teach quarter keys.
- ``nobank``  — quarter-specific queries that NEVER name the bank (the
  dominant real style in ``qa_subset.json``: "What was the retail banking
  segment revenue in Q2 FY2024?"). Rows are distinct on (year, quarter,
  type) REGARDLESS of bank — a bank-less query legitimately matches any
  bank's chunk of its scope, so two banks sharing a (year, quarter, type)
  cell would be a false negative. Teaches the query tower to key on
  period + metric and stay bank-neutral when no bank is named.
"""

from __future__ import annotations

import numpy as np

from ..eval.distractors import _TEMPLATES, _SEGMENTS, _reword, BANKS

_YEARS = list(range(2018, 2032))
# nobank mode's scope cell is (year, quarter, chunk_type) — with the base 14
# years that is 14x4x4 = 224 distinct cells, below a 256-row batch, and
# pair_batch would spin forever looking for distinct cells. Bank-less
# batches draw from a wider year range (the doc templates accept any year;
# wider years also harden year-token discrimination).
_NOBANK_YEARS = list(range(2004, 2036))
_ORDINALS = {1: "first", 2: "second", 3: "third", 4: "fourth"}

# metric concept -> (chunk_type, phrasings). Phrasings mix canonical
# statement vocabulary with the reporting idioms of synonyms.LEXICON — the
# encoder must embed "bottom line" near "NET PROFIT".
_METRICS: dict[str, tuple[str, list[str]]] = {
    "net_profit": (
        "profitability_analysis",
        [
            "net profit",
            "bottom line",
            "net earnings",
            "profit after tax",
            "money made after taxes",
            "after-tax profit",
            "PAT",
        ],
    ),
    "operating_profit": (
        "profitability_analysis",
        ["operating profit", "pre-provision profit", "operating earnings"],
    ),
    "total_income": (
        "profitability_analysis",
        ["total income", "overall top line", "top line", "total revenue", "turnover"],
    ),
    "interest_income": (
        "profitability_analysis",
        ["interest income", "NII", "net interest income"],
    ),
    "other_income": ("profitability_analysis", ["other income", "fee income"]),
    "expenses": (
        "profitability_analysis",
        ["total expenses", "spending", "expenditure", "outgoings", "operating costs"],
    ),
    "cost_ratio": (
        "profitability_analysis",
        [
            "cost ratio",
            "cost to income ratio",
            "efficiency ratio",
            "expense-to-income relationship",
        ],
    ),
    "net_margin": (
        "profitability_analysis",
        ["net margin", "profit margin", "profitability relative to income"],
    ),
    "provisions": ("profitability_analysis", ["provisions", "provisioning"]),
    "advances": ("balance_sheet_analysis", ["advances", "loan book", "loans", "lending"]),
    "deposits": (
        "balance_sheet_analysis",
        [
            "customer deposits",
            "deposits",
            "money parked with the bank",
            "money customers parked",
        ],
    ),
    "investments": ("balance_sheet_analysis", ["investments", "investment book"]),
    "total_assets": ("balance_sheet_analysis", ["total assets", "balance sheet size"]),
    "equity": (
        "balance_sheet_analysis",
        ["total equity", "net worth", "shareholder funds", "book value"],
    ),
    "borrowings": ("balance_sheet_analysis", ["borrowings", "borrowed funds"]),
    "eps": (
        "financial_ratios",
        ["basic EPS", "earnings per share", "per-share earnings", "diluted EPS"],
    ),
    "segment_revenue": (
        "segment_analysis",
        [
            "revenue of the {seg} segment",
            "how much the {seg} business line brought in",
            "the {seg} division's turnover",
            "{seg} segment revenue",
        ],
    ),
    "segment_margin": (
        "segment_analysis",
        [
            "the {seg} segment's margin",
            "how profitable the {seg} business line was relative to revenue",
            "profitability of the {seg} division",
            "{seg} segment result",
        ],
    ),
    "segment_mix": (
        "segment_analysis",
        [
            "business segment performance",
            "how the business lines compare by revenue",
            "segment mix",
            "the split across divisions",
        ],
    ),
}

_BY_TYPE: dict[str, list[str]] = {}
for _name, (_ctype, _) in _METRICS.items():
    _BY_TYPE.setdefault(_ctype, []).append(_name)

_Q_TEMPLATES = [
    "What was {bank}'s {metric} in {period}?",
    "How much was {bank}'s {metric} for {period}?",
    "How big was {bank}'s {metric} in {period}?",
    "Tell me {bank}'s {metric} for {period}.",
    "{bank} {metric} {period}",
    "Report {bank}'s {metric} in {period}.",
    "{metric} of {bank} in {period}",
    "What amount of {metric} did {bank} report for {period}?",
    "What was the exact figure of {bank}'s {metric} in {period}?",
    "How did {bank}'s {metric} perform in {period}?",
    "What rate of growth did {bank}'s {metric} achieve in {period}?",
    "In absolute terms, how much {metric} did {bank} make in {period}?",
    # Real-question YoY idiom (every chunk carries its YoY growth figure).
    "What was the YoY growth in {bank}'s {metric} in {period}?",
    "What was the year over year growth rate of {bank}'s {metric} in {period}?",
    "How much did {bank}'s {metric} grow compared to a year earlier in {period}?",
    "What was the growth rate of {bank}'s {metric} in {period}?",
    # Colloquial / terse registers (round-5: users do not write template
    # English; distinct from the held-out phrasings by construction).
    "How much did {bank} end up with as {metric} in {period}?",
    "Can you give me {bank}'s {metric} number for {period}?",
    "I'm looking for {bank}'s {metric} in {period}.",
    "Need {bank}'s {metric} for {period}.",
    "{bank} {metric} {period}, quick check",
    "Any idea what {bank}'s {metric} was in {period}?",
]

# Bank-less forms for ``nobank`` mode — the dominant qa_subset style.
_Q_NOBANK_TEMPLATES = [
    "What was the {metric} in {period}?",
    "How much was the {metric} for {period}?",
    "What was the {metric} reported in {period}?",
    "{metric} in {period}",
    "Tell me the {metric} for {period}.",
    "What was the growth rate of {metric} in {period}?",
    "How did the {metric} perform in {period}?",
    "What was the YoY growth in {metric} in {period}?",
    "How big was the {metric} in {period}?",
    "Give me the {metric} figure for {period}.",
    "Need the {metric} for {period}.",
    "{metric}, {period}?",
    "{metric} {period}",
]

# Chunk-type-specific question shapes: these mention a concept tied to one
# statement type (deposits, segments, per-share earnings) and must only
# ever pair with that type's document — a generic draw could otherwise
# teach "money parked" ≈ a ratios chunk.
_Q_EXTRAS: dict[str, list[str]] = {
    "profitability_analysis": [
        "What fraction of income did {bank}'s {metric} make up in {period}?",
        "How profitable was {bank} relative to its income in {period}?",
    ],
    "balance_sheet_analysis": [
        "How much had customers parked with {bank} as of {period}?",
        "How large was {bank}'s balance sheet in {period}?",
    ],
    "financial_ratios": [
        "What did {bank} earn per share in {period}?",
        "How much were {bank}'s earnings per share in {period}?",
    ],
    "segment_analysis": [
        "Order {bank}'s business lines by revenue in {period}.",
        "Which segment contributed most to {bank}'s revenue in {period}?",
        "How did {bank}'s divisions compare in {period}?",
    ],
}

# Quarter-pair numerical questions (qa_subset "Numerical Extraction"
# style: "How much did X increase from Q1 to Q2 FY2024?"). Scope-mode only:
# both mentioned quarters' docs are legitimate evidence, so the in-batch
# cell must exclude every same-(bank, year, type) doc — exactly scope
# mode's distinctness rule.
_PAIR_TEMPLATES = [
    "How much did {bank}'s {metric} increase from Q{qa} to Q{qb} FY{year}?",
    "What was the absolute change in {bank}'s {metric} from Q{qa} to Q{qb} FY{year}?",
    "What was the percentage growth in {bank}'s {metric} from Q{qa} to Q{qb} FY{year}?",
    "How did {bank}'s {metric} change between Q{qa} and Q{qb} of FY{year}?",
    "Compare {bank}'s {metric} in Q{qa} FY{year} with Q{qb} FY{year}.",
    "How much did {bank}'s {metric} move from Q{qa} FY{year} to Q{qb} FY{year}?",
]

_TREND_TEMPLATES = [
    "How did {bank}'s {metric} change across FY{year}?",
    "Describe how {bank}'s {metric} moved over FY{year}'s four quarters.",
    "What was the trend in {bank}'s {metric} during FY{year}?",
    "How did {bank}'s {metric} develop across FY{year}?",
    "When during FY{year} was {bank}'s {metric} highest?",
    "Which quarter of FY{year} had the best {metric} for {bank}?",
    "How did {bank}'s {metric} evolve from Q1 to Q4 of FY{year}?",
    "How did {bank}'s {metric} grow between the first and fourth quarters of FY{year}?",
    "What was the average {metric} of {bank} across all quarters of FY{year}?",
    "Which quarter showed the most improvement in {bank}'s {metric} during FY{year}?",
    "When was {bank}'s {metric} at its peak throughout FY{year}?",
    "In which quarter of FY{year} was {bank}'s {metric} smallest?",
    "Compare {bank}'s {metric} between all quarters of FY{year}.",
    "How much did {bank}'s {metric} expand from Q1 FY{year} to Q4 FY{year}?",
    "What was the absolute difference in {bank}'s {metric} from Q2 FY{year} to Q3 FY{year}?",
    "Rank the quarters of FY{year} by {bank}'s {metric}, highest to lowest.",
]

_TREND_EXTRAS: dict[str, list[str]] = {
    "segment_analysis": [
        "Which of {bank}'s segments were most volatile in FY{year}?",
        "What percentage contribution did each segment make to {bank}'s totals in FY{year}?",
        "Which business line's profitability bounced around the most for {bank} during FY{year}?",
    ],
    "profitability_analysis": [
        "How did {bank}'s expense-to-income relationship develop across FY{year}?",
        "Which quarter of FY{year} was most lucrative for {bank} relative to income?",
    ],
}

# Function/comparison words the vocabulary must carry as single tokens even
# when no template instance in a given sample happens to use them — an OOV
# question word otherwise decomposes into character pieces that dilute mean
# pooling with noise.
VOCAB_SEED_WORDS = (
    "from all most and showed were rate amount grow between evolve year "
    "throughout average its rates vs absolute percentage difference "
    "quarterly achieve peak contributed terms improvement contribution "
    "ranking volatile lowest perform figure margins totals make as "
    "fraction expand corporate month stretch lucrative order each bounced "
    "around smallest what was the in for of how much did report tell me "
    "which when where why compare versus against highest best worst "
    "biggest largest show give state calculate compute value number "
    "moved change trend during across over quarters fiscal please "
    # round-5: calendar months (fiscal mapping idioms), chat filler, and
    # sell-side shorthand must be single tokens, not char soup.
    "january february march april may june july august september october "
    "november december pls thanks asap hey btw umm quick idea looking "
    "need check ended ending closed qtr pat nii opex seg rev dep adv tot "
    "inc prov h1 h2 half parked earn earned bottom line"
).split()


# Fiscal-quarter end months (Indian convention, the reference chunker's
# period->month mapping, chunking_storing (1).py:77-89): Q1 FY(y) ends
# June y-1 ... Q4 FY(y) ends March y.
_Q_END_MONTH = {1: "june", 2: "september", 3: "december", 4: "march"}


def _period_phrase(q: int, year: int, r) -> str:
    cal_year = year if q == 4 else year - 1
    month = _Q_END_MONTH[q]
    short = str(year)[2:]
    forms = [
        f"Q{q} FY{year}",
        f"Q{q}_FY{year}",
        f"the {_ORDINALS[q]} quarter of FY{year}",
        f"the {_ORDINALS[q]} quarter of fiscal {year}",
        f"{_ORDINALS[q]} quarter FY{year}",
        f"the three months of Q{q} FY{year}",
        # Sell-side compact forms and calendar-month idioms (round-5: real
        # users write "Q1FY24" and "the June 2023 quarter"; the query tower
        # must key them to the same scope as "Q1 FY2024").
        f"Q{q}FY{short}",
        f"{q}QFY{short}",
        f"Q{q}FY{year}",
        f"the quarter ended {month} {cal_year}",
        f"the {month} {cal_year} quarter",
        f"the quarter ending {month} {cal_year}",
    ]
    return forms[int(r.integers(0, len(forms)))]


# Query-side robustness augmentation (round-5): word dropout, character
# typos, and chat filler teach the tower that a noisy rendition of a
# question shares its scope — and keep training accuracy off the 1.0
# saturation plateau that let v3 memorize its template distribution.
_FILLERS_PRE = ["hey", "quick question:", "pls tell me", "btw", "so", "umm"]
_FILLERS_POST = ["pls", "please", "thanks", "if you can", "asap", "?"]
_LETTERS = "abcdefghijklmnopqrstuvwxyz"


def _typo_word(w: str, r) -> str:
    if len(w) < 4:
        return w
    i = int(r.integers(1, len(w) - 1))
    op = int(r.integers(0, 4))
    if op == 0:  # adjacent swap
        return w[: i] + w[i + 1] + w[i] + w[i + 2:]
    if op == 1:  # drop
        return w[:i] + w[i + 1:]
    if op == 2:  # double
        return w[: i + 1] + w[i] + w[i + 1:]
    return w[:i] + _LETTERS[int(r.integers(0, 26))] + w[i + 1:]  # substitute


def _is_scope_token(w: str) -> bool:
    """Period/quarter/year tokens must never be corrupted — a typo there
    CHANGES the scope (the label), not just the surface form."""
    wl = w.lower().strip(".,?!:;()")
    return any(c.isdigit() for c in wl) or wl in ("fy", "q", "fiscal", "quarter")


def augment_query(query: str, r, p_dropout: float = 0.08, p_typo: float = 0.10) -> str:
    words = query.split()
    out = []
    for w in words:
        if _is_scope_token(w):
            out.append(w)
            continue
        u = r.uniform()
        if u < p_dropout and len(words) > 3:
            continue
        if u < p_dropout + p_typo:
            out.append(_typo_word(w, r))
            continue
        out.append(w)
    if not out:
        out = words
    if r.uniform() < 0.12:
        out.insert(0, _FILLERS_PRE[int(r.integers(0, len(_FILLERS_PRE)))])
    if r.uniform() < 0.12:
        out.append(_FILLERS_POST[int(r.integers(0, len(_FILLERS_POST)))])
    return " ".join(out)


def _bank_phrase(bank: str, r) -> str:
    short = bank.replace(" Limited", "")
    forms = [bank, short, short.split()[0] if short.split()[0].isupper() else short]
    return forms[int(r.integers(0, len(forms)))]


def _metric_phrase(metric: str, r) -> str:
    _, phrasings = _METRICS[metric]
    p = phrasings[int(r.integers(0, len(phrasings)))]
    if "{seg}" in p:
        p = p.format(seg=_SEGMENTS[int(r.integers(0, len(_SEGMENTS)))].lower())
    return p


_TEMPLATE_FNS = {ctype: fn for ctype, fn, _ in _TEMPLATES}
_TYPE_ORDER = sorted(_BY_TYPE)

# Round-5 residual, v5 prep: METRIC-ONLY fragment queries ("net profit
# growth", "cost to income ratio") score near-noise on the v4 query tower —
# every v4 training query is question-formed and carries a scope token, so
# the tower leans on bank/period tokens (encoder_diag fragment arm; template
# wrapping at query time was measured ineffective). Fragment positives pair
# a BARE metric phrase with a doc of that metric's chunk type at a random
# scope. In a types hard-block the in-batch negatives are the SAME scope's
# other statement types — exactly clean. In quarter/nobank batches a
# same-metric doc at another scope can collide as a false negative, but the
# sampled scope is uniform over training, so the scope component of that
# gradient cancels in expectation while the metric-discrimination signal
# stays consistent.
_FRAGMENT_FRAC = 0.12


def _fragment_query(metric: str, r) -> str:
    frag = _metric_phrase(metric, r)
    u = r.uniform()
    if u < 0.15:
        frag = "the " + frag
    elif u < 0.30 and not frag.endswith("growth"):
        frag = frag + " growth"
    return frag


def fragment_queries() -> list[tuple[str, str]]:
    """Deterministic scope-token-less fragment diagnostics: ``(query,
    chunk_type)`` pairs covering every metric concept (first two surface
    phrasings each). Used by scripts/encoder_diag.py's fragment arm, where
    gold = every chunk of the fragment's statement type."""
    out = []
    for metric, (ctype, phrasings) in _METRICS.items():
        for p in phrasings[:2]:
            if "{seg}" in p:
                p = p.format(seg=_SEGMENTS[0].lower())
            out.append((p, ctype))
    return out


def _quarter_row(r, bank, year, q, metric, nobank=False, fragment=False):
    """One quarter-specific (query, doc) pair for an exact scope."""
    ctype, _ = _METRICS[metric]
    doc = _TEMPLATE_FNS[ctype](bank, f"Q{q}_FY{year}", r)
    if r.uniform() < 0.5:
        doc = _reword(doc, r)
    if fragment:
        return _fragment_query(metric, r), doc
    if nobank:
        tmpl = _Q_NOBANK_TEMPLATES[int(r.integers(0, len(_Q_NOBANK_TEMPLATES)))]
        query = tmpl.format(
            metric=_metric_phrase(metric, r), period=_period_phrase(q, year, r)
        )
    else:
        extras = _Q_EXTRAS.get(ctype, [])
        pool = extras if (extras and r.uniform() < 0.2) else _Q_TEMPLATES
        tmpl = pool[int(r.integers(0, len(pool)))]
        query = tmpl.format(
            bank=_bank_phrase(bank, r),
            metric=_metric_phrase(metric, r),
            period=_period_phrase(q, year, r),
        )
    return query, doc


def hard_block(r) -> list[tuple[str, str, tuple]]:
    """4 rows differing ONLY in chunk type (same bank/year/quarter) or ONLY
    in quarter (same bank/year/type) — dense in-batch hard negatives.

    Random-cell batches almost never place a row's same-scope siblings in
    the same batch (the quarter-mode cell space is ~8k), so InfoNCE
    saturates (~1e-4 loss) without ever sharpening the two distinctions the
    16-chunk diagnostic shows failing: segment questions landing on the
    co-scoped profitability chunk, and trend questions landing on the
    co-scoped ratios chunk (scripts/encoder_diag.py). A "types" block makes
    the other three types of the SAME scope the negatives; a "quarters"
    block does the same for the other three quarters.
    """
    bank = BANKS[int(r.integers(0, len(BANKS)))]
    year = _YEARS[int(r.integers(0, len(_YEARS)))]
    rows = []
    if r.uniform() < 0.5:  # types block
        q = int(r.integers(1, 5))
        for ctype in _TYPE_ORDER:
            names = _BY_TYPE[ctype]
            metric = names[int(r.integers(0, len(names)))]
            # Fragments are exactly clean here: the block's negatives are
            # the same scope's OTHER types, so a scope-less metric query
            # still has a unique in-block gold. (Never in quarters blocks —
            # four same-metric docs would all be valid for a bare fragment.)
            frag = r.uniform() < 2 * _FRAGMENT_FRAC
            query, doc = _quarter_row(r, bank, year, q, metric, fragment=frag)
            rows.append((query, doc, (bank, year, q, ctype)))
    else:  # quarters block
        ctype = _TYPE_ORDER[int(r.integers(0, len(_TYPE_ORDER)))]
        names = _BY_TYPE[ctype]
        metric = names[int(r.integers(0, len(names)))]
        for q in (1, 2, 3, 4):
            query, doc = _quarter_row(r, bank, year, q, metric)
            rows.append((query, doc, (bank, year, q, ctype)))
    return rows


def make_pair(r, mode: str = "quarter") -> tuple[str, str, tuple]:
    """One (query, document, scope_cell) sample.

    ``mode='quarter'``: quarter-specific query; cell = (bank, year, q, type).
    ``mode='scope'``: FY-wide trend or quarter-pair query;
                      cell = (bank, year, type).
    ``mode='nobank'``: bank-less quarter query; cell = (year, q, type).
    """
    bank = BANKS[int(r.integers(0, len(BANKS)))]
    years = _NOBANK_YEARS if mode == "nobank" else _YEARS
    year = years[int(r.integers(0, len(years)))]
    q = int(r.integers(1, 5))
    metric = list(_METRICS)[int(r.integers(0, len(_METRICS)))]
    ctype, _ = _METRICS[metric]
    period = f"Q{q}_FY{year}"
    doc = _TEMPLATE_FNS[ctype](bank, period, r)
    if r.uniform() < 0.5:
        # Wording-invariance augmentation: the doc side the encoder sees is
        # a reworded variant (synonym swaps, dropped/injected lines,
        # perturbed figures) of a chunk with the same scope — same machinery
        # as the eval's reword tamper tier.
        doc = _reword(doc, r)
    if mode == "quarter":
        if r.uniform() < _FRAGMENT_FRAC:
            query = _fragment_query(metric, r)
        else:
            extras = _Q_EXTRAS.get(ctype, [])
            pool = extras if (extras and r.uniform() < 0.2) else _Q_TEMPLATES
            tmpl = pool[int(r.integers(0, len(pool)))]
            query = tmpl.format(
                bank=_bank_phrase(bank, r),
                metric=_metric_phrase(metric, r),
                period=_period_phrase(q, year, r),
            )
        cell = (bank, year, q, ctype)
    elif mode == "nobank":
        if r.uniform() < _FRAGMENT_FRAC:
            query = _fragment_query(metric, r)
        else:
            tmpl = _Q_NOBANK_TEMPLATES[
                int(r.integers(0, len(_Q_NOBANK_TEMPLATES)))
            ]
            query = tmpl.format(
                metric=_metric_phrase(metric, r), period=_period_phrase(q, year, r)
            )
        cell = (year, q, ctype)
    else:
        if r.uniform() < 0.3:
            # Quarter-pair numerical question; the doc is one of the two
            # mentioned quarters (both are legitimate evidence).
            qa_, qb = sorted(r.choice(4, size=2, replace=False) + 1)
            q_doc = int(qa_ if r.uniform() < 0.5 else qb)
            doc = _TEMPLATE_FNS[ctype](bank, f"Q{q_doc}_FY{year}", r)
            if r.uniform() < 0.5:
                doc = _reword(doc, r)
            tmpl = _PAIR_TEMPLATES[int(r.integers(0, len(_PAIR_TEMPLATES)))]
            query = tmpl.format(
                bank=_bank_phrase(bank, r),
                metric=_metric_phrase(metric, r),
                qa=int(qa_), qb=int(qb), year=year,
            )
        else:
            extras = _TREND_EXTRAS.get(ctype, [])
            pool = extras if (extras and r.uniform() < 0.2) else _TREND_TEMPLATES
            tmpl = pool[int(r.integers(0, len(pool)))]
            query = tmpl.format(
                bank=_bank_phrase(bank, r), metric=_metric_phrase(metric, r), year=year
            )
        cell = (bank, year, ctype)
    return query, doc, cell


def pair_batch(
    r,
    batch_size: int,
    quarter_frac: float = 0.30,
    nobank_frac: float = 0.15,
    hard_frac: float = 0.25,
    augment_frac: float = 0.45,
) -> tuple[list[str], list[str]]:
    """One batch of pairs with all-distinct scope cells (InfoNCE-safe).

    A single batch is homogeneous in mode: mixing an FY-wide row with a
    quarter-specific row of the same (bank, year, type) would make the
    quarter row's doc a false negative for the FY row; mixing a bank-less
    row with ANY same-(year, quarter, type) row of another bank likewise.
    ``hard`` batches are built from :func:`hard_block` 4-row blocks
    (quarter-specific banked queries — the same cell semantics as
    ``quarter`` mode, so distinctness on the full cell keeps them safe).
    """
    u = r.uniform()
    if u < quarter_frac:
        mode = "quarter"
    elif u < quarter_frac + nobank_frac:
        mode = "nobank"
    elif u < quarter_frac + nobank_frac + hard_frac:
        mode = "hard"
    else:
        mode = "scope"
    if mode == "hard":
        queries, docs, seen = [], [], set()
        attempts = 0
        while len(queries) < batch_size:
            attempts += 1
            if attempts > 60 * batch_size:
                raise ValueError(
                    f"batch_size={batch_size} too large for distinct hard-block cells"
                )
            block = hard_block(r)
            if any(cell in seen for _, _, cell in block):
                continue
            for query, doc, cell in block[: batch_size - len(queries)]:
                seen.add(cell)
                if r.uniform() < augment_frac:
                    query = augment_query(query, r)
                queries.append(query)
                docs.append(doc)
        return queries, docs
    queries, docs, seen = [], [], set()
    attempts = 0
    while len(queries) < batch_size:
        attempts += 1
        if attempts > 60 * batch_size:
            # scope mode has |banks|x|years|x|types| = ~448 distinct cells;
            # a batch_size near/above that would spin forever here.
            raise ValueError(
                f"batch_size={batch_size} too large for distinct {mode}-mode scope cells"
            )
        query, doc, cell = make_pair(r, mode)
        if cell in seen:
            continue
        seen.add(cell)
        if r.uniform() < augment_frac:
            query = augment_query(query, r)
        queries.append(query)
        docs.append(doc)
    return queries, docs


def corpus_sample(n: int, seed: int = 0) -> list[str]:
    """Deterministic text sample (docs + queries) for vocabulary building.

    Includes the idiom lexicon (both sides) and the function-word seed list
    repeated past any sane ``min_freq`` so every query-side word the domain
    uses is a single vocabulary token."""
    from .synonyms import LEXICON

    r = np.random.default_rng(seed)
    texts: list[str] = []
    for _ in range(n):
        mode = "quarter" if r.uniform() < 0.7 else "scope"
        query, doc, _ = make_pair(r, mode)
        texts.append(query)
        texts.append(doc)
    lexicon_text = " ".join(list(LEXICON.keys()) + list(LEXICON.values()))
    seed_text = " ".join(VOCAB_SEED_WORDS)
    texts.extend([lexicon_text, seed_text] * 5)
    return texts
