"""The comparison that decides ``correct``.

The window's checked calls are judged against the plain reference in
``benchmark/reference``, which works the corpus, the weights and each
question's scope out again from the seed and the configuration:

- ``qvec_cos_gap``: the encoder stage. Largest ``1 - cos`` between the query
  vector the program's embedder returned for a question inside the timed
  call and the reference's float32 forward of the same text (the forward of
  the configuration's architecture, ``reference/models/<model_type>.py``).
- ``score_err``: largest gap between a returned hit's score and the float64
  cosine of the program's own query vector with that hit's row.
- ``order_gap``: largest gap, rank by rank, between the float64 scores of
  the returned rows and of the rows the reference's semantics give for the
  program's query vector (tiers, masks, merge, int8 shortlist and repair).
  Two near-tied rows in swapped order read as their tiny difference.
- ``hit_gap``: the whole path judged by the reference alone. Largest gap,
  rank by rank, by which the float64 score of a returned row, under the
  reference's own query vector, lies below the score of the row the
  reference's semantics put at that rank for that vector, as a served
  token's logit is judged against the reference's best.
- ``scope_violations``: hits whose record is not the row's (company, period,
  type), or whose row lies outside every tier the question's plan consumed.
- ``missing``: checked questions with fewer than ``top_k`` hits or no answer.

``score_err`` and ``order_gap`` follow the index stage from the program's
own query vectors (the reference re-runs the search from them), so that they
can hold it to float64 ranks; the encoder stage is judged by itself, and
``hit_gap`` judges both together from the reference's own vectors. ``control=True`` puts the reference in the program's place one
precision step down (float8 encoder, TF32 float32 scores, int4 shortlist)
and judges that instead.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..reference import filters as ref_filters
from ..reference import search as ref_search
from ..reference.tokenizer import Tokenizer
from . import corpus as corpus_lib
from . import spec
from . import weights as weights_lib

REPAIR_MIN = 16  # the int8 tiers fetch max(k + 6, 16) before the exact repair
SCOPED_FETCH = 64  # FilteredSearch asks each tier for max(top_k, 64)


@dataclass
class CheckedCall:
    questions: list
    result: list | None = None  # per question, a list of (row id, score, record); None: no answer
    captured: list = field(default_factory=list)  # (texts, vectors) from the encoder


def checked_calls(calls: list, pools: list, keys: set) -> list[CheckedCall]:
    """The window's calls that the check compares, (caller, call index) in
    ``keys``; one never sent inside the window is not due and is left out.
    Each call's hits are taken over and dropped from the call."""
    by_key = {(c.caller, c.index): c for c in calls}
    out = []
    for key in sorted(keys):
        call = by_key.get(key)
        if call is None:
            continue
        pool = pools[key[0]]
        result = None if call.result is None else [hits_of(r) for r in call.result]
        out.append(CheckedCall(pool[key[1] % len(pool)], result, call.stats.captured or []))
        call.result = None
    return out


def tokenizer_for(config: dict, root: str) -> Tokenizer:
    dep = config["deployment"]
    tok = dep["tokenizer"]
    vocab = os.path.join(root, dep["checkpoint"], "vocab.txt") if tok.get("vocab") else None
    return Tokenizer(vocab_path=vocab, vocab_size=config["vocab_size"], max_len=tok["max_len"],
                     collapse_numbers=tok.get("collapse_numbers", False))


def encoder_weights(config: dict, root: str, seed: int, device) -> dict:
    dep = config["deployment"]
    if dep.get("checkpoint"):
        return weights_lib.checkpoint(root, dep["checkpoint"])
    return weights_lib.seeded(config, seed, device)


def _row(chunk_id: str) -> int:
    return int(chunk_id[1:])


class Reference:
    """The reference's view of one run: corpus, scopes, tokenizer, weights."""

    def __init__(self, config: dict, mix: dict, layout: corpus_lib.Layout, seed: int, root: str, device):
        torch.backends.cuda.matmul.allow_tf32 = False
        self.config, self.mix, self.layout, self.device = config, mix, layout, device
        x = corpus_lib.make_vectors(layout, seed, device)
        self.unit = ref_search.unit_rows(x)
        del x
        self.codes = layout.scope_codes(device)
        self.tokenizer = tokenizer_for(config, root)
        self.arch = spec.arch(config)
        self.weights = encoder_weights(config, root, seed, device)
        self.dtype = config["deployment"]["settings"]["index_dtype"]
        self.k = mix["top_k"]
        self.by_company = {b: set(layout.periods) for b in layout.banks}

    # --- encoder -----------------------------------------------------------
    def encode(self, texts: list[str], lower: str | None = None) -> torch.Tensor:
        ids = [self.tokenizer.encode(t) for t in texts]
        return self.arch.encode(self.weights, self.config, ids, self.device, lower=lower)

    # --- scopes ------------------------------------------------------------
    def plan(self, question: str) -> list[list[dict]]:
        return ref_filters.tier_groups(question, self.layout.periods, sorted(self.layout.banks),
                                       self.by_company)

    def rows(self, flt: dict) -> torch.Tensor:
        bank, period, ctype = self.codes
        keep = torch.ones_like(bank, dtype=torch.bool)
        if flt.get("company") is not None:
            keep &= bank == self.layout.banks.index(flt["company"])
        if flt.get("periods"):
            want = torch.tensor([self.layout.periods.index(p) for p in flt["periods"]], device=self.device)
            keep &= torch.isin(period, want)
        if flt.get("chunk_type") is not None:
            keep &= ctype == self.layout.chunk_types.index(flt["chunk_type"])
        return keep.nonzero().flatten()

    def in_scope(self, row: int, flt: dict) -> bool:
        bank, period, ctype = self.layout.scope(row % self.layout.scopes)
        return ((flt.get("company") is None or flt["company"] == bank)
                and (not flt.get("periods") or period in flt["periods"])
                and (flt.get("chunk_type") is None or flt["chunk_type"] == ctype))

    # --- search ------------------------------------------------------------
    def _tier(self, q: torch.Tensor, rows: torch.Tensor, fetch: int, lower: str | None):
        if self.dtype == "int8":
            width = max(fetch + 6, REPAIR_MIN)
            s, i = ref_search.int8_topk(self.unit, q, rows, fetch, width,
                                        lower="int4" if lower else None)
        else:
            s, i = ref_search.exact_topk(self.unit, q, rows, fetch, lower="tf32" if lower else None)
        return s[:, : self.k], i[:, : self.k]

    def answers(self, entry: str, questions: list[str], q: torch.Tensor, lower: str | None = None):
        """Per question: (rows, scores, tiers consumed) of the answer the
        entry's semantics give for query vectors ``q``."""
        if entry == "index.search_texts":
            s, i = self._tier(q, torch.arange(self.layout.rows, device=self.device), self.k, lower)
            return [(i[j].tolist(), s[j].tolist(), [{}]) for j in range(len(questions))]
        if entry != "rag.search_batch":
            raise ValueError(f"unknown entry {entry!r}")
        plans = [self.plan(t) for t in questions]
        hits: list[list] = [[] for _ in questions]
        seen: list[set] = [set() for _ in questions]
        used: list[list] = [[] for _ in questions]
        depth = max(len(p) for p in plans)
        for g in range(depth):
            # Tiers of this group over the questions that still lack hits.
            need: dict = {}
            for j, plan in enumerate(plans):
                if g < len(plan) and len(hits[j]) < self.k:
                    for t, flt in enumerate(plan[g]):
                        need.setdefault(repr(flt), (flt, []))[1].append((j, t))
            results: dict = {}
            for key, (flt, members) in need.items():
                js = sorted({j for j, _ in members})
                s, i = self._tier(q[js], self.rows(flt), SCOPED_FETCH, lower)
                for row, j in enumerate(js):
                    results[(j, key)] = (i[row].tolist(), s[row].tolist())
            for j, plan in enumerate(plans):
                if g >= len(plan) or len(hits[j]) >= self.k:
                    continue
                for flt in plan[g]:
                    used[j].append(flt)
                    rows, scores = results[(j, repr(flt))]
                    for r, sc in zip(rows, scores):
                        if r not in seen[j] and math.isfinite(sc):
                            seen[j].add(r)
                            hits[j].append((r, sc))
        return [([r for r, _ in h[: self.k]], [s for _, s in h[: self.k]], u)
                for h, u in zip(hits, used)]


def judge(ref: Reference, entry: str, calls: list[CheckedCall], control: bool = False) -> dict:
    """The numbers compared, over every question of the checked calls."""
    questions, q_prog, results = [], [], []
    missing = 0
    for call in calls:
        vectors = {}
        for texts, vecs in call.captured:
            for t, v in zip(texts, vecs):
                vectors.setdefault(t, v)
        for j, question in enumerate(call.questions):
            got = None if call.result is None or j >= len(call.result) else call.result[j]
            if control:
                questions.append(question)
                continue
            if got is None or question not in vectors:
                missing += 1
                continue
            questions.append(question)
            q_prog.append(vectors[question])
            results.append(got)
    out = {"qvec_cos_gap": 0.0, "score_err": 0.0, "order_gap": 0.0, "hit_gap": 0.0,
           "scope_violations": 0, "missing": missing, "questions": len(questions)}
    if not questions:
        return out
    q_ref = ref.encode(questions)
    if control:
        q_prog = ref.encode(questions, lower="fp8")
        lowered = ref.answers(entry, questions, q_prog, lower="low")
        results = [[(r, s, None) for r, s in zip(rows, scores)] for rows, scores, _ in lowered]
    else:
        q_prog = torch.as_tensor(np.stack(q_prog), device=ref.device)
    cos = torch.nn.functional.cosine_similarity(q_prog.double(), q_ref.double(), dim=1)
    out["qvec_cos_gap"] = float((1.0 - cos).max())
    expect = ref.answers(entry, questions, q_prog)
    own = ref.answers(entry, questions, q_ref)
    for j, (got, (rows, scores, used), (_, best, _)) in enumerate(zip(results, expect, own)):
        if len(got) < ref.k:
            out["missing"] += 1
        got_rows = [r for r, _, _ in got]
        for r, _, record in got:
            if record is not None:
                bank, period, ctype = ref.layout.scope(r % ref.layout.scopes)
                if (record.id, record.company, record.period, record.chunk_type) != (
                        corpus_lib.chunk_id(r), bank, period, ctype):
                    out["scope_violations"] += 1
                    continue
            if not 0 <= r < ref.layout.rows or not any(ref.in_scope(r, f) for f in used):
                out["scope_violations"] += 1
        valid = [r if 0 <= r < ref.layout.rows else 0 for r in got_rows]
        if not valid:
            continue
        ids = torch.tensor([valid], device=ref.device)
        exact = ref_search.exact_of(ref.unit, q_prog[j : j + 1], ids)[0].tolist()
        out["score_err"] = max(out["score_err"], max(abs(s - e) for (_, s, _), e in zip(got, exact)))
        want = ref_search.exact_of(ref.unit, q_prog[j : j + 1], torch.tensor([rows], device=ref.device))[0].tolist()
        out["order_gap"] = max(out["order_gap"], max(abs(a - b) for a, b in zip(exact, want)))
        seen = ref_search.exact_of(ref.unit, q_ref[j : j + 1], ids)[0].tolist()
        out["hit_gap"] = max(out["hit_gap"], max(b - g for b, g in zip(best, seen)))
    return out


def hits_of(result) -> list:
    """The program's answer to one question as (row, score, record) triples."""
    return [(_row(h.record.id), float(h.score), h.record) for h in result]
