"""The filings corpus, made from the seed: records on the host, vectors on the card.

Rows are spread over scopes (bank, period, chunk type) round-robin, row ``r``
in scope ``r % scopes``, so every seed gives every scope the same number of
rows. A scope's vectors are its centre plus noise of norm ``spread``, so each
scope is a band of near-duplicates, as a bank's filings of one quarter are.
The seed draws the centres and the noise on the card in two calls; the
records do not depend on it. The reference draws the same vectors again from
the same seed after the window.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Layout:
    rows: int
    dim: int
    banks: tuple
    periods: tuple
    chunk_types: tuple
    spread: float

    @classmethod
    def from_config(cls, corpus: dict, rows: int | None = None) -> "Layout":
        years = range(corpus["fiscal_years"][0], corpus["fiscal_years"][1] + 1)
        periods = tuple(f"Q{q}_FY{y}" for y in years for q in corpus["quarters"])
        return cls(
            rows=int(rows if rows is not None else corpus["rows"]),
            dim=int(corpus["dim"]),
            banks=tuple(corpus["banks"]),
            periods=periods,
            chunk_types=tuple(corpus["chunk_types"]),
            spread=float(corpus["spread"]),
        )

    @property
    def scopes(self) -> int:
        return len(self.banks) * len(self.periods) * len(self.chunk_types)

    def scope(self, s: int) -> tuple[str, str, str]:
        """(bank, period, chunk type) of scope ``s``."""
        per_bank = len(self.periods) * len(self.chunk_types)
        b, rest = divmod(s, per_bank)
        p, t = divmod(rest, len(self.chunk_types))
        return self.banks[b], self.periods[p], self.chunk_types[t]

    def scope_codes(self, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Per row: (bank, period, chunk type) index, int64 tensors."""
        s = torch.arange(self.rows, device=device) % self.scopes
        per_bank = len(self.periods) * len(self.chunk_types)
        return s // per_bank, (s % per_bank) // len(self.chunk_types), s % len(self.chunk_types)


def chunk_id(row: int) -> str:
    return f"c{row}"


def make_records(layout: Layout, record_cls) -> list:
    """``layout.rows`` records of ``record_cls`` (fields set directly, no
    per-row validation: the values are well formed by construction). Texts
    are one short line per scope, shared by its rows."""
    scopes = [layout.scope(s) for s in range(layout.scopes)]
    texts = [f"{b} Limited {p} {t.replace('_', ' ')}" for b, p, t in scopes]
    new = object.__new__
    n_scopes = layout.scopes
    out = []
    append = out.append
    for row in range(layout.rows):
        s = row % n_scopes
        bank, period, ctype = scopes[s]
        rec = new(record_cls)
        rec.__dict__ = {
            "id": f"c{row}", "text": texts[s], "period": period, "chunk_type": ctype,
            "statement_type": "consolidated", "primary_value": 0.0, "company": bank,
        }
        append(rec)
    return out


def make_vectors(layout: Layout, seed: int, device) -> torch.Tensor:
    """[rows, dim] float32 on ``device``: scope centre (unit) + noise of
    norm about ``spread``; not normalised (the index normalises)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    centres = torch.randn((layout.scopes, layout.dim), generator=gen, device=device)
    centres /= centres.norm(dim=1, keepdim=True)
    x = torch.randn((layout.rows, layout.dim), generator=gen, device=device)
    x *= layout.spread / math.sqrt(layout.dim)
    full = layout.rows // layout.scopes * layout.scopes
    x[:full].view(-1, layout.scopes, layout.dim).add_(centres)
    x[full:].add_(centres[: layout.rows - full])
    return x
