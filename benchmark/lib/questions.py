"""The one question generator every traffic mix is read by.

A mix file lists its question texts (``questions``), copied verbatim from the
source it names; a text listed twice is sent twice as often. Calls are cut
from the list read round and round: call ``c`` of a cycle holds the slots
``c * per_call`` to ``(c + 1) * per_call - 1`` of the repeated list, and the
cycle closes when a call ends where the list does. Every seed therefore
sends the same calls, each holding the same texts; the seed orders the
questions inside each call and picks where each caller starts in the cycle.
"""

from __future__ import annotations

import math

import numpy as np


def cycle_calls(mix: dict) -> list[list[str]]:
    """The calls of one cycle, as lists of texts (seed-free)."""
    texts = mix["questions"]
    per_call = mix["questions_per_call"]
    n_calls = len(texts) // math.gcd(len(texts), per_call)
    return [[texts[s % len(texts)] for s in range(c * per_call, (c + 1) * per_call)]
            for c in range(n_calls)]


def caller_calls(mix: dict, seed: int, caller: int, n_calls: int) -> list[list[str]]:
    """The first ``n_calls`` calls of one caller: lists of question texts."""
    rng = np.random.default_rng([int(seed), caller])
    cycle = cycle_calls(mix)
    start = int(rng.integers(len(cycle)))
    out = []
    for i in range(n_calls):
        members = cycle[(start + i) % len(cycle)]
        out.append([members[j] for j in rng.permutation(len(members))])
    return out
