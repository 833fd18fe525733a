"""A numpy model of the first-k kernel's protocol (``csrc/first_k.cu``).

The CUDA kernel runs only on the card, so its protocol is modelled here step
by step and held to ``masked_first_k_plain``: blocks start in a random order
and take spans from an atomic ticket in the order they start, count their
span in 16-byte rounds, publish an aggregate in a status word tagged with
the call's tag, look back over earlier spans a window of lanes at a time
(spinning on a word not yet published), publish an inclusive prefix, write
their hits at prefix + rank, pad the tail, and the last block to finish
resets the ticket and advances the call count (clearing the status words
when the tag wraps). Each block is a generator that yields wherever the
card could run another block in between: after the ticket, after each
status word it reads or writes, after each round. A seeded scheduler keeps a
given number of blocks resident and advances a random one at each step, so
block start orders and interleavings are random; a block spinning with
nothing else able to move is a deadlock.

The model runs at a small span (4 threads, 16 bytes each, 2 rounds: 128
bytes a span) and with windows of 32 lanes, as the kernel, and of 4, so
that a look-back crosses several windows. Several calls run back to back on
one scratch, as the wrapper's persistent scratch does. Copies of the model
with a step of the protocol taken out (the tag in the status words, the
ticket, the reset of the ticket) must fail.
"""

import numpy as np
import pytest
import torch

from ragfin_tpu_torch.index.graph_index import _INT_MAX, masked_first_k_plain

INCLUSIVE = 1 << 31
VALUE = INCLUSIVE - 1
LAST_TAG = 0xFFFFFFFF
GARBAGE = -7  # what torch.empty may hold before the kernel writes


class Deadlock(Exception):
    pass


class Scratch:
    """The kernel's scratch: header words and the per-span status words."""

    def __init__(self, n_status: int):
        self.ticket = self.finished = self.calls = 0
        self.status = [0] * n_status


class Model:
    def __init__(self, threads=4, iters=2, window=32, tags=True, ticket=True, reset=True):
        self.threads, self.iters, self.window = threads, iters, window
        self.chunk = threads * 16
        self.span = self.chunk * iters
        self.tags, self.ticket, self.reset = tags, ticket, reset

    # -- words ------------------------------------------------------------
    def word(self, tag, inclusive, value):
        # Without tags a published word still has to differ from 0.
        return (tag if self.tags else 1) << 32 | (INCLUSIVE if inclusive else 0) | value

    def ready(self, w, tag):
        return (w >> 32) == tag if self.tags else w != 0

    # -- warp 0's look-back -------------------------------------------------
    def look_back(self, sc, span, tag, k):
        total, j = 0, span - 1
        while True:
            words = []
            for lane in range(self.window):
                idx = j - lane
                if idx >= 0:
                    words.append(sc.status[idx])
                    yield
                else:
                    words.append(self.word(tag, True, 0))
            ready = [self.ready(w, tag) for w in words]
            run = ready.index(False) if False in ready else self.window
            incl = [r and bool(w & INCLUSIVE) for r, w in zip(ready, words)]
            stop = incl.index(True) if True in incl else self.window
            take = stop + 1 if stop < run else run
            total += sum(w & VALUE for w in words[:take])
            if stop < run or total >= k:
                return min(total, k)
            j -= run

    # -- one block ----------------------------------------------------------
    def block(self, sc, hit, k, n_spans, grid, ids, count, written, block_idx):
        n = len(hit)
        span = sc.ticket if self.ticket else block_idx
        sc.ticket += 1
        tag = sc.calls + 1
        yield
        base = span * self.span
        rounds = []  # per round, per thread: the hit positions of its 16 bytes
        for it in range(self.iters):
            per_thread = []
            for t in range(self.threads):
                p0 = base + it * self.chunk + t * 16
                per_thread.append([p for p in range(p0, min(p0 + 16, n)) if hit[p] != 0])
            rounds.append(per_thread)
        agg = sum(len(h) for r in rounds for h in r)
        yield
        excl = 0
        if span > 0:
            sc.status[span] = self.word(tag, False, min(agg, k))
            yield
            excl = yield from self.look_back(sc, span, tag, k)
        incl = min(excl + agg, k)
        sc.status[span] = self.word(tag, True, incl)
        yield
        if excl < k <= incl:
            count[0] = k
        elif span == n_spans - 1 and incl < k:
            count[0] = incl
        if excl < k and agg > 0:
            at = excl
            for per_thread in rounds:
                if at >= k:
                    break
                counts = [len(h) for h in per_thread]
                before = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(int)
                for t, positions in enumerate(per_thread):
                    for r, p in enumerate(positions):
                        slot = at + before[t] + r
                        if slot < k:
                            ids[slot] = p
                            written[slot] += 1
                at += sum(counts)
                yield
        if span == n_spans - 1:
            for j in range(excl + agg, k):
                ids[j] = _INT_MAX
                written[j] += 1
        # The last block of the call resets the scratch for the next one.
        last = sc.finished == grid - 1
        sc.finished += 1
        yield
        if last:
            wrap = tag == LAST_TAG
            if wrap:
                sc.status = [0] * len(sc.status)
            if self.reset:
                sc.ticket = sc.finished = 0
            sc.calls = 0 if wrap else tag

    # -- one launch ---------------------------------------------------------
    def call(self, sc, hit, k, rng, resident, patience=20_000):
        n_spans = -(-len(hit) // self.span)
        assert n_spans <= len(sc.status)
        ids, count, written = [GARBAGE] * k, [GARBAGE], [0] * k
        # The card starts the blocks of a launch in an order it does not promise.
        pending, active, speed, idle = list(rng.permutation(n_spans)), [], [], 0
        while pending or active:
            while pending and len(active) < resident:
                active.append(self.block(sc, hit, k, n_spans, n_spans, ids, count, written,
                                         int(pending.pop())))
                speed.append(10.0 ** rng.uniform(-2, 0))  # some blocks run far slower
            w = np.asarray(speed)
            i = int(rng.choice(len(active), p=w / w.sum()))
            try:
                next(active[i])
                idle += 1
            except StopIteration:
                active.pop(i)
                speed.pop(i)
                idle = 0
            if idle > patience:
                raise Deadlock(f"{len(active)} blocks spin, {len(pending)} never started")
        if any(w != 1 for w in written):
            raise AssertionError(f"slots written {written}")
        return np.asarray(ids, np.int64), count[0]


def _cases(span):
    """(hit bytes, k): nonzero bytes of any value are hits."""
    rng = np.random.default_rng(5)

    def vec(n, rate):
        v = (rng.uniform(size=n) < rate) * rng.integers(1, 256, size=n)
        return v.astype(np.uint8)

    last = np.zeros(20 * span + 50, np.uint8)
    last[-3:] = [1, 200, 9]
    exact = vec(24 * span, 0.01)
    single = np.zeros(16 * span, np.uint8)
    single[0] = 1
    return {
        "sparse": (vec(30 * span, 0.004), 6),
        "dense": (np.full(12 * span, 3, np.uint8), 30),
        "no hits": (np.zeros(25 * span, np.uint8), 5),
        "hits only in the last span": (last, 5),
        "ragged N": (vec(18 * span + 77, 0.03), 40),
        "k above the hits": (vec(20 * span, 0.005), 300),
        "k = hits": (exact, int(np.count_nonzero(exact))),
        "k = 1": (vec(22 * span, 0.02), 1),
        "a single hit at 0": (single, 4),
    }


def _plain(hit, k):
    ids, cnt = masked_first_k_plain(torch.from_numpy(hit.view(np.int8)), k)
    return ids.numpy().astype(np.int64), int(cnt)


CASES = list(_cases(Model().span))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("window", [32, 4])
def test_model_equals_plain_under_random_block_orders(case, window):
    model = Model(window=window)
    hit, k = _cases(model.span)[case]
    want = _plain(hit, k)
    for seed in range(4):
        rng = np.random.default_rng(seed)
        for resident in (1, 3, 8, 1000):
            sc = Scratch(64)
            ids, cnt = model.call(sc, hit, k, rng, resident)
            assert np.array_equal(ids, want[0]) and cnt == want[1], (case, seed, resident)
            assert (sc.ticket, sc.finished, sc.calls) == (0, 0, 1)


def _back_to_back(model, seed, sc=None, calls=3):
    """Every case, in a seeded order, ``calls`` times over, on one scratch;
    the first mismatch raises."""
    sc = sc or Scratch(64)
    rng = np.random.default_rng(seed)
    cases = _cases(model.span)
    for _ in range(calls):
        for name in rng.permutation(CASES):
            hit, k = cases[name]
            ids, cnt = model.call(sc, hit, k, rng, resident=int(rng.integers(2, 12)))
            want = _plain(hit, k)
            if not (np.array_equal(ids, want[0]) and cnt == want[1]):
                raise AssertionError(f"{name}: {ids[:8]} count {cnt} != {want[0][:8]} {want[1]}")
    return sc


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("window", [32, 4])
def test_model_back_to_back_calls_on_one_scratch(seed, window):
    sc = _back_to_back(Model(window=window), seed)
    assert sc.calls == 3 * len(CASES) and sc.ticket == sc.finished == 0


def test_model_tag_wraps_and_clears():
    model = Model(window=4)
    sc = Scratch(64)
    sc.calls = LAST_TAG - 3
    sc = _back_to_back(model, 9, sc, calls=1)
    # The call with tag 2^32 - 1 cleared the words; tags start again at 1.
    assert sc.calls == len(CASES) - 3


@pytest.mark.parametrize("mutation", [
    dict(tags=False),    # status words not tagged by call
    dict(ticket=False),  # spans by block index, whatever order the blocks start in
    dict(reset=False),   # the last block leaves the ticket where the call left it
])
def test_mutated_models_fail(mutation):
    """Each step taken out must show: some seed gives a wrong answer or a
    deadlock."""
    failures = 0
    for seed in range(6):
        try:
            _back_to_back(Model(window=4, **mutation), seed, calls=2)
        except (AssertionError, Deadlock):
            failures += 1
    assert failures > 0, mutation
