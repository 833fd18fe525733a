"""A numpy model of the selection protocol of csrc/fused_pass1.cuh and
csrc/queue_select.cuh: the gate, the candidate queues, their handoffs and
drains in pass 1, and pass 2 by bound, as the card runs them, with the
orders the card leaves open drawn at random.

Pass 1, one block over one chunk of columns in ascending tile order:
- per tile, each producer unit (a warp's lane: some rows, some columns of
  the tile) compares its scores with its own copy of its rows' k-th scores,
  read when the tile ends from what the drains have published so far (any
  value published up to then: a stale one is lower);
- the units push in a random interleaving; a unit reserves its row's slots
  in one step (the kernel's atomicAdd), writes what fits under the queue's
  capacity, and keeps the rest; at every position of a queue the capacity
  may run out (capacities from 1 entry up);
- while any unit kept candidates, the producers hand the buffer over and
  push the rest into the other buffer, once that buffer's drain has ended;
- a handed-over buffer is drained at a random later moment, at the latest
  when its buffer is needed again: each row's queue is sorted in (score
  desc, id asc) order and merged into the row's list of k, and the list's
  k-th score is published; the chunk's end hands over the last buffer.

Pass 2, per row: the bound is the largest chunk k-th score; each of W
warps takes chunks w, w + W, ..., queues the entries at or above the bound
(and above -inf) into a warp queue of a given capacity, drained when the
next chunk's survivors would not fit; the warps' lists merge in a tree.

Held, under hypothesis: equal to ops/topk.py _fused_select and to a numpy
oracle (stable sort, -inf slots as (-inf, INT32_MAX)), with ties inside
and across producer units, tiles, queue batches and chunks, -inf columns, a
ragged ``limit``, k from 1 to 128; and each chunk's partial list equal to
the oracle of the chunk alone. Two mutated copies of the model must fail:
the strict gate loosened to >= (a -inf column then enters a list that is
not full) and ties sorted by arrival instead of by id.
"""

import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ragfin_tpu_torch.ops import topk as ttopk

INT32_MAX = 0x7FFFFFFF
NEG_INF = -np.inf


def _sort_batch(entries, ties):
    """A drain's sort: (score desc, id asc), or, mutated, score desc with ties
    left in arrival order."""
    if ties == "id":
        return sorted(entries, key=lambda e: (-e[0], e[1]))
    return sorted(entries, key=lambda e: -e[0])  # stable: arrival order


def _merge(lst, batch, k, ties):
    """The list (sorted) and a sorted batch: the best k of both."""
    if ties == "id":
        return sorted(lst + batch, key=lambda e: (-e[0], e[1]))[:k]
    return sorted(lst + batch, key=lambda e: -e[0])[:k]


class Pass1Model:
    """One block's pass 1 over ``scores [R, n]`` (ids ``first_id + column``)."""

    def __init__(self, rng, k, cap, tile, units, gate="gt", ties="id"):
        self.rng, self.k, self.cap, self.tile, self.units = rng, k, cap, tile, units
        self.gate, self.ties = gate, ties

    def _passes(self, v, th):
        return v > th if self.gate == "gt" else v >= th

    def run(self, scores, limit, first_id=0):
        rows, n = scores.shape
        k, rng = self.k, self.rng
        lists = [[] for _ in range(rows)]
        published = [[NEG_INF] for _ in range(rows)]  # every k-th score published, in order
        buffers = [[[] for _ in range(rows)], [[] for _ in range(rows)]]
        pending_drains = []  # handed-over buffer indices, oldest first
        state = {"cur": 0}

        def drain_one():
            b = pending_drains.pop(0)
            for r in range(rows):
                if buffers[b][r]:
                    lists[r] = _merge(lists[r], _sort_batch(buffers[b][r], self.ties), k, self.ties)
                    buffers[b][r] = []
                    published[r].append(lists[r][-1][0] if len(lists[r]) == k else NEG_INF)

        def hand_over():
            pending_drains.append(state["cur"])
            state["cur"] ^= 1
            while state["cur"] in pending_drains:  # the buffer's drain must end first
                drain_one()

        def push(unit_cands):
            """One round in a random interleaving: each (unit, row) reserves
            its slots at once; returns what did not fit, per unit."""
            left = {}
            order = list(unit_cands)
            rng.shuffle(order)
            for u in order:
                by_row = {}
                for e in unit_cands[u]:
                    by_row.setdefault(e[2], []).append(e)
                for r in sorted(by_row, key=lambda _: rng.random()):
                    q = buffers[state["cur"]][r]
                    room = max(0, self.cap - len(q))
                    q.extend((s, i) for s, i, _ in by_row[r][:room])
                    if by_row[r][room:]:
                        left.setdefault(u, []).extend(by_row[r][room:])
            return left

        for c0 in range(0, n, self.tile):
            cols = np.arange(c0, min(c0 + self.tile, n))
            # Drains run whenever the drainers get to them.
            while pending_drains and rng.random() < 0.5:
                drain_one()
            cands = {}
            for u in range(self.units):
                ucols = cols[u :: self.units]
                for r in range(rows):
                    # The unit's copy of the row's k-th score: any value published so far.
                    th = published[r][rng.integers(0, len(published[r]))]
                    for c in ucols:
                        v = scores[r, c] if c < limit else NEG_INF
                        if self._passes(v, th):
                            cands.setdefault(u, []).append((float(v), int(c) + first_id, r))
            left = push(cands)
            while left:
                hand_over()
                left = push(left)
        hand_over()
        while pending_drains:
            drain_one()
        out_s = np.full((rows, k), NEG_INF, np.float32)
        out_i = np.full((rows, k), INT32_MAX, np.int64)
        for r, lst in enumerate(lists):
            for j, (s, i) in enumerate(lst):
                out_s[r, j], out_i[r, j] = s, i
        return out_s, out_i


def pass2_model(parts_s, parts_i, k, warps, cap, ties="id"):
    """Pass 2 by bound over partial lists [chunks, R, k] (sorted, -inf empty)."""
    chunks, rows, _ = parts_s.shape
    out_s = np.full((rows, k), NEG_INF, np.float32)
    out_i = np.full((rows, k), INT32_MAX, np.int64)
    for r in range(rows):
        bound = max(parts_s[c, r, k - 1] for c in range(chunks))
        warp_lists = []
        for w in range(warps):
            lst, queue = [], []
            for c in range(w, chunks, warps):
                surv = [(float(s), int(i)) for s, i in zip(parts_s[c, r], parts_i[c, r])
                        if s > NEG_INF and s >= bound]
                if len(queue) + len(surv) > cap:
                    lst = _merge(lst, _sort_batch(queue, ties), k, ties)
                    queue = []
                queue.extend(surv)
            warp_lists.append(_merge(lst, _sort_batch(queue, ties), k, ties))
        while len(warp_lists) > 1:  # the tree: pairs of lists
            warp_lists = [_merge(warp_lists[j], warp_lists[j + 1] if j + 1 < len(warp_lists) else [],
                                 k, ties) for j in range(0, len(warp_lists), 2)]
        for j, (s, i) in enumerate(warp_lists[0]):
            out_s[r, j], out_i[r, j] = s, i
    return out_s, out_i


def selection_model(scores, k, limit, rng, chunk_tiles, tile, units, cap, warps, cap2,
                    gate="gt", ties="id"):
    """Both passes over ``scores [R, N]``: chunks of ``chunk_tiles`` tiles.
    Returns the result and pass 1's partial lists [chunks, R, k]."""
    width = chunk_tiles * tile
    model = Pass1Model(rng, k, cap, tile, units, gate, ties)
    parts = [model.run(scores[:, c0 : c0 + width], limit - c0, first_id=c0)
             for c0 in range(0, scores.shape[1], width)]
    parts_s = np.stack([p[0] for p in parts])
    parts_i = np.stack([p[1] for p in parts])
    return pass2_model(parts_s, parts_i, k, warps, max(cap2, k), ties), (parts_s, parts_i)


def numpy_oracle(scores, k, limit):
    """Stable descending sort of the masked scores; -inf slots (-inf, INT32_MAX)."""
    s = scores.astype(np.float32).copy()
    s[:, limit:] = NEG_INF
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    top = np.take_along_axis(s, order, 1)
    out_s = np.full((s.shape[0], k), NEG_INF, np.float32)
    out_i = np.full((s.shape[0], k), INT32_MAX, np.int64)
    w = top.shape[1]
    out_s[:, :w] = top
    out_i[:, :w] = np.where(np.isneginf(top), INT32_MAX, order)
    return out_s, out_i


def _scores(rng, rows, n, levels, neg_share):
    pool = rng.standard_normal(levels).astype(np.float32)
    s = rng.choice(pool, (rows, n)).astype(np.float32)
    s[rng.random((rows, n)) < neg_share] = NEG_INF
    return s


def _run(seed, rows, n, k, cut, levels, neg_share, chunk_tiles, tile, units, cap, warps, cap2,
         gate="gt", ties="id"):
    rng = np.random.default_rng(seed)
    scores = _scores(rng, rows, n, levels, neg_share)
    limit = int(cut * n)
    got, parts = selection_model(scores, k, limit, rng, chunk_tiles, tile, units, cap, warps,
                                 cap2, gate, ties)
    return scores, limit, got, parts


def _contract_holds(scores, limit, k, width, got, parts):
    """The result equals the oracle, and each chunk's partial list equals the
    oracle of the chunk alone (pass 1's contract: a -inf score never enters,
    so a chunk with fewer than k valid columns ends in (-inf, INT32_MAX))."""
    want = numpy_oracle(scores, k, limit)
    ok = np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    for c, c0 in enumerate(range(0, scores.shape[1], width)):
        ws, wi = numpy_oracle(scores[:, c0 : c0 + width], k, max(0, limit - c0))
        wi = np.where(wi == INT32_MAX, wi, wi + c0)
        ok &= np.array_equal(parts[0][c], ws) and np.array_equal(parts[1][c], wi)
    return ok


@settings(max_examples=60, deadline=None)
@given(
    rows=st.integers(1, 3),
    n=st.integers(1, 500),
    k=st.integers(1, 128),
    cut=st.floats(0.0, 1.0),
    levels=st.integers(1, 6),
    neg_share=st.sampled_from([0.0, 0.1, 0.5]),
    chunk_tiles=st.integers(1, 4),
    tile=st.sampled_from([8, 32, 128]),
    units=st.sampled_from([1, 4, 8]),
    cap=st.integers(1, 64),
    warps=st.sampled_from([1, 3, 8]),
    cap2=st.sampled_from([1, 32, 128]),
    seed=st.integers(0, 2**31 - 1),
)
def test_protocol_equals_fused_select_and_the_oracle(rows, n, k, cut, levels, neg_share,
                                                     chunk_tiles, tile, units, cap, warps, cap2,
                                                     seed):
    scores, limit, (got_s, got_i), parts = _run(seed, rows, n, k, cut, levels, neg_share,
                                                chunk_tiles, tile, units, cap, warps, cap2)
    assert _contract_holds(scores, limit, k, chunk_tiles * tile, (got_s, got_i), parts)
    masked = torch.from_numpy(scores.copy())
    masked[:, limit:] = float("-inf")
    want_s, want_i = ttopk._fused_select(masked, k)
    np.testing.assert_array_equal(got_s, want_s.numpy())
    np.testing.assert_array_equal(got_i, want_i.numpy().astype(np.int64))
    oracle_s, oracle_i = numpy_oracle(scores, k, limit)
    np.testing.assert_array_equal(got_s, oracle_s)
    np.testing.assert_array_equal(got_i, oracle_i)


def test_every_queue_position_overflows():
    """Capacities 1 to 9 on one tie-heavy row: every position of a queue
    runs out at some capacity, and the result never changes."""
    rng = np.random.default_rng(11)
    scores = _scores(rng, 2, 300, 3, 0.1)
    want = numpy_oracle(scores, 20, 290)
    for cap in range(1, 10):
        got, parts = selection_model(scores, 20, 290, np.random.default_rng(cap), 2, 16, 4, cap,
                                     3, 5)
        assert _contract_holds(scores, 290, 20, 32, got, parts)


# The mutants' runs: two rows, 200 columns of two values and 20 % -inf, the
# last 40 % past the limit, chunks of 32 columns (fewer valid columns than k
# = 24 in the chunks past the limit), queues of 5.
MUTANT_RUN = (2, 200, 24, 0.6, 2, 0.2, 2, 16, 4, 5, 3, 8)


def _mutant_fails(gate, ties):
    for seed in range(40):
        scores, limit, got, parts = _run(seed, *MUTANT_RUN, gate=gate, ties=ties)
        if not _contract_holds(scores, limit, 24, 32, got, parts):
            return True
    return False


def test_the_same_runs_pass_unmutated():
    assert not _mutant_fails(gate="gt", ties="id")


def test_a_loosened_gate_fails():
    """>= lets -inf through while a list is not full: a -inf column enters a
    partial list (pass 2's bound filter would drop it again, so the final
    result alone cannot show it)."""
    assert _mutant_fails(gate="ge", ties="id")


def test_ties_sorted_by_arrival_fail():
    """Units push in a random interleaving: arrival order is not id order."""
    assert _mutant_fails(gate="gt", ties="arrival")
