"""The traffic generator: deterministic per seed, the source's questions, the same work on every seed."""

import collections
import json
import os

import pytest

from benchmark.lib import corpus, questions, spec
from benchmark.reference import filters

from _bench_cells import RAW, SCOPED


def _mix(name):
    with open(os.path.join(spec.BENCH_DIR, "traffic", name + ".json")) as f:
        return json.load(f)


def _layout():
    return corpus.Layout.from_config(spec.cell(SCOPED)["config"]["corpus"])


def _plan(question, layout):
    by_company = {b: set(layout.periods) for b in layout.banks}
    return filters.tier_groups(question, layout.periods, sorted(layout.banks), by_company)


@pytest.mark.parametrize("traffic", ["scoped-b64x1", "raw-b64x1"])
def test_same_seed_same_calls(traffic):
    mix = _mix(traffic)
    a = questions.caller_calls(mix, 2**31 + 99, 0, 12)
    b = questions.caller_calls(mix, 2**31 + 99, 0, 12)
    c = questions.caller_calls(mix, 2**31 + 100, 0, 12)
    assert a == b
    assert a != c
    assert questions.caller_calls(mix, 5, 1, 3) != questions.caller_calls(mix, 5, 0, 3)


def test_every_seed_sends_the_same_questions():
    mix = _mix("scoped-b64x1")
    n = len(questions.cycle_calls(mix))

    def sent(seed):
        return collections.Counter(q for call in questions.caller_calls(mix, seed, 0, n) for q in call)

    assert sent(1) == sent(2**31 + 3) == sent(77)


def test_questions_are_the_sources_and_give_34_keys():
    with open(os.path.join(spec.ROOT, "ragfin_tpu_torch", "eval", "holdout_phrasings.json")) as f:
        source = [q["question"] for q in json.load(f)["questions"]]
    layout = _layout()
    for name in ("scoped-b64x1", "raw-b64x1"):
        assert _mix(name)["questions"] == source
    keys = set()
    for q in source:
        for group in _plan(q, layout):
            keys.update(repr(sorted(f.items())) for f in group)
    assert len(source) == 48
    assert len(keys) == 34


def test_each_call_holds_every_question():
    mix = _mix("scoped-b64x1")
    cycle = questions.cycle_calls(mix)
    assert len(cycle) == 3
    for call in questions.caller_calls(mix, 123, 0, len(cycle)):
        assert len(call) == 64
        assert set(call) == set(mix["questions"])


def test_raw_and_scoped_send_the_same_questions():
    assert questions.caller_calls(_mix("raw-b64x1"), 9, 0, 4) == \
        questions.caller_calls(_mix("scoped-b64x1"), 9, 0, 4)


def test_frozen_rules_match_the_program():
    from ragfin_tpu_torch.retrieval.queryfilter import FilteredSearch

    mix = _mix("scoped-b64x1")
    layout = _layout()
    by_company = {b: set(layout.periods) for b in layout.banks}
    search = FilteredSearch(index=None)
    for q in mix["questions"]:
        ours = _plan(q, layout)
        theirs = search._tier_groups(q, list(layout.periods), sorted(layout.banks), by_company)
        assert ours == theirs, q


def test_cells_exist():
    for name in (SCOPED, RAW):
        cell = spec.cell(name)
        assert cell["workload"]["chips"] == 1
