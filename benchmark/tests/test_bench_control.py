"""The control, the reference put in the program's place one precision step
down (float8 encoder, TF32 float32 scores, int4 shortlist with a TF32
re-score), comes out not correct by each cell's limits."""

import pytest

from benchmark import calibrate

from _bench_cells import RAW, SCOPED, small_cell


def _failing(cell, line):
    return [k for k, limit in cell["limits"].items() if line[k] > limit]


@pytest.mark.parametrize("name", [SCOPED, RAW])
def test_control_fails_on_the_cpu(name):
    cell = small_cell(name, per_caller=2)
    (line,) = calibrate.readings(cell, [], [2**31 + 8], 0.0, "cpu", rows=8192, emit=lambda *a, **k: None)
    assert line["questions"] == cell["mix"]["callers"] * 2 * 64
    failing = _failing(cell, line)
    assert "qvec_cos_gap" in failing and ("score_err" in failing or "order_gap" in failing), line


@pytest.mark.cuda
@pytest.mark.parametrize("name", [SCOPED, RAW])
def test_control_fails_every_stage_on_the_card(card, name):
    cell = small_cell(name, per_caller=3)
    lines = calibrate.readings(cell, [], [11, 12, 13], 0.0, card, rows=1_000_000,
                               emit=lambda *a, **k: None)
    for line in lines:
        failing = _failing(cell, line)
        assert "qvec_cos_gap" in failing and ("score_err" in failing or "order_gap" in failing), line
