"""The yardstick's arithmetic on hand-worked shapes, and the metric readers."""

import types

import pytest

from benchmark.lib import roofline, spec, trace
from benchmark.lib.corpus import Layout


def test_topk_least_time_f32_is_the_matrix_read():
    # 10M x 384 float32 = 15.36e9 bytes; queries 64 x 384 x 4; ids and
    # scores 64 x 10 x 8.
    assert roofline.topk_bytes(64, 10_000_000, 384, 10, "float32") == 15_360_000_000 + 98_304 + 5_120
    assert roofline.topk_ops(64, 10_000_000, 384) == 491_520_000_000
    least = roofline.topk_least_s(64, 10_000_000, 384, 10, "float32")
    assert least == pytest.approx(15_360_103_424 / 3.35e12)
    assert least == pytest.approx(4.585e-3, rel=1e-3)
    # The product alone, at the TF32 peak, would take 0.993 ms.
    assert 491_520_000_000 / 495e12 == pytest.approx(0.993e-3, rel=1e-3)


def test_topk_least_time_int8_counts_the_scales():
    b = roofline.topk_bytes(64, 10_000_000, 384, 10, "int8")
    assert b == 3_840_000_000 + 40_000_000 + 98_304 + 5_120
    assert roofline.topk_least_s(64, 10_000_000, 384, 10, "int8") == pytest.approx(b / 3.35e12)
    # Compute-bound only when the queries are many: Q = 8192 at N = 1M.
    q, n = 8192, 1_000_000
    assert roofline.topk_least_s(q, n, 384, 10, "int8") == pytest.approx(2 * q * n * 384 / 1979e12)


def test_encoder_flops_by_hand():
    # 4 layers, hidden 384, FFN 1536, one sequence of 10 real tokens:
    # per token 2 (4 * 384^2 + 2 * 384 * 1536) = 3,538,944; attention
    # 2 * 2 * 10 * 10 * 384 = 153,600 per layer.
    assert roofline.encoder_flops([10], 4, 384, 1536) == 4 * (10 * 3_538_944 + 153_600)
    assert roofline.encoder_flops([10, 3], 1, 384, 1536) == (
        13 * 3_538_944 + 4 * (100 + 9) * 384)


def _call(start, end, q=64, error=None, encoded=(), dispatches=1, encode_s=0.0, index_s=0.0):
    stats = types.SimpleNamespace(encoded=list(encoded), dispatches=dispatches,
                                  encode_s=encode_s, index_s=index_s)
    return types.SimpleNamespace(start=start, end=end, questions=q, error=error, stats=stats)


def _run(calls, seconds=10.0, trace_=None, rows=1_000_000, dtype="float32"):
    layout = Layout(rows=rows, dim=384, banks=("A",), periods=("Q1_FY2025",),
                    chunk_types=("t",), spread=0.5)
    run = types.SimpleNamespace(
        calls=calls, window_start=0.0, window_end=seconds, seconds=seconds, setup_s=12.5,
        peak_bytes=3 * 2**30, trace=trace_, layout=layout, top_k=10, dtype=dtype,
        config={"num_hidden_layers": 4, "hidden_size": 384, "intermediate_size": 1536},
        tokens=lambda t: len(t.split()) + 2)
    run.completed = [c for c in calls if c.end <= run.window_end and c.error is None]
    return run


def test_end_to_end_readers():
    calls = [_call(i, i + 0.5) for i in range(10)] + [_call(9.8, 10.4)]  # the last one ends late
    run = _run(calls)
    # The late call counts a third of its questions: 0.2 of its 0.6 s lie inside.
    assert spec.reader("qps")(run) == pytest.approx((10 * 64 + 64 / 3) / 10.0)
    assert spec.reader("p95_ms")(run) == pytest.approx(500.0)
    assert spec.reader("peak_gib")(run) == pytest.approx(3.0)
    assert spec.reader("setup_s")(run) == 12.5


def test_per_layer_readers():
    calls = [_call(i, i + 1, encoded=[["a b c"] * 8], dispatches=3, encode_s=0.01, index_s=0.02)
             for i in range(4)]
    tr = {"window_s": 5.0, "busy_s": 4.0, "index_device_s": 0.5}
    run = _run(calls, seconds=5.0, trace_=tr)
    assert spec.reader("dispatches_per_call")(run) == 3
    assert spec.reader("encode_ms")(run) == pytest.approx(10.0)
    assert spec.reader("index_ms")(run) == pytest.approx(20.0)
    assert spec.reader("device_idle")(run) == pytest.approx(20.0)
    least = 4 * roofline.topk_least_s(64, 1_000_000, 384, 10, "float32")
    assert spec.reader("topk_roofline")(run) == pytest.approx(100 * least / 0.5)
    flops = 4 * (roofline.topk_ops(64, 1_000_000, 384) + roofline.encoder_flops([5] * 8, 4, 384, 1536))
    assert spec.reader("step_mfu")(run) == pytest.approx(100 * flops / (5.0 * 989e12))


def test_device_readers_are_silent_without_a_trace():
    run = _run([_call(0, 1)])
    for name in ("topk_roofline", "device_idle"):
        assert spec.reader(name)(run) is None
    run = _run([_call(0, 1)], trace_={"window_s": 1.0, "busy_s": 0.5, "index_device_s": 0.0})
    assert spec.reader("topk_roofline")(run) is None


def test_union_and_spans():
    total, merged = trace._union([(0, 10), (5, 20), (30, 40)])
    assert total == 30 and merged == [(0, 20), (30, 40)]
    spans = trace._Spans([(0, 100, "bench.call"), (10, 50, "bench.index"), (20, 30, "bench.encode"),
                          (200, 300, "bench.call")])
    assert spans.active(25) == {"bench.call", "bench.index", "bench.encode"}
    assert spans.active(40) == {"bench.call", "bench.index"}
    assert spans.active(150) == set()
    assert spans.active(250) == {"bench.call"}


@pytest.mark.parametrize("base", ["qps", "p95_ms", "encode_ms", "index_ms", "topk_roofline",
                                  "device_idle", "step_mfu"])
def test_raw_readers_read_as_their_base(base):
    calls = [_call(i, i + 0.5, encoded=[["a b c"] * 8], encode_s=0.01, index_s=0.02) for i in range(6)]
    run = _run(calls, seconds=4.0, trace_={"window_s": 4.0, "busy_s": 1.0, "index_device_s": 0.25})
    assert spec.reader(base + ".raw")(run) == spec.reader(base)(run)


def test_every_cell_reports_what_its_layer_metrics_move():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in e2e, (w["name"], m["name"])
