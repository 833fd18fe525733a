"""The port's spans and counters (``ragfin_tpu_torch/utils/profiling.py``), the
search path that opens them, and the benchmark's readers of them, on the CPU."""

import contextlib
import json
import os
import sys
import threading
import time
from types import SimpleNamespace
from unittest import mock

import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from benchmark.lib import spans as bench_spans
from benchmark.lib import spec
from ragfin_tpu_torch.data.models import IndexedChunk
from ragfin_tpu_torch.index.vector_index import DeviceVectorIndex
from ragfin_tpu_torch.retrieval.vector_rag import VectorRAG
from ragfin_tpu_torch.serving.batcher import QueryBatcher
from ragfin_tpu_torch.utils import profiling
from ragfin_tpu_torch.utils.profiling import METRICS, MetricRegistry


@contextlib.contextmanager
def _capture():
    """A CPU profiler capture of every thread: the program's spans record
    inside it."""
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield prof


@pytest.fixture
def registry(monkeypatch):
    """A fresh registry, which the benchmark's readers read, with the test
    inside a capture."""
    reg = MetricRegistry()
    monkeypatch.setattr(bench_spans, "METRICS", reg)
    with _capture():
        yield reg


@pytest.fixture
def capture():
    """The test inside a capture, on the process's registry."""
    with _capture():
        yield METRICS


def _window(t0, t1):
    return SimpleNamespace(trace={}, window_start=t0, window_end=t1)


def test_spans_nest_and_share_a_root(registry):
    t0 = time.perf_counter()
    with registry.span("call") as call:
        with registry.span("index.search") as search:
            with registry.span("index.search", nested=False) as again:
                assert again is None
            with registry.span("encode") as enc:
                time.sleep(0.002)
        with registry.span("index.hits") as hits:
            time.sleep(0.001)
    with registry.span("call") as second:
        pass
    t1 = time.perf_counter()
    kept = registry.spans()
    assert [s.name for s in kept] == ["encode", "index.search", "index.hits", "call", "call"]
    assert call.parent is None and call.root == call.id and second.root == second.id != call.id
    assert search.parent == call.id and hits.parent == call.id and enc.parent == search.id
    assert {s.root for s in (search, enc, hits)} == {call.id}
    assert {s.thread for s in kept} == {threading.get_ident()}
    assert call.start_ns <= search.start_ns <= enc.start_ns <= enc.end_ns <= search.end_ns
    assert search.end_ns <= hits.start_ns <= hits.end_ns <= call.end_ns
    run = _window(t0, t1)
    own = call.duration_ns - search.duration_ns - hits.duration_ns
    assert bench_spans.self_ms(run, "call") == pytest.approx((own + second.duration_ns) / 2e6)
    assert bench_spans.self_ms(run, "index.search") == pytest.approx(
        (search.duration_ns - enc.duration_ns) / 2e6)
    assert bench_spans.ms(run, "encode", "index.hits") == pytest.approx(
        (enc.duration_ns + hits.duration_ns) / 2e6)
    # Only roots that started and ended inside the window count.
    assert bench_spans.ms(_window(t0, call.end_ns / 1e9), "encode") == pytest.approx(
        enc.duration_ns / 1e6)


def test_a_count_lands_in_the_innermost_open_span(registry):
    registry.count("index.query_upload")
    with registry.span("index.search") as search:
        registry.count("index.query_upload", 2)
        with registry.span("index.upload") as upload:
            registry.count("index.query_upload")
            registry.count("index.mask_build", 3)
    assert search.counts == {"index.query_upload": 2}
    assert upload.counts == {"index.query_upload": 1, "index.mask_build": 3}
    counters = registry.summary()["counters"]
    assert counters["index.query_upload"] == 4 and counters["index.mask_build"] == 3


def test_tracing_off_records_nothing_and_enters_no_profiler_range(monkeypatch):
    reg = MetricRegistry()
    fake = mock.MagicMock()
    monkeypatch.setattr(profiling, "_profiler_range", fake)
    with reg.span("index.search"):
        with reg.span("encode"):
            reg.count("index.query_upload")
    assert reg.span("encode") is reg.span("index.hits")  # the thread's one no-op root
    assert reg.spans() == [] and not fake.called
    assert reg.summary()["counters"] == {"index.query_upload": 1}


def test_a_capture_that_starts_inside_a_call_records_none_of_it():
    reg = MetricRegistry()
    with reg.span("retrieval.search"):
        with _capture():
            with reg.span("index.search") as inner:
                assert inner is None
                reg.count("index.query_upload")
                with reg.span("encode") as enc:
                    assert enc is None
            # Another thread's call that starts inside the capture records.
            def other_call():
                with reg.span("index.search"):
                    pass

            worker = threading.Thread(target=other_call)
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
    assert [(s.name, s.parent) for s in reg.spans()] == [("index.search", None)]
    assert reg.spans()[0].thread != threading.get_ident()
    assert reg.summary()["counters"] == {"index.query_upload": 1}
    # The thread's next call inside a capture is recorded whole.
    with _capture():
        with reg.span("retrieval.search") as root:
            with reg.span("index.search") as inner:
                pass
    assert [s.name for s in reg.spans()[1:]] == ["index.search", "retrieval.search"]
    assert inner.parent == root.id and root.parent is None


def test_a_profiler_capture_records_spans_as_ragfin_ranges_with_no_flag():
    reg = MetricRegistry()

    def work():
        with reg.span("index.search"):
            with reg.span("index.topk"):
                torch.ones(4).sum()

    with _capture() as prof:
        work()
        worker = threading.Thread(target=work)
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
    work()  # after the capture: nothing
    kept = reg.spans()
    assert [s.name for s in kept] == ["index.topk", "index.search"] * 2
    assert len({s.thread for s in kept}) == 2
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("ragfin.index.search") == 2 and names.count("ragfin.index.topk") == 2


def test_threads_keep_their_own_spans_and_lose_no_count(registry):
    threads, per_thread = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    together = threading.Barrier(threads)  # all alive at once: no thread id is reused
    try:
        def work():
            together.wait(timeout=30)
            for _ in range(per_thread):
                with registry.span("index.search"):
                    registry.count("index.query_upload")
                    with registry.span("index.upload"):
                        registry.count("index.query_upload")
            together.wait(timeout=30)

        workers = [threading.Thread(target=work) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
            assert not w.is_alive()
    finally:
        sys.setswitchinterval(interval)
    kept = registry.spans()
    assert len(kept) == 2 * threads * per_thread == len({s.id for s in kept})
    assert registry.summary()["counters"]["index.query_upload"] == 2 * threads * per_thread
    by_id = {s.id: s for s in kept}
    for s in kept:
        if s.name == "index.upload":
            parent = by_id[s.parent]
            assert parent.name == "index.search" and s.root == parent.id
            assert s.thread == parent.thread and s.counts == {"index.query_upload": 1}
    assert len({s.thread for s in kept}) == threads


def test_the_buffer_bound_counts_dropped_spans(registry):
    registry.span_limit = 3
    t0 = time.perf_counter()
    for _ in range(5):
        with registry.span("index.search"):
            pass
    t1 = time.perf_counter()
    assert len(registry.spans()) == 3
    assert registry.summary()["counters"]["trace.dropped"] == 2
    assert bench_spans.ms(_window(t0, t1), "index.search") is None
    registry.reset()
    assert registry.spans() == [] and registry.summary()["counters"] == {}


def test_the_batcher_observes_each_items_wait(capture):
    def wait_of():
        return METRICS.summary()["latency_ms"].get("batcher.wait", {}).get("count", 0)

    gate = threading.Event()
    batch_sizes = []

    def search(queries, k):
        gate.wait(5)
        batch_sizes.append(len(queries))
        with METRICS.span("index.search"):
            return [[q] * k for q in queries]

    before = wait_of()
    t0 = time.perf_counter()
    with QueryBatcher(search, max_batch=8, max_wait_ms=50.0) as batcher:
        futures = [batcher.submit(f"q{i}", top_k=2) for i in range(6)]
        time.sleep(0.01)
        gate.set()
        assert [f.result(timeout=10) for f in futures] == [[f"q{i}"] * 2 for i in range(6)]
    t1 = time.perf_counter()
    assert wait_of() - before == 6 == sum(batch_sizes)
    mine = [s for s in METRICS.spans() if t0 * 1e9 <= s.start_ns and s.end_ns <= t1 * 1e9]
    roots = [s for s in mine if s.name == "batcher.dispatch"]
    assert len(roots) == len(batch_sizes) and all(r.parent is None for r in roots)
    searches = [s for s in mine if s.name == "index.search"]
    assert sorted(s.parent for s in searches) == sorted(r.id for r in roots)


def _chunks(n=240):
    types = ["profitability", "key_ratios", "balance_sheet", "asset_quality"]
    out = []
    for i in range(n):
        q, fy = 1 + i % 4, 2022 + (i // 4) % 3
        ctype = types[(i // 12) % 4]
        out.append(IndexedChunk(
            id=f"c{i}", period=f"Q{q}_FY{fy}", chunk_type=ctype,
            text=f"ICICI Bank Q{q} FY{fy} {ctype.replace('_', ' ')}: net profit {100 + i} crore, "
                 f"net interest income {300 + 7 * i} crore, gross NPA {1 + i % 9}.{i % 7} percent",
        ))
    return out


QUESTIONS = [
    "What was ICICI Bank's net profit in Q1 FY2024?",
    "net interest income Q3 FY2023",
    "gross NPA in the second quarter of FY2024",
    "How did the bottom line move in Q4 FY2022?",
    "key ratios Q2 FY2023",
]

# Per cell: how a call runs, and the readers of its per-layer metrics.
PATHS = {
    "raw": ("int8", ["tokenize_ms.raw", "encode_launch_ms.raw", "readback_ms.raw",
                     "hits_ms.raw", "repair_ms.raw"]),
    "scoped": ("float32", ["plan_ms", "tokenize_ms", "encode_launch_ms", "readback_ms",
                           "hits_ms", "mask_builds_per_call", "uploads_per_call"]),
}


@pytest.fixture(scope="module")
def indexes():
    chunks = _chunks()
    return {dtype: DeviceVectorIndex.build(chunks, device="cpu", dtype=dtype)
            for dtype in ("int8", "float32")}


def _hits(results):
    return [[(h.id, h.score, h.rank) for h in hits] for hits in results]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_search_hits_are_equal_with_tracing_on_and_its_spans_feed_the_readers(path, indexes):
    dtype, metrics = PATHS[path]
    index = indexes[dtype]
    if path == "raw":
        def call():
            return index.search_texts(QUESTIONS, top_k=5)
    else:
        rag = VectorRAG(index, None, integrity_weight=0.0)

        def call():
            return rag.search_batch(QUESTIONS, top_k=5)

    untraced = _hits(call())  # also warms every mask
    assert METRICS.span("index.search") is METRICS._open.stack.untraced
    with _capture():
        t0 = time.perf_counter()
        traced = [_hits(call()) for _ in range(3)]
        t1 = time.perf_counter()
    assert traced == [untraced] * 3
    run = _window(t0, t1)
    root = "index.search" if path == "raw" else "retrieval.search"
    roots = [s for s in METRICS.spans()
             if s.parent is None and t0 * 1e9 <= s.start_ns and s.end_ns <= t1 * 1e9]
    assert [s.name for s in roots] == [root] * 3
    values = {m: spec.reader(m)(run) for m in metrics}
    assert all(v is not None for v in values.values()), values
    assert all(v > 0 for m, v in values.items() if m.endswith("_ms") or m.endswith("_ms.raw")), values

    # The readers' spans and the self times add up to the roots' durations.
    per_call = sum(s.duration_ns for s in roots) / 3e6
    index_children = ["index.mask", "index.upload", "index.topk", "index.readback",
                      "index.repair", "index.hits"]
    encode = bench_spans.ms(run, "encode")
    assert encode == pytest.approx(
        bench_spans.ms(run, "encode.tokenize", "encode.forward", "encode.readback")
        + bench_spans.self_ms(run, "encode"), rel=1e-9)
    whole = (bench_spans.self_ms(run, "index.search") + encode
             + bench_spans.ms(run, *index_children))
    if path == "scoped":
        whole += values["plan_ms"]
    assert whole == pytest.approx(per_call, rel=1e-9)
    prefix = "" if path == "scoped" else ".raw"
    assert values["tokenize_ms" + prefix] == bench_spans.ms(run, "encode.tokenize")
    assert values["readback_ms" + prefix] == pytest.approx(
        bench_spans.ms(run, "encode.readback") + bench_spans.ms(run, "index.readback"))
    if path == "raw":
        assert values["repair_ms.raw"] == bench_spans.ms(run, "index.repair")
    else:
        searches = bench_spans.count(run, "index.query_upload")
        dispatches = sum(1 for s in METRICS.spans() if s.name == "index.search"
                         and t0 * 1e9 <= s.start_ns and s.end_ns <= t1 * 1e9) / 3
        assert values["uploads_per_call"] == searches == dispatches > 1
        assert values["mask_builds_per_call"] == 0


def test_trace_writes_a_chrome_trace_with_the_program_spans(indexes, tmp_path):
    index = indexes["float32"]
    with profiling.trace(str(tmp_path)):
        worker = threading.Thread(target=index.search_texts, args=(QUESTIONS[:2],))
        worker.start()
        worker.join(timeout=60)
        assert not worker.is_alive()
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"ragfin.index.search", "ragfin.encode", "ragfin.encode.tokenize",
            "ragfin.index.topk", "ragfin.index.hits"} <= names
    search = [e for e in events if e.get("name") == "ragfin.index.search"]
    assert len(search) == 1 and search[0]["dur"] > 0
