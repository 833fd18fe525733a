"""Dynamic micro-batching executor for device search.

Production-serving runtime the reference lacks entirely (every reference
query is a lone Milvus RPC): concurrent callers enqueue queries; a collector
thread drains the queue into one batch (up to ``max_batch`` items or
``max_wait_ms``), runs a single device top-k dispatch over the whole batch,
and resolves per-caller futures. Device utilization then scales with offered
load instead of paying one kernel launch per query — the difference between
~1 and ~30k QPS on the fused kernel (bench.py).

Thread-safe; pure stdlib. Used by the serving layer when
``RAGFIN_BATCH_QUERIES=1`` and directly available as a library component.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

from ..utils.profiling import METRICS


class _WorkItem:
    __slots__ = ("query", "top_k", "future")

    def __init__(self, query: str, top_k: int):
        self.query = query
        self.top_k = top_k
        self.future: Future = Future()


class QueryBatcher:
    """Collects single-query search calls into batched device dispatches.

    ``search_batch_fn(queries, top_k) -> list[list[SearchHit]]`` is the
    underlying batched search (DeviceVectorIndex.search_texts or the sharded
    variant). Queries in one batch share the max requested ``top_k`` and are
    trimmed per caller.
    """

    def __init__(
        self,
        search_batch_fn: Callable[[Sequence[str], int], list],
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
    ):
        self.search_batch_fn = search_batch_fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self._queue: "queue.Queue[_WorkItem]" = queue.Queue()
        self._stop = threading.Event()
        # Guards the stop-flag-check + put pair in _enqueue against stop()'s
        # flag set: once stop() has set the flag under this lock, any
        # concurrent enqueue has either already landed its put (the final
        # drain resolves it) or will observe the flag and fail fast — no
        # item can slip in after the drain and hang its caller.
        self._enqueue_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    # --- lifecycle --------------------------------------------------------
    def start(self) -> "QueryBatcher":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._enqueue_lock:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        # Second drain pass: an item enqueued between a caller's stop-flag
        # check and the collector's final drain would otherwise hang its
        # caller to the full timeout.
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            self._resolve(item, exc=RuntimeError("batcher stopped"))

    def __enter__(self) -> "QueryBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --- client API -------------------------------------------------------
    def _enqueue(self, item: "_WorkItem") -> None:
        with self._enqueue_lock:
            if self._stop.is_set():
                # A put after the collector's shutdown drain would never be
                # resolved and the caller would hang to its timeout; fail
                # fast with the same error the drain uses.
                raise RuntimeError("batcher stopped")
            self._queue.put(item)

    def search(self, query: str, top_k: int = 3, timeout: Optional[float] = 30.0):
        """Blocking single-query search through the batcher."""
        item = _WorkItem(query, top_k)
        self._enqueue(item)
        return item.future.result(timeout=timeout)

    def submit(self, query: str, top_k: int = 3) -> Future:
        item = _WorkItem(query, top_k)
        self._enqueue(item)
        return item.future

    # --- collector --------------------------------------------------------
    def _drain(self) -> list[_WorkItem]:
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    @staticmethod
    def _resolve(item: _WorkItem, hits=None, exc: Optional[Exception] = None) -> None:
        """Resolve a future tolerating concurrent Future.cancel(): the
        cancelled()-then-set sequence is not atomic, and an unhandled
        InvalidStateError would kill the collector thread permanently
        (every later search() would then block to its full timeout)."""
        if not item.future.set_running_or_notify_cancel():
            return  # caller cancelled; nothing to deliver
        try:
            if exc is not None:
                item.future.set_exception(exc)
            else:
                item.future.set_result(hits)
        except Exception:  # racing cancel between the check and the set
            pass

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                batch = self._drain()
                if not batch:
                    continue
                METRICS.incr("batcher.batches")
                METRICS.incr("batcher.queries", len(batch))
                METRICS.observe_value("batcher.batch_size", len(batch))
                k = max(item.top_k for item in batch)
                try:
                    with METRICS.timed("batcher.dispatch"):
                        results = self.search_batch_fn([i.query for i in batch], k)
                    if len(results) != len(batch):
                        raise RuntimeError(
                            f"search_batch_fn returned {len(results)} results "
                            f"for {len(batch)} queries"
                        )
                except Exception as e:
                    for item in batch:
                        self._resolve(item, exc=e)
                    continue
                for item, hits in zip(batch, results):
                    self._resolve(item, hits[: item.top_k])
            except Exception:  # the collector must survive anything
                METRICS.incr("batcher.loop_errors")
        # Drain leftovers on shutdown so no caller hangs to its timeout.
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            self._resolve(item, exc=RuntimeError("batcher stopped"))
