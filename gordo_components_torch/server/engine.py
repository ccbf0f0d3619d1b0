"""Continuous batching: coalesce concurrent requests into one bank call.

Counterpart of ``BatchingEngine``, ``EngineOverloaded`` and ``score_blocking``
in ``gordo_components_tpu/server/bank.py``, on threads instead of asyncio:
the HTTP server answers each request on its own thread, which blocks in
:meth:`BatchingEngine.score_blocking` while one worker thread scores.

The worker takes the oldest waiting request, then gathers more until it
holds ``max_batch`` or ``flush_ms`` have passed since that request arrived,
and scores them all in one ``ModelBank.score_many`` call. If that call
raises, each request of the batch is scored alone, so one bad request
fails only itself. The queue is bounded: when it holds ``max_queue``
requests a new one raises :class:`EngineOverloaded` at once (HTTP 429).
"""

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Optional

import numpy as np

from gordo_components_torch.server.bank import ModelBank, ScoreResult


@dataclass
class _Pending:
    name: str
    X: np.ndarray
    y: Optional[np.ndarray]
    future: Future
    enqueued: float  # monotonic seconds at submission


class EngineOverloaded(Exception):
    """The engine's queue is full. ``retry_after_s`` estimates the time to
    drain it, for the HTTP layer's ``Retry-After``."""

    def __init__(self, depth: int, retry_after_s: float):
        self.depth = depth
        self.retry_after_s = retry_after_s
        super().__init__(f"scoring queue full ({depth} pending); retry in ~{retry_after_s:.1f}s")


class BatchingEngine:
    """Coalesce scoring requests from many threads into batched bank calls."""

    def __init__(
        self,
        bank: ModelBank,
        max_batch: int = 64,
        flush_ms: float = 2.0,
        max_queue: Optional[int] = None,
    ):
        self.bank = bank
        self.max_batch = int(max_batch)
        self.flush_s = float(flush_ms) / 1e3
        self.max_queue = int(max_queue if max_queue is not None else 8 * self.max_batch)
        if self.max_queue <= 0:
            raise ValueError(f"max_queue must be positive, got {max_queue!r}")
        self._queue: "queue.Queue[_Pending]" = queue.Queue(self.max_queue)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._batch_s = 0.0  # the last batch's scoring seconds
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "max_batch_seen": 0, "shed": 0}

    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, name="gordo-engine", daemon=True)
            self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the worker; requests still queued fail with RuntimeError."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("engine worker did not stop")
        self._thread = None
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            p.future.set_exception(RuntimeError("engine stopped"))

    def drain_estimate(self, depth: int) -> float:
        """Seconds to drain ``depth`` queued requests at the last batch's pace."""
        return max(self.flush_s, depth / self.max_batch * max(self._batch_s, 1e-3))

    def submit(self, name: str, X: np.ndarray, y: Optional[np.ndarray] = None) -> Future:
        """Queue one request; its future resolves to a :class:`ScoreResult`."""
        if self._thread is None:
            raise RuntimeError("engine is not running (call start() first)")
        fut: Future = Future()
        try:
            self._queue.put_nowait(_Pending(name, X, y, fut, time.monotonic()))
        except queue.Full:
            with self._stats_lock:
                self.stats["shed"] += 1
            depth = self._queue.qsize()
            raise EngineOverloaded(depth, self.drain_estimate(depth)) from None
        return fut

    def score_blocking(
        self, name: str, X: np.ndarray, y: Optional[np.ndarray] = None,
        timeout: Optional[float] = None,
    ) -> ScoreResult:
        """Score one request from a plain thread, blocking until its batch
        is done."""
        return self.submit(name, X, y).result(timeout)

    def _collect(self, first: _Pending):
        batch = [first]
        deadline = first.enqueued + self.flush_s
        while len(batch) < self.max_batch:
            wait = deadline - time.monotonic()
            try:
                batch.append(self._queue.get(timeout=wait) if wait > 0 else self._queue.get_nowait())
            except queue.Empty:
                break
        return batch

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [p for p in self._collect(first) if p.future.set_running_or_notify_cancel()]
            if not batch:
                continue
            t0 = time.monotonic()
            try:
                results = self.bank.score_many([(p.name, p.X, p.y) for p in batch])
            except Exception:
                # one bad request must not fail its neighbours: score alone
                for p in batch:
                    try:
                        p.future.set_result(self.bank.score(p.name, p.X, p.y))
                    except Exception as exc:
                        p.future.set_exception(exc)
            else:
                for p, r in zip(batch, results):
                    p.future.set_result(r)
            self._batch_s = time.monotonic() - t0
            with self._stats_lock:
                self.stats["requests"] += len(batch)
                self.stats["batches"] += 1
                self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], len(batch))
