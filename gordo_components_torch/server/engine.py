"""Continuous batching: coalesce concurrent requests into one bank call.

Counterpart of ``BatchingEngine``, ``EngineOverloaded`` and ``score_blocking``
in ``gordo_components_tpu/server/bank.py``, on threads instead of asyncio:
the HTTP server answers each request on its own thread, which blocks in
:meth:`BatchingEngine.score_blocking` while one worker thread scores.

The worker takes the oldest waiting request, then gathers more until it
holds ``max_batch`` or ``flush_ms`` have passed since that request arrived,
and scores them all in one ``ModelBank.score_many`` call. A failed bucket
group comes back as its requests' errors, and those requests are scored
again alone, so one bad request fails only itself. A batch reads
``self.bank`` once, so a bank swap (``server/swap.py``) flips the engine
between batches and a batch in flight drains on the bank it started on.
The queue is the weighted-fair queue of ``qos/fair.py``
(``GORDO_QOS_WEIGHTS``): the worker dequeues across the priority classes
by weighted virtual time and inside a class by deadline, so a flood of
``best_effort`` requests delays ``interactive`` ones by at most their
weight share; with every request in one class the order is FIFO. The
queue is bounded: when it holds ``max_queue`` requests a new one raises
:class:`EngineOverloaded` at once (HTTP 429), the bound tested under the
queue's lock.

Deadlines (``resilience/deadline.py``), as in the JAX engine: ``submit``
refuses an expired deadline at admission; after a batch is collected one
clock read drops its expired entries before any device work, with
:class:`DeadlineExceeded`; the batch's earliest deadline goes to the bank,
which stops between bucket groups once it passes; and a request scored
again after a failure is first judged against its own deadline.

Metrics: ``stats`` (requests, batches, max_batch_seen, shed,
deadline_expired) is mutated under the engine's lock and rendered through
a collector of the bank's registry as ``gordo_engine_*``, with the
``queue_wait`` (submit to dispatch) and ``service`` (submit to result)
histograms. ``class_stats`` counts requests, shed and deadline_expired
a class under the same lock (``gordo_engine_class_*``, with the live
depth a class), and :meth:`BatchingEngine.qos_snapshot` is the engine's
half of ``GET .../qos``.

Traces and goodput, as in the JAX engine: a request's trace rides its
``_Pending`` (a context variable does not cross from the HTTP thread to
the worker), the worker records its ``queue_wait`` span (submit to
dispatch, with the batch size) and passes the batch's traces to the
bank, which records the stage spans; each dispatched request's wait goes
to the bank's goodput ledger (``record_queue_wait``). An expiry records a
``deadline_expired`` span where it happened (admission, queue, retry).
"""

import queue
import threading
import time
import weakref
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from gordo_components_torch.qos.classify import CLASSES, DEFAULT_CLASS, DEFAULT_TENANT
from gordo_components_torch.qos.fair import WeightedFairQueue, parse_weights
from gordo_components_torch.resilience.deadline import Deadline, DeadlineExceeded
from gordo_components_torch.resilience.faults import faultpoint
from gordo_components_torch.server.bank import ModelBank, ScoreResult
from gordo_components_torch.server.stats import LatencyHistogram

# every request's admission (score_blocking goes through submit): a failure
# here counts toward the model's quarantine
_FP_QUEUE = faultpoint("engine.queue")


@dataclass
class _Pending:
    name: str
    X: np.ndarray
    y: Optional[np.ndarray]
    future: Future
    enqueued: float  # monotonic seconds at submission
    deadline: Optional[Deadline] = None
    request_id: Optional[str] = None
    trace: Optional[Any] = None  # observability.tracing.Trace, or None
    # the QoS identity admission stamped: the fair queue dequeues by class
    tenant: str = DEFAULT_TENANT
    qos_class: str = DEFAULT_CLASS


class EngineOverloaded(Exception):
    """The engine's queue is full. ``retry_after_s`` estimates the time to
    drain it, for the HTTP layer's ``Retry-After``."""

    def __init__(self, depth: int, retry_after_s: float):
        self.depth = depth
        self.retry_after_s = retry_after_s
        super().__init__(f"scoring queue full ({depth} pending); retry in ~{retry_after_s:.1f}s")


class BatchingEngine:
    """Coalesce scoring requests from many threads into batched bank calls.

    The engine records into the bank's registry; a bank built with
    ``registry=False`` makes it uninstrumented too (its histograms are
    kept, but nothing renders them). The fair queue's class weights are
    ``GORDO_QOS_WEIGHTS``'s."""

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
        self._queue = WeightedFairQueue(parse_weights(), maxsize=self.max_queue)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._batch_s = 0.0  # the last batch's scoring seconds
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "max_batch_seen": 0, "shed": 0, "deadline_expired": 0}
        self.class_stats = {c: {"requests": 0, "shed": 0, "deadline_expired": 0} for c in CLASSES}
        self.registry = registry = getattr(bank, "registry", None)
        if registry is not None:
            self.queue_wait = registry.histogram(
                "gordo_engine_queue_wait_seconds",
                "Submit -> batch-dispatch wait (what flush_ms coalescing costs)",
            ).labels()
            self.service = registry.histogram(
                "gordo_engine_service_seconds",
                "Submit -> result service time through the batching engine",
            ).labels()
            # through a weak reference: the registry must not pin a stopped
            # engine, nor through it a bank on the card
            ref = weakref.ref(self)

            def collect():
                engine = ref()
                return engine._collect_metrics() if engine is not None else ()

            registry.collector(collect, key="bank_engine")
        else:
            self.queue_wait = LatencyHistogram()
            self.service = LatencyHistogram()

    def stats_snapshot(self) -> Dict[str, int]:
        """A copy of ``stats`` from one state."""
        with self._stats_lock:
            return dict(self.stats)

    def class_stats_snapshot(self) -> Dict[str, Dict[str, int]]:
        """A copy of ``class_stats`` from one state."""
        with self._stats_lock:
            return {c: dict(cs) for c, cs in self.class_stats.items()}

    def _bump(self, key: str, qos_class: Optional[str] = None) -> None:
        """One more ``key``, and in ``qos_class``'s cell when given."""
        with self._stats_lock:
            self.stats[key] += 1
            cs = self.class_stats.get(qos_class)
            if cs is not None:
                cs[key] += 1

    def note_deadline_expired(self) -> None:
        """Count a request whose deadline ran out on a path beside the
        engine (the server's per-model path), as the engine counts its own."""
        self._bump("deadline_expired")

    def _collect_metrics(self):
        """The engine's counters and queue state, read at render time."""
        s = self.stats_snapshot()
        depths = self._queue.depths()
        per_class = []
        for cls, cs in self.class_stats_snapshot().items():
            label = {"class": cls}
            per_class += [
                ("gordo_engine_class_requests_total", "counter",
                 "Requests dispatched by the engine, by priority class", label, cs["requests"]),
                ("gordo_engine_class_shed_total", "counter", "Full-queue sheds by priority class", label,
                 cs["shed"]),
                ("gordo_engine_class_deadline_expired_total", "counter",
                 "Deadline-expiry drops by priority class", label, cs["deadline_expired"]),
                ("gordo_engine_class_queue_depth", "gauge", "Live scoring-queue depth by priority class", label,
                 depths.get(cls, 0)),
            ]
        return [
            ("gordo_engine_requests_total", "counter",
             "Requests accepted by the batching engine", {}, s["requests"]),
            ("gordo_engine_batches_total", "counter", "Coalesced batches dispatched", {}, s["batches"]),
            ("gordo_engine_shed_total", "counter",
             "Requests shed with 429 because the queue was full", {}, s["shed"]),
            ("gordo_engine_deadline_expired_total", "counter",
             "Requests whose deadline expired before device dispatch "
             "(dropped from the batch and answered 504)", {}, s["deadline_expired"]),
            ("gordo_engine_max_batch_seen", "gauge", "Largest coalesced batch observed", {},
             s["max_batch_seen"]),
            ("gordo_engine_queue_depth", "gauge", "Live scoring-queue depth", {}, self._queue.qsize()),
            ("gordo_engine_max_queue", "gauge", "Queue bound before requests shed", {}, self.max_queue),
        ] + per_class

    def qos_snapshot(self) -> dict:
        """The engine's half of ``GET .../qos``: the fair queue's state,
        the counters a class, and each banked target's feature width."""
        bank = self.bank
        buckets = bank._buckets
        widths = {name: int(buckets[key].n_features) for name, (key, _i) in list(bank._index.items())
                  if key in buckets}
        return {
            "queue": self._queue.snapshot(),
            "max_queue": self.max_queue,
            "classes": self.class_stats_snapshot(),
            "feature_widths": widths,
        }

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

    def submit(self, name: str, X: np.ndarray, y: Optional[np.ndarray] = None,
               deadline: Optional[Deadline] = None, request_id: Optional[str] = None,
               trace=None, tenant: str = DEFAULT_TENANT, qos_class: str = DEFAULT_CLASS) -> Future:
        """Queue one request; its future resolves to a :class:`ScoreResult`.
        An expired ``deadline`` raises :class:`DeadlineExceeded` here.
        ``trace`` receives the request's engine and bank spans;
        ``qos_class`` is its class in the fair queue."""
        _FP_QUEUE.fire()
        if self._thread is None:
            raise RuntimeError("engine is not running (call start() first)")
        if deadline is not None and deadline.expired():
            # queueing it would only grow the backlog by known waste
            self._bump("deadline_expired", qos_class)
            if trace is not None:
                now = time.monotonic()
                trace.add_span("deadline_expired", now, now, error=True, where="admission")
            raise DeadlineExceeded(f"deadline expired before admission (rid={request_id}, "
                                   f"budget {deadline.budget_s * 1e3:.0f}ms)")
        fut: Future = Future()
        try:
            self._queue.put_nowait(_Pending(name, X, y, fut, time.monotonic(), deadline, request_id, trace,
                                            tenant, qos_class))
        except queue.Full:
            self._bump("shed", qos_class)
            depth = self._queue.qsize()
            raise EngineOverloaded(depth, self.drain_estimate(depth)) from None
        return fut

    def score_blocking(
        self, name: str, X: np.ndarray, y: Optional[np.ndarray] = None,
        timeout: Optional[float] = None, deadline: Optional[Deadline] = None,
        request_id: Optional[str] = None, trace=None, tenant: str = DEFAULT_TENANT,
        qos_class: str = DEFAULT_CLASS,
    ) -> ScoreResult:
        """Score one request from a plain thread, blocking until its batch
        is done."""
        return self.submit(name, X, y, deadline, request_id, trace, tenant, qos_class).result(timeout)

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
            with self._stats_lock:
                self.stats["requests"] += len(batch)
                for p in batch:
                    cs = self.class_stats.get(p.qos_class)
                    if cs is not None:
                        cs["requests"] += 1
                self.stats["batches"] += 1
                self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], len(batch))
            # one clock read drops the expired entries before device work
            dispatch = time.monotonic()
            # the goodput ledger, through the bank: a swapped-in bank keeps
            # feeding the app's ledger
            bank = self.bank
            led = getattr(bank, "ledger", None)
            live: List[_Pending] = []
            batch_deadline: Optional[Deadline] = None
            for p in batch:
                self.queue_wait.record(dispatch - p.enqueued)
                if led is not None:
                    led.record_queue_wait(dispatch - p.enqueued)
                if p.deadline is not None and p.deadline.expired(dispatch):
                    self._bump("deadline_expired", p.qos_class)
                    if p.trace is not None:
                        p.trace.add_span("deadline_expired", p.enqueued, dispatch, error=True, where="queue")
                    p.future.set_exception(DeadlineExceeded(
                        f"deadline expired in scoring queue after {(dispatch - p.enqueued) * 1e3:.0f}ms "
                        f"wait (rid={p.request_id}, budget {p.deadline.budget_s * 1e3:.0f}ms)"))
                    self.service.record(dispatch - p.enqueued)
                    continue
                live.append(p)
                # the earliest deadline bounds the whole batch
                if p.deadline is not None and (batch_deadline is None
                                               or p.deadline.expires_at < batch_deadline.expires_at):
                    batch_deadline = p.deadline
            if not live:
                continue
            traced = False
            for p in live:
                if p.trace is not None:
                    traced = True
                    p.trace.add_span("queue_wait", p.enqueued, dispatch, batch=len(live))
            # the bank read once above: a swap (server/swap.py) that flips
            # self.bank meanwhile leaves this batch on the old bank
            requests = [(p.name, p.X, p.y) for p in live]
            failed: List[_Pending] = []
            try:
                if traced:
                    results: List[Any] = bank.score_many(requests, traces=[p.trace for p in live],
                                                         deadline=batch_deadline, return_exceptions=True)
                else:
                    results = bank.score_many(requests, deadline=batch_deadline, return_exceptions=True)
            except Exception:
                failed = live
            else:
                done = time.monotonic()
                for p, r in zip(live, results):
                    if isinstance(r, Exception):
                        failed.append(p)
                        continue
                    p.future.set_result(r)
                    self.service.record(done - p.enqueued)
            # a failed group's requests are scored again alone, after every
            # good result is out, so one bad request fails only itself
            for p in failed:
                self._retry_one(bank, p)
            self._batch_s = time.monotonic() - dispatch

    def _retry_one(self, bank, p: _Pending) -> None:
        """Score a request again alone after its group failed (or the
        batch's deadline cut it off), first judged against its own
        deadline. Its trace rides along unless its group recorded its
        stage spans before another group failed."""
        if p.deadline is not None and p.deadline.expired():
            self._bump("deadline_expired", p.qos_class)
            if p.trace is not None:
                p.trace.add_span("deadline_expired", p.enqueued, time.monotonic(), error=True, where="retry")
            p.future.set_exception(DeadlineExceeded(
                f"deadline expired before retry (rid={p.request_id}, "
                f"budget {p.deadline.budget_s * 1e3:.0f}ms)"))
        else:
            trace = p.trace
            if trace is not None and any(s.name == "device_execute" for s in trace.spans):
                trace = None
            try:
                result = bank.score(p.name, p.X, p.y) if trace is None else bank.score(p.name, p.X, p.y, trace)
                p.future.set_result(result)
            except Exception as exc:
                p.future.set_exception(exc)
        self.service.record(time.monotonic() - p.enqueued)
