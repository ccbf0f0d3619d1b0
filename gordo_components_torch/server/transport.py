"""The scoring core every transport shares, and the shared-memory ring's
server.

Counterpart of ``gordo_components_tpu/server/transport.py``. The HTTP
views (``views.py``) and the ring score through the same functions here:
the target's lookup (404), the quarantine gate (410), the anomaly check
(422), QoS admission (429 with its reason), the call into the batching
engine or the model's own ``predict``/``anomaly`` and the mapping of its
errors (429 for a full queue, 504 for a passed deadline, 400 for the
rest), the breaker's verdict on the answer, and the tensor answer's
encoding. An error is an :class:`HTTPError`: a status and its JSON
document, which the views send and the ring writes into its slot. So one
body gives the same bytes over TCP, a Unix socket and the ring. The views
add what only HTTP has: the request's trace, its deadline, its headers
and the goodput ledger.

A request is any object with the attributes the views' handler carries:
``qos`` (its :class:`~..qos.classify.RequestClass`), ``qos_label`` (set
by admission), ``deadline``, ``request_id``, ``trace``, and the goodput
inputs ``device_s`` and ``scores_finite`` (set here). The ring's is a
:class:`RingRequest`: its identity comes from the body's ``__meta__``
sidecar alone, so admission holds the ring to the same tenant buckets and
queue rules as HTTP, and it has no deadline, trace or request id.

:class:`ShmServer` is one poll thread over a :class:`ShmRing` and a pool
of up to 8 slot workers, which score through :func:`score_tensor_blocking`
and so through the app's one ``BatchingEngine``: ring requests coalesce
with HTTP requests into the same bank groups. Its counters
(``app.stats["shm"]``) change under ``app.stats_lock``.
"""

import json
import logging
import math
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np

from gordo_components_torch.qos.admission import QosShed
from gordo_components_torch.qos.classify import classify_meta
from gordo_components_torch.resilience.deadline import DeadlineExceeded
from gordo_components_torch.server.engine import EngineOverloaded
from gordo_components_torch.server.model_io import (
    decode_tensor_request_ex,
    encode_anomaly_response,
    encode_prediction_response,
)
from gordo_components_torch.utils.shm_ring import (
    _IDLE_SLEEP_MAX,
    _IDLE_SLEEP_MIN,
    BUSY,
    DEFAULT_SLOT_MB,
    DEFAULT_SLOTS,
    REQ,
    ShmRing,
    unpack_envelope,
)
from gordo_components_torch.utils.wire import WireFormatError

logger = logging.getLogger(__name__)


class HTTPError(Exception):
    """An answer other than 200: its status, its JSON document
    (``{"error": ..., **extra}``) and, over HTTP, extra headers."""

    def __init__(self, status: int, error: str, headers: Optional[Dict[str, str]] = None, **extra):
        super().__init__(error)
        self.status = status
        self.body = {"error": error, **extra}
        self.headers = headers or {}


class RingRequest:
    """A ring request's state: the identity of its ``__meta__`` sidecar;
    no deadline, trace or request id (the ring carries no headers)."""

    deadline = None
    request_id = None
    trace = None

    def __init__(self, qos):
        self.qos = qos
        self.qos_label: Optional[str] = None
        self.device_s = 0.0
        self.scores_finite = True


def model_entry(app, target: str):
    """(model, metadata) from one state of the collection; 404 for an
    unknown target."""
    try:
        return app.collection.entry(target)
    except KeyError:
        raise HTTPError(404, f"No such model: {target}") from None


def quarantine_gate(app, target: str, **extra) -> None:
    """410 with the recorded reason (and ``extra``) for a quarantined
    model: it exists, but the breaker took it out of routing."""
    info = app.quarantine.reason(target)
    if info is None:
        return
    raise HTTPError(410, f"Model {target!r} is quarantined", reason=info.get("reason"),
                    failures=info.get("failures"), since=info.get("since"), **extra)


def require_anomaly(model) -> None:
    if not hasattr(model, "anomaly"):
        raise HTTPError(422, "Model does not support anomaly scoring")


def decode_tensor(raw) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[Dict[str, Any]]]:
    """``decode_tensor_request_ex`` with its errors as 400 ``tensor body:
    <reason>``."""
    try:
        return decode_tensor_request_ex(raw)
    except WireFormatError as exc:
        raise HTTPError(400, f"tensor body: {exc}") from None


def engine_for(app, target: str):
    """The batching engine when the bank holds ``target``, else None: the
    per-model path."""
    bank, engine = app.bank, app.engine
    if engine is not None and bank is not None and target in bank:
        return engine
    return None


def _retry_after(seconds: float) -> Dict[str, str]:
    return {"Retry-After": str(max(1, math.ceil(seconds)))}


def qos_admit(app, req, engine) -> None:
    """Admission before the scoring call (JAX ``_qos_admit``): sets
    ``req.qos_label``, or 429 with the refusal's reason; the queue rules
    read ``engine``'s depth (none on the per-model path)."""
    depth = max_queue = 0
    drain_s = 0.05
    if engine is not None:
        max_queue = engine.max_queue
        depth = engine._queue.qsize()
        drain_s = engine.drain_estimate(depth)
    try:
        req.qos_label = app.admission.admit(req.qos, queue_depth=depth, max_queue=max_queue, drain_s=drain_s)
    except QosShed as exc:
        raise HTTPError(429, str(exc), headers=_retry_after(exc.retry_after_s), reason=exc.reason,
                        tenant=exc.tenant, **{"class": exc.qos_class},
                        retry_after_s=round(exc.retry_after_s, 2)) from None


def record_failure(app, target: str, reason: str) -> None:
    """A scoring failure against the breaker; ``quarantine.enter`` on the
    app's event log when it takes the model out of routing."""
    if app.quarantine.record_failure(target, reason):
        app.events.emit("quarantine.enter", severity="error", generation=app.generation(), target=target,
                        reason=reason)


def note_result(app, req, target: str, X: np.ndarray, values) -> None:
    """A finite answer resets ``target``'s streak; a non-finite one for
    finite input counts as a failure (non-finite input is the client's
    data, not the model's fault), and as wasted work in the ledger."""
    if np.all(np.isfinite(values)):
        app.quarantine.record_success(target)
    elif np.all(np.isfinite(X)):
        req.scores_finite = False
        record_failure(app, target, "non-finite scores in model output")


def _check_deadline_per_model(app, req) -> None:
    """The per-model path's deadline, checked before its scoring; an
    expiry counts in the engine's ``deadline_expired`` when there is an
    engine, as the JAX server counts it."""
    if req.deadline is not None and req.deadline.expired():
        if app.engine is not None:
            app.engine.note_deadline_expired()
        if req.trace is not None:
            now = time.monotonic()
            req.trace.add_span("deadline_expired", now, now, error=True, where="per-model")
        raise DeadlineExceeded("deadline expired before dispatch")


def run_scoring(app, req, target: str, bank_call, model_call):
    """Admission, then ``bank_call(engine)`` on the bank path or
    ``model_call()`` on the per-model path, their errors mapped as the JAX
    handlers map them: 429 for a full queue, 504 for a passed deadline,
    400 for the rest, which counts against the breaker unless it is a bad
    request's. The per-model call's time is the request's device seconds
    and its ``device_execute`` span."""
    engine = engine_for(app, target)
    qos_admit(app, req, engine)
    try:
        if engine is not None:
            return bank_call(engine)
        _check_deadline_per_model(app, req)
        t0 = time.monotonic()
        out = model_call()
        req.device_s = time.monotonic() - t0
        if req.trace is not None:
            req.trace.add_span("device_execute", t0, t0 + req.device_s, path="per-model")
        return out
    except EngineOverloaded as exc:
        raise HTTPError(429, str(exc), headers=_retry_after(exc.retry_after_s), reason="engine_overloaded",
                        retry_after_s=round(exc.retry_after_s, 2)) from None
    except DeadlineExceeded as exc:
        # the clock ran out, the model is sound: the breaker counts none
        raise HTTPError(504, str(exc)) from None
    except Exception as exc:
        if not isinstance(exc, (ValueError, KeyError)):
            record_failure(app, target, f"{type(exc).__name__}: {exc}")
        logger.exception("scoring %r failed", target)
        raise HTTPError(400, f"{type(exc).__name__}: {exc}") from None


def _score_bank(engine, req, target: str, X, y):
    result = engine.score_blocking(target, X, y, deadline=req.deadline, request_id=req.request_id,
                                   trace=req.trace, tenant=req.qos_label, qos_class=req.qos.qos_class)
    req.device_s = result.device_s
    return result


def score_prediction(app, req, target: str, model, X: np.ndarray, y: Optional[np.ndarray]) -> np.ndarray:
    """``target``'s reconstruction of ``X``, with the breaker's verdict."""
    out = run_scoring(app, req, target, lambda engine: _score_bank(engine, req, target, X, y).model_output,
                      lambda: model.predict(X))
    note_result(app, req, target, X, out)
    return out


def score_anomaly(app, req, target: str, model, X: np.ndarray, y: Optional[np.ndarray], wire: bool = False):
    """``(tags, arrays, offset, output_tags, body)`` of ``target``'s
    anomaly scores of ``X``, with the breaker's verdict; ``body`` is the
    tensor answer when ``wire``, else None. The bank path's
    ``postprocess`` span is ``to_wire`` (the arrays and the body) or
    ``to_arrays``."""

    def banked(engine):
        result = _score_bank(engine, req, target, X, y)
        t0 = time.monotonic()
        arrays = result.to_arrays()
        body = encode_anomaly_response(result.tags, arrays, result.offset) if wire else None
        if req.trace is not None:
            req.trace.add_span("postprocess", t0, time.monotonic(), stage="to_wire" if wire else "to_arrays")
        return result.tags, arrays, result.offset, None, body

    def per_model():
        arrays = model.anomaly(X, y)
        return model.tags_, arrays, len(X) - len(arrays["model-output"]), getattr(model, "output_tags", None), None

    tags, arrays, offset, output_tags, body = run_scoring(app, req, target, banked, per_model)
    if wire and body is None:
        body = encode_anomaly_response(tags, arrays, offset)
    # a NaN anywhere in the reconstruction reaches the totals (the
    # kernel's row norms), so they are an O(rows) proxy of the answer
    note_result(app, req, target, X, arrays["total-anomaly-scaled"])
    return tags, arrays, offset, output_tags, body


def _error_bytes(status: int, body: dict) -> Tuple[int, bytes]:
    return status, json.dumps(body).encode()


def score_tensor_blocking(app, target: str, raw, endpoint: str = "anomaly") -> Tuple[int, bytes]:
    """Score one ``GTNS`` body as the HTTP tensor path does, from a plain
    thread: ``(status, answer bytes)``, a 200's the views' tensor body, an
    error's its JSON document (404 unknown target, 410 quarantined with
    the reason, 422 no ``anomaly``, 400 malformed body or model error, 429
    admission or a full queue, 504 a passed deadline). ``raw`` may be a
    view of a ring slot: the rows are ``np.frombuffer`` views of it, and
    everything that reads them (the scoring, the breaker's verdict, the
    answer's packing) is done before this returns."""
    try:
        model, _ = model_entry(app, target)
        quarantine_gate(app, target)
        if endpoint == "anomaly":
            require_anomaly(model)
        X, y, meta = decode_tensor(raw)
        req = RingRequest(classify_meta(meta))
        if endpoint == "anomaly":
            return 200, score_anomaly(app, req, target, model, X, y, wire=True)[4]
        out = score_prediction(app, req, target, model, X, y)
        return 200, encode_prediction_response(out, len(X))
    except HTTPError as exc:
        return _error_bytes(exc.status, exc.body)


class ShmServer:
    """The server end of the scoring ring: one poll thread marks ``REQ``
    slots ``BUSY`` and hands each to a pool worker, which parses it off
    the mapped segment, scores it through :func:`score_tensor_blocking`
    and answers in place. The counters (requests, errors, bytes in and
    out) are ``app.stats["shm"]``, read by ``/stats`` and
    ``gordo_shm_*_total``."""

    def __init__(self, app, ring: ShmRing):
        self.app = app
        self.ring = ring
        self.stats = {"requests": 0, "errors": 0, "bytes_in": 0, "bytes_out": 0}
        with app.stats_lock:
            app.stats["shm"] = self.stats
        self._stop = threading.Event()
        # slots served concurrently: their requests reach the engine together
        # and coalesce, where a serial loop would dispatch one a round trip
        self._pool = ThreadPoolExecutor(max_workers=max(1, min(ring.slots, 8)),
                                        thread_name_prefix="gordo-shm-worker")
        self._thread = threading.Thread(target=self._run, name="gordo-shm-server", daemon=True)
        self._thread.start()

    @classmethod
    def create(cls, app, name: str) -> "ShmServer":
        """Map a new ring ``name`` of ``GORDO_SHM_SLOTS`` slots of
        ``GORDO_SHM_SLOT_MB`` MB, advertise it in ``app.transports`` and
        serve it."""
        ring = ShmRing.create(name, slots=int(os.environ.get("GORDO_SHM_SLOTS", DEFAULT_SLOTS)),
                              slot_mb=float(os.environ.get("GORDO_SHM_SLOT_MB", DEFAULT_SLOT_MB)))
        app.transports["shm"] = name
        return cls(app, ring)

    def _run(self) -> None:
        sleep = _IDLE_SLEEP_MIN
        while not self._stop.is_set():
            dispatched = 0
            for i in range(self.ring.slots):
                if self.ring.closed or self._stop.is_set():
                    return
                if self.ring.state(i) != REQ:
                    continue
                self.ring.set_state(i, BUSY)
                dispatched += 1
                self._pool.submit(self._serve_slot, i)
            if dispatched:
                sleep = _IDLE_SLEEP_MIN
            else:
                time.sleep(sleep)
                sleep = min(sleep * 2, _IDLE_SLEEP_MAX)

    def _serve_slot(self, i: int) -> None:
        n_in = 0
        try:
            target, endpoint, body = unpack_envelope(self.ring.request_view(i))
            n_in = len(body)
            status, resp = score_tensor_blocking(self.app, target, body, endpoint)
        except Exception as exc:
            status, resp = _error_bytes(400, {"error": f"{type(exc).__name__}: {exc}"})
        # the request's views of the slot end here, before the answer
        # overwrites it
        body = None
        with self.app.stats_lock:
            self.stats["requests"] += 1
            self.stats["bytes_in"] += n_in
            if status >= 400:
                self.stats["errors"] += 1
            self.stats["bytes_out"] += len(resp)
        try:
            self.ring.write_response(i, status, resp)
        except Exception:
            logger.exception("failed to answer shm slot %d", i)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(10.0)
        self._pool.shutdown(wait=True)
        self.ring.close()


__all__ = [
    "HTTPError", "RingRequest", "ShmServer", "engine_for", "model_entry", "note_result", "qos_admit",
    "quarantine_gate", "record_failure", "require_anomaly", "run_scoring", "score_anomaly",
    "score_prediction", "score_tensor_blocking",
]
