"""HTTP routes of the port's server, on the standard library's http.server.

Counterpart of these routes of ``gordo_components_tpu/server/views.py``:

- ``GET  /healthz`` and ``/gordo/v0/<project>/healthz``
- ``GET  /gordo/v0/<project>/ready``
- ``GET  /gordo/v0/<project>/models``
- ``GET  /gordo/v0/<project>/metadata-all`` (``?digest=1``)
- ``GET  /gordo/v0/<project>/stats``
- ``GET  /gordo/v0/<project>/metrics``
- ``GET  /gordo/v0/<project>/quarantine``
- ``GET  /gordo/v0/<project>/traces`` (``?id=``, ``?n=``, ``?format=chrome``)
- ``GET  /gordo/v0/<project>/traces/slow`` (``?n=``, ``?format=chrome``)
- ``GET  /gordo/v0/<project>/slo`` (``?refresh=1``)
- ``GET  /gordo/v0/<project>/costs`` (``?refresh=1``)
- ``GET  /gordo/v0/<project>/qos``
- ``GET  /gordo/v0/<project>/heat`` (``?refresh=1``, ``?top=``)
- ``GET  /gordo/v0/<project>/history`` (``?series=``, ``since``, ``until``, ``step``)
- ``GET  /gordo/v0/<project>/events`` (``?since=``, ``since_wall``, ``type``, ``limit``)
- ``GET  /gordo/v0/<project>/drift`` (``?refresh=1``)
- ``POST /gordo/v0/<project>/quarantine/clear``
- ``POST /gordo/v0/<project>/reload``
- ``GET  /gordo/v0/<project>/placement`` (``?dry_run=1``)
- ``POST /gordo/v0/<project>/rebalance`` (``?dry_run=1``, body ``{"force": true}``)
- ``GET  /gordo/v0/<project>/mesh``
- ``GET  /gordo/v0/<project>/mesh/member/<target>/artifact``
- ``POST /gordo/v0/<project>/mesh/acquire`` (body ``{"member", "source"}``)
- ``POST /gordo/v0/<project>/mesh/release`` (body ``{"member"}``)
- ``POST /gordo/v0/<project>/adapt``
- ``GET  /gordo/v0/<project>/<target>/healthcheck``
- ``GET  /gordo/v0/<project>/<target>/metadata``
- ``GET  /gordo/v0/<project>/<target>/download-model``
- ``POST /gordo/v0/<project>/<target>/prediction``
- ``POST /gordo/v0/<project>/<target>/anomaly/prediction``
- ``POST /gordo/v0/<project>/<target>/ingest``
- ``GET  /gordo/v0/<project>/<target>/results/stream`` (``?subscriber=``, ``?timeout=``)

The streaming routes (``streaming/``, ``GORDO_STREAM=1``) answer as the JAX
server's: ``/ingest`` takes a JSON body (``rows`` with ``null`` cells for
dropout, ``timestamps`` in epoch seconds or ISO 8601, which the port reads
with ``dataset/times.to_ns`` where the JAX server asks pandas) or a tensor
body (a float32 ``rows`` frame, optional float64 ``timestamps``);
``/drift`` is ``{"enabled": false}`` without the plane; ``/adapt``
recalibrates or refits (500 with ``rolled_back`` when it fails); the
long poll of ``/results/stream`` waits on its handler thread for the push
broker (429 with ``Retry-After`` when the subscriber table is full).
Without the plane ``/ingest``, ``/adapt`` and ``/results/stream`` answer
404 naming ``GORDO_STREAM=0``, and without the broker
``/results/stream`` answers 404 naming ``GORDO_PUSH=0``. Ingest POSTs
count in the wire's encodings as scoring POSTs do.

Bodies match the JAX server's JSON. A scoring POST is JSON, a tensor
body when its content type contains ``application/x-gordo-tensor``, or
parquet when it contains ``parquet`` (the JAX server's rule,
``utils/wire.encoding_of``; parquet is read by the port's own reader,
``server/utils.extract_x_y_parquet``), and ``/models`` lists the three in
``accepts``, in the JAX order. A tensor POST (``utils/wire.py``) is
answered in tensor: its rows are ``np.frombuffer`` views of the body, its
``__meta__`` sidecar's ``tenant`` and ``priority`` override the headers'
before admission, and the answer is ``__meta__`` (``offset``, and for an
anomaly ``tags``) and the score arrays, framed into one body. A model the
bank holds is scored through the batching engine; any other (a bare
``Pipeline`` or estimator, or every model when the bank is off) through
its own ``predict``/``anomaly``: the per-model path. Both go through the
scoring core the shared-memory ring shares (``transport.py``).
``download-model`` answers the model's artifact directory as a gzipped
tar (``serializer.dumps``), where the JAX server answers a pickle.
``metadata-all?digest=1`` answers gzip to a client whose
``Accept-Encoding`` allows it. ``/models`` and ``/stats`` name the local
transports (``transports``: ``uds``, ``shm``) when any is armed, and
``/stats`` counts the requests of each worker of a pool (``workers``,
``workers.py``) and the ring's (``shm``).

What the JAX server's middleware does, ``_dispatch`` does for every
request: it counts requests by kind (the last segment of the matched
route's template, ``anomaly`` for ``.../anomaly/prediction``, ``other``
when nothing matched), errors (every status of 400 or more) and scoring
POSTs and their bytes by encoding, records the latency per kind, echoes
the client's ``X-Gordo-Request-Id`` (or a server-made ``srv-<hex>``) and
``X-Request-Id`` on every response, and reads the request's deadline
from ``X-Gordo-Deadline-Ms`` or the app's default. With a tracer it opens
the request's trace (continuing an incoming ``traceparent``), answers
``X-Request-Id`` as the trace id and echoes ``traceparent``, and once the
trace is retained names it as the exemplar of the latency bucket the
request landed in; the trace rides the engine's queue and collects the
``parse``, ``queue_wait``, ``coalesce``, ``pad``, ``device_execute`` and
``postprocess`` spans (the per-model path's ``device_execute`` spans the
model's own call). A scoring request's outcome goes to the goodput ledger
with its device seconds: a 504 counts as expired, a 200 with non-finite
scores for finite input as wasted.

QoS, as in the JAX handlers: every scoring POST carries a tenant and a
priority class (``X-Gordo-Tenant``, ``X-Gordo-Priority``; ``qos/``). After
its body parses and before its scoring, the admission controller admits
it or refuses it with a 429, its reason (``tenant_rate``,
``queue_pressure``, ``goodput_burn``) and ``Retry-After``; the queue rules
read the engine's depth, so a per-model target meets the tenant rate
alone. An admitted banked request enters the engine's fair queue under
its class, and the goodput ledger books it under admission's bounded
tenant label.

The placement routes answer as the JAX server's: ``/placement`` is
``{"enabled": false}`` with the bank off, ``/rebalance`` 404 then, and a
rebalance whose swap fails answers 500 with ``rolled_back`` (the old
generation serving). The mesh routes move members between replicas of the
serving mesh through the swap ``/reload`` uses: an acquire (with
``source``, the artifact shipped from that replica's ``.../artifact``
first) runs before the source's release, is idempotent, and rolls its
ownership back when its swap fails; a release of a member not served here
answers 404 with the reason. A mesh body's member must be a plain
directory name.

Events: a quarantine's enter and clear, a ``/reload``, a rebalance
(``rebalance.plan`` or ``rebalance.applied``) and a mesh acquire or release
go to the app's event log (``observability/events.py``), stamped with the bank's
generation; the swap itself emits ``bank.swap`` (``swap.py``).

The quarantine breaker (``resilience/quarantine.py``) reads every scoring
answer: a non-finite output (the ``total-anomaly-scaled`` column of an
anomaly answer, which the anomaly-score kernel computes) for finite input
counts as a failure, and so does an exception other than a bad request's
or a deadline's. A quarantined model answers 410 before its body is read.

Errors: 400 for a bad body or a request the model cannot score, 404 for an
unknown target or route, 405 for a route's other method, 410 for a
quarantined model, 422 for an anomaly request to a model without
``anomaly``, 429 with ``Retry-After`` when admission refuses a request or
the engine's queue is full, 504
when the request's deadline passed before its scoring, 503 from
``/healthz`` and ``/ready`` when nothing is served. A 5xx body carries the
request id.
"""

import gzip
import itertools
import json
import logging
import math
import os
import re
import socket
import socketserver
import stat
import struct
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, NamedTuple, Optional
from urllib.parse import parse_qs

import numpy as np

from gordo_components_torch import __version__, serializer
from gordo_components_torch.observability.metrics import _fmt
from gordo_components_torch.observability.tracing import chrome_trace, format_traceparent
from gordo_components_torch.qos.classify import classify_headers, classify_meta
from gordo_components_torch.resilience.deadline import DEADLINE_HEADER, Deadline, parse_deadline_ms
from gordo_components_torch.resilience.faults import faultpoint
from gordo_components_torch.server.model_io import (
    encode_prediction_response,
    pack_artifact_dir,
    scan_artifacts,
    unpack_artifact_dir,
)
from gordo_components_torch.server.stats import LatencyHistogram
from gordo_components_torch.server.swap import swap_collection_bank
from gordo_components_torch.server.transport import (
    HTTPError,
    decode_tensor,
    model_entry,
    quarantine_gate,
    require_anomaly,
    score_anomaly,
    score_prediction,
)
from gordo_components_torch.server.utils import (
    anomaly_body,
    extract_x_y,
    extract_x_y_parquet,
    prediction_body,
)
from gordo_components_torch.utils.digest import metadata_digest
from gordo_components_torch.dataset.times import to_ns
from gordo_components_torch.utils.wire import (
    TENSOR_CONTENT_TYPE,
    WireFormatError,
    encoding_of,
    rows_as_f32,
    unpack_frames,
)

logger = logging.getLogger(__name__)

# transport chaos: armed with refuse/reset/blackhole, the connection dies
# before the request is read or answered, as a real peer failure would
_FP_CONNECTION = faultpoint("server.connection")

_P = r"^/gordo/v0/(?P<project>[^/]+)"
_T = _P + r"/(?P<target>[^/]+)"
_ROUTES = [
    ("GET", re.compile(r"^/healthz$"), "healthz"),
    ("GET", re.compile(_P + r"/healthz$"), "healthz"),
    ("GET", re.compile(_P + r"/ready$"), "ready"),
    ("GET", re.compile(_P + r"/models$"), "list_models"),
    ("GET", re.compile(_P + r"/metadata-all$"), "metadata_all"),
    ("GET", re.compile(_P + r"/stats$"), "server_stats"),
    ("GET", re.compile(_P + r"/metrics$"), "metrics"),
    ("GET", re.compile(_P + r"/quarantine$"), "quarantine_list"),
    ("GET", re.compile(_P + r"/traces$"), "traces_recent"),
    ("GET", re.compile(_P + r"/traces/slow$"), "traces_slow"),
    ("GET", re.compile(_P + r"/slo$"), "slo_view"),
    ("GET", re.compile(_P + r"/costs$"), "costs_view"),
    ("GET", re.compile(_P + r"/qos$"), "qos_view"),
    ("GET", re.compile(_P + r"/heat$"), "heat_view"),
    ("GET", re.compile(_P + r"/history$"), "history_view"),
    ("GET", re.compile(_P + r"/events$"), "events_view"),
    ("GET", re.compile(_P + r"/drift$"), "drift_view"),
    ("POST", re.compile(_P + r"/quarantine/clear$"), "quarantine_clear"),
    ("POST", re.compile(_P + r"/reload$"), "reload"),
    ("POST", re.compile(_P + r"/adapt$"), "adapt"),
    ("GET", re.compile(_P + r"/placement$"), "placement_view"),
    ("POST", re.compile(_P + r"/rebalance$"), "rebalance"),
    ("GET", re.compile(_P + r"/mesh$"), "mesh_view"),
    ("GET", re.compile(_P + r"/mesh/member/(?P<target>[^/]+)/artifact$"), "mesh_member_artifact"),
    ("POST", re.compile(_P + r"/mesh/acquire$"), "mesh_acquire"),
    ("POST", re.compile(_P + r"/mesh/release$"), "mesh_release"),
    ("GET", re.compile(_T + r"/healthcheck$"), "healthcheck"),
    ("GET", re.compile(_T + r"/metadata$"), "metadata"),
    ("GET", re.compile(_T + r"/download-model$"), "download_model"),
    ("POST", re.compile(_T + r"/prediction$"), "prediction"),
    ("POST", re.compile(_T + r"/anomaly/prediction$"), "anomaly_prediction"),
    ("POST", re.compile(_T + r"/ingest$"), "ingest"),
    ("GET", re.compile(_T + r"/results/stream$"), "results_stream"),
]


def _kind(pattern: "re.Pattern") -> str:
    """A route's request kind, as the JAX middleware names it from the
    route's template: its last segment, ``anomaly`` for
    ``.../anomaly/prediction``."""
    template = pattern.pattern.rstrip("$")
    return "anomaly" if template.endswith("/anomaly/prediction") else template.rsplit("/", 1)[-1]


_KINDS = {handler: _kind(pattern) for _method, pattern, handler in _ROUTES}
_SCORING = ("prediction", "anomaly")
# POSTs whose bodies count in the wire's encodings (JAX middleware)
_WIRE = _SCORING + ("ingest",)
_TRUE = ("1", "true", "yes")
ACCEPTS = ["application/json", TENSOR_CONTENT_TYPE, "application/x-parquet"]
METRICS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
# server-made request ids, unique in the process
_RID_SEQ = itertools.count(1)


class Raw(NamedTuple):
    """A body sent as it is, with its content type and extra headers."""

    data: bytes
    content_type: str
    headers: Dict[str, str] = {}


def _content_length(headers) -> int:
    """The body's declared length; 0 for none or a malformed one (a body
    that then does not parse)."""
    try:
        return max(0, int(headers.get("Content-Length") or 0))
    except ValueError:
        return 0


def _accepts_gzip(accept_encoding: Optional[str]) -> bool:
    """Whether an ``Accept-Encoding`` value allows gzip (not at ``q=0``)."""
    for token in (accept_encoding or "").split(","):
        coding, _, params = token.strip().partition(";")
        if coding.strip().lower() in ("gzip", "*"):
            return params.replace(" ", "") not in ("q=0", "q=0.0", "q=0.00", "q=0.000")
    return False


class GordoHandler(BaseHTTPRequestHandler):
    """One request; ``self.server.app`` is the :class:`~.App` it serves."""

    server_version = f"gordo-components-torch/{__version__}"

    def log_message(self, fmt, *args):
        # a Unix-socket peer has no address: its client_address is ''
        peer = self.client_address[0] if isinstance(self.client_address, tuple) else "unix"
        logger.debug("%s " + fmt, peer, *args)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def _route(self, method: str, path: str):
        """(handler, its arguments, kind) of the route ``path`` matches;
        (None, the HTTPError, "other") when none does for ``method``."""
        for route_method, pattern, handler in _ROUTES:
            match = pattern.match(path)
            if match is None:
                continue
            if route_method != method:
                return None, HTTPError(405, f"{method} not allowed on {path}"), "other"
            return handler, match.groupdict(), _KINDS[handler]
        return None, HTTPError(404, f"No route for {path}"), "other"

    def _abort(self, exc: BaseException) -> None:
        """Drop the connection without an answer, the body unread: a
        ``reset`` closes with ``SO_LINGER`` 0, so the peer sees an RST; any
        other fault (``refuse``, ``blackhole`` after its sleep, an error)
        closes it."""
        self.close_connection = True
        if isinstance(exc, ConnectionResetError):
            try:
                self.connection.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
            except OSError:
                pass
        try:
            self.connection.close()  # closes once the handler's files are closed too
        except OSError:
            pass
        logger.warning("server.connection fault: connection dropped (%s)", type(exc).__name__)

    def _dispatch(self, method: str) -> None:
        try:
            _FP_CONNECTION.fire()
        except Exception as exc:
            self._abort(exc)
            return
        path, _, query = self.path.partition("?")
        self.query = parse_qs(query)
        # the body's bytes no handler has read yet
        self.unread = _content_length(self.headers)
        app = self.app
        handler, args, kind = self._route(method, path)
        # bounded: a hostile header must not become an unbounded log line
        rid = (self.headers.get("X-Gordo-Request-Id") or "")[:128] or f"srv-{next(_RID_SEQ):x}"
        self.request_id = rid
        raw_deadline = self.headers.get(DEADLINE_HEADER)
        deadline_ms = parse_deadline_ms(raw_deadline) if raw_deadline else None
        if deadline_ms is None:
            deadline_ms = app.default_deadline_ms
        self.deadline = Deadline.after_ms(deadline_ms) if deadline_ms else None
        worker = self.server.worker
        with app.stats_lock:
            stats = app.stats
            stats["requests"][kind] = stats["requests"].get(kind, 0) + 1
            if worker is not None:
                stats["workers"][worker] = stats["workers"].get(worker, 0) + 1
            if method == "POST" and kind in _WIRE:
                enc = encoding_of(self.headers.get("Content-Type"))
                wire = stats["wire"]
                wire["requests"][enc] = wire["requests"].get(enc, 0) + 1
                wire["bytes"][enc] = wire["bytes"].get(enc, 0) + _content_length(self.headers)
            hist = stats["latency"].get(kind)
            if hist is None:
                hist = stats["latency"][kind] = LatencyHistogram()
        # the scoring path's goodput inputs, set by the handlers; the QoS
        # identity, and the tenant label admission gives it
        self.device_s, self.scores_finite = 0.0, True
        self.qos, self.qos_label = classify_headers(self.headers), None
        self.trace = None
        if app.tracer is not None:
            self.trace = app.tracer.start_trace(kind, traceparent=self.headers.get("traceparent"), request_id=rid)
        t0 = time.monotonic()
        headers: Dict[str, str] = {}
        try:
            if handler is None:
                raise args
            status, body = getattr(self, handler)(**args)
        except HTTPError as exc:
            status, body, headers = exc.status, exc.body, exc.headers
            if status >= 500:
                body = {**body, "request_id": rid}
        except Exception:
            logger.exception("unhandled error serving %s %s (rid=%s)", method, path, rid)
            status, body = 500, {"error": "internal server error", "request_id": rid}
        # errored requests count too: a timeout-then-500 pattern is what a
        # tail-latency histogram exists to show
        elapsed = time.monotonic() - t0
        hist.record(elapsed)
        if kind in _SCORING and app.ledger is not None:
            # the bounded label: admission's, or derived as it derives it
            qos, label = self.qos, self.qos_label
            if label is None:
                label = qos.label_tenant(app.admission.known_tenants)
            app.ledger.finish_request(status=status, elapsed_s=elapsed, device_s=self.device_s,
                                      scores_finite=self.scores_finite, tenant=label, qos_class=qos.qos_class)
        trace = self.trace
        if trace is not None:
            trace.finish(error=status >= 400, status=status)
            # only a retained trace publishes an exemplar: a head-sample
            # drop must not leave an id /traces cannot resolve
            if trace.retained:
                with app.stats_lock:
                    app.stats["exemplars"].setdefault(kind, {})[_fmt(hist.bucket_le(elapsed))] = {
                        "trace_id": trace.trace_id, "value_ms": round(elapsed * 1e3, 3), "at": round(time.time(), 3)}
        if status >= 400:
            with app.stats_lock:
                app.stats["errors"] += 1
        headers = {**headers, "X-Gordo-Request-Id": rid,
                   "X-Request-Id": trace.trace_id if trace is not None else rid}
        if trace is not None:
            headers["traceparent"] = format_traceparent(trace.trace_id, trace.root.span_id)
        if self.unread:
            # a body left in the socket makes the close a reset, which can
            # discard the answer before the client reads it
            self._read_body()
        self._send(status, body, headers)

    def _send(self, status: int, body: Any, headers: Optional[Dict[str, str]] = None) -> None:
        if isinstance(body, Raw):
            raw, content_type, headers = body.data, body.content_type, {**body.headers, **(headers or {})}
        else:
            raw, content_type = json.dumps(body).encode(), "application/json"
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(raw)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(raw)

    # ----------------------------- helpers ----------------------------- #

    @property
    def app(self):
        return self.server.app

    def _entry(self, target: str):
        """(model, metadata) from one state of the collection."""
        return model_entry(self.app, target)

    def _read_body(self) -> bytes:
        n, self.unread = self.unread, 0
        return self.rfile.read(n)

    def _parse(self):
        """(X, y, index) of a scoring POST body, and its encoding in
        ``self.encoding``; 400 for one that does not parse. A tensor body
        has no index (None), and its ``__meta__`` sidecar overrides the
        headers' QoS identity. A traced request gets its ``parse`` span."""
        t_parse = time.monotonic()
        encoding = self.encoding = encoding_of(self.headers.get("Content-Type"))
        raw = self._read_body()
        try:
            if encoding == "tensor":
                X, y, meta = decode_tensor(raw)
                if meta:
                    self.qos = classify_meta(meta, self.qos)
                return X, y, None
            if encoding == "parquet":
                try:
                    return extract_x_y_parquet(raw)
                except (ValueError, NotImplementedError) as exc:
                    raise HTTPError(400, f"{type(exc).__name__}: {exc}") from None
            try:
                body = json.loads(raw)
            except ValueError:
                raise HTTPError(400, "Expected JSON body with an X entry") from None
            try:
                return extract_x_y(body)
            except ValueError as exc:
                raise HTTPError(400, str(exc)) from None
        finally:
            if self.trace is not None:
                self.trace.add_span("parse", t_parse, time.monotonic(), encoding=encoding)

    def _emit(self, etype: str, severity: str = "info", **attrs) -> None:
        """A state change on the app's event log, at the bank's generation."""
        app = self.app
        app.events.emit(etype, severity=severity, generation=app.generation(), **attrs)

    def _quarantine_gate(self, project: str, target: str) -> None:
        quarantine_gate(self.app, target, clear=f"POST /gordo/v0/{project}/quarantine/clear")

    def _coverage(self, names) -> Optional[Dict[str, Any]]:
        """Which models score through the bank and which on the per-model
        path, and why (JAX ``_bank_coverage``); None when the bank is off."""
        bank = self.app.bank
        if bank is None:
            return None
        cov = bank.coverage()
        return {
            "banked": sorted(n for n in names if n in bank),
            "fallback": {n: cov["fallback"].get(n, "not bankable") for n in names if n not in bank},
            "n_buckets": cov["n_buckets"],
            "devices": cov["devices"],
        }

    # ----------------------------- routes ------------------------------ #

    def healthz(self, project: Optional[str] = None):
        """``ok``, ``degraded`` (200: a model is quarantined, an artifact
        failed to load, or a bank bucket failed to build) or ``unhealthy``
        (503: nothing is served), and why."""
        collection, bank = self.app.collection, self.app.bank
        models = len(collection.models)
        load_failures = dict(collection.load_failures)
        quarantined = self.app.quarantine.snapshot()["quarantined"]
        finalize_failures = dict(bank.finalize_failures) if bank is not None else {}
        if models == 0:
            status, http = "unhealthy", 503
        elif quarantined or load_failures or finalize_failures:
            status, http = "degraded", 200
        else:
            status, http = "ok", 200
        return http, {
            "status": status,
            "models": models,
            "quarantined": quarantined,
            "load_failures": load_failures,
            "bank_finalize_failures": finalize_failures,
        }

    def ready(self, project: str):
        n = len(self.app.collection.models)
        return (200 if n else 503), {"ready": n > 0, "models": n}

    def list_models(self, project: str):
        body = {
            "project": project,
            "models": self.app.collection.names(),
            "accepts": list(ACCEPTS),
        }
        if self.app.transports:
            body["transports"] = dict(self.app.transports)
        bank = self._coverage(body["models"])
        if bank is not None:
            body["bank"] = bank
        return 200, body

    def metadata_all(self, project: str):
        want_digest = self.query.get("digest", [""])[-1].lower() in _TRUE
        models, metadata = self.app.collection.snapshot()
        names = sorted(models)
        targets = {}
        for name in names:
            entry: Dict[str, Any] = {"healthy": True}
            meta = metadata.get(name)
            if meta is not None:
                if want_digest:
                    entry["digest"] = metadata_digest(meta)
                else:
                    entry["endpoint-metadata"] = meta
            targets[name] = entry
        body = {"project": project, "targets": targets}
        bank = self._coverage(names)
        if bank is not None:
            body["bank"] = bank
        if want_digest and _accepts_gzip(self.headers.get("Accept-Encoding")):
            # the digest body only, as the JAX server: it is small and
            # repetitive, and a full body's compression would hold the thread
            return 200, Raw(gzip.compress(json.dumps(body).encode()), "application/json",
                            {"Content-Encoding": "gzip"})
        return 200, body

    def server_stats(self, project: str):
        """Request counters by kind, errors, latency percentiles and their
        exemplar traces, the wire by encoding, the engine's coalescing (and
        its counters a class), the bank's pipeline, the breaker, the
        goodput ledger, the SLO, heat and cost snapshots (the same caches
        ``/slo``, ``/heat`` and ``/costs`` serve) and the
        registry's JSON view (JAX ``server_stats``, with the keys the port
        fills)."""
        app = self.app
        with app.stats_lock:
            stats = app.stats
            body: Dict[str, Any] = {
                "uptime_seconds": round(time.time() - stats["started_at"], 1),
                "requests": dict(stats["requests"]),
                "errors": int(stats["errors"]),
            }
            latency = dict(stats["latency"])
            wire = {"requests": dict(stats["wire"]["requests"]), "bytes": dict(stats["wire"]["bytes"])}
            exemplars = {kind: dict(edges) for kind, edges in stats["exemplars"].items()}
            workers = dict(stats["workers"])
            shm = dict(stats["shm"]) if "shm" in stats else None
        collection = app.collection
        body["models"] = len(collection.models)
        body["latency"] = {kind: hist.snapshot() for kind, hist in latency.items()}
        body["exemplars"] = exemplars
        body["wire"] = wire
        body["workers"] = workers  # requests a worker of a pool; empty outside one
        if shm is not None:
            body["shm"] = shm
        if app.transports:
            body["transports"] = dict(app.transports)
        engine = app.engine
        if engine is not None:
            es: Dict[str, Any] = engine.stats_snapshot()
            if es["batches"]:
                es["avg_batch"] = round(es["requests"] / es["batches"], 2)
            es["queue_wait"] = engine.queue_wait.snapshot()
            es["service"] = engine.service.snapshot()
            es["max_queue"] = engine.max_queue
            es["queue_depth"] = engine._queue.qsize()
            es["by_class"] = engine.class_stats_snapshot()
            body["bank_engine"] = es
        bank = app.bank
        if bank is not None:
            body["bank_models"] = len(bank)
            body["bank_pipeline"] = bank.pipeline_stats()
            body["bank_capacity"] = bank.capacity_stats()
        body["quarantine"] = app.quarantine.snapshot()
        if app.ledger is not None:
            body["goodput"] = app.ledger.snapshot()
        if app.slo is not None:
            body["slo"] = app.slo.snapshot()
        if app.heat is not None:
            body["heat"] = app.heat.snapshot()
        if app.cost is not None:
            body["costs"] = app.cost.snapshot()
        body["load_failures"] = {"current": dict(collection.load_failures),
                                 "total": collection.load_failed_total}
        body["metrics"] = app.metrics.snapshot()
        return 200, body

    def metrics(self, project: str):
        """The app's registry as Prometheus text."""
        return 200, Raw(self.app.metrics.render().encode("utf-8"), METRICS_CONTENT_TYPE)

    def _tracer(self):
        tracer = self.app.tracer
        return tracer if tracer is not None and tracer.enabled else None

    def _query_n(self, default: str):
        """``?n=`` as a non-negative int (0: unbounded), else 400."""
        try:
            n = int(self.query.get("n", [default])[-1])
        except ValueError:
            n = -1
        if n < 0:
            raise HTTPError(400, "n must be a non-negative integer")
        return n or None

    def _traces(self, traces):
        """``?format=chrome``: Chrome trace events; else summaries and span trees."""
        if self.query.get("format", [""])[-1] == "chrome":
            return 200, chrome_trace(traces)
        return 200, {"enabled": True, "traces": [t.summary() for t in traces]}

    def traces_recent(self, project: str):
        """Recent retained traces, newest first (``?n=``, default 50);
        ``?id=`` one trace from the ring or the slow reservoir."""
        tracer = self._tracer()
        if tracer is None:
            return 200, {"enabled": False, "traces": []}
        trace_id = self.query.get("id", [""])[-1]
        if trace_id:
            return self._traces(tracer.find(trace_id))
        return self._traces(tracer.recent(self._query_n("50")))

    def traces_slow(self, project: str):
        """The slowest traces, slowest first, whatever the head sampling."""
        tracer = self._tracer()
        if tracer is None:
            return 200, {"enabled": False, "traces": []}
        return self._traces(tracer.slow(self._query_n("0")))

    def slo_view(self, project: str):
        """Per-objective windowed ratios and burn rates (``?refresh=1``
        samples first), with the ledger's snapshot."""
        app = self.app
        if app.slo is None:
            return 200, {"enabled": False}
        if self.query.get("refresh", [""])[-1].lower() in _TRUE:
            app.slo.sample(force=True)
        return 200, {"enabled": True, **app.slo.snapshot(), "goodput": app.ledger.snapshot()}

    def costs_view(self, project: str):
        """Per-bucket FLOPs, MFU, device seconds a 1,000 rows and pad waste
        (``?refresh=1`` joins anew)."""
        cost = self.app.cost
        if cost is None:
            return 200, {"enabled": False}
        if self.query.get("refresh", [""])[-1].lower() in _TRUE:
            cost.sample(force=True)
        return 200, {"enabled": True, **cost.snapshot()}

    def _query_float(self, name: str) -> Optional[float]:
        """``?name=`` as a number, None when absent or empty, else 400."""
        raw = self.query.get(name, [""])[-1]
        if raw == "":
            return None
        try:
            return float(raw)
        except ValueError:
            raise HTTPError(400, f"{name} must be a number, got {raw!r}") from None

    def qos_view(self, project: str):
        """Admission's buckets, thresholds and counters, and the engine's
        fair queue and counters a class (the dicts ``/metrics`` renders)."""
        app = self.app
        body: Dict[str, Any] = {"enabled": True, "admission": app.admission.snapshot()}
        engine = app.engine
        if engine is not None:
            body["engine"] = engine.qos_snapshot()
        return 200, body

    def heat_view(self, project: str):
        """Heat's tiers, per-bucket breakdown and rate histogram (the cache
        the ``gordo_heat_*`` series and ``/stats`` read; ``?refresh=1``
        folds first), and the ``?top=`` (10) hottest and coldest members."""
        heat = self.app.heat
        if heat is None:
            return 200, {"enabled": False}
        if self.query.get("refresh", [""])[-1].lower() in _TRUE:
            heat.sample(force=True)
        body = {"enabled": True, **heat.snapshot()}
        top = self._query_float("top")
        body.update(heat.ranked(10 if top is None else int(top)))
        return 200, body

    def history_view(self, project: str):
        """The history store's state and its series' names, or with
        ``?series=a,b`` (and ``since``, ``until`` in epoch seconds,
        ``step`` in seconds) their points from the finest tier that covers
        the range."""
        store = self.app.history
        if store is None:
            return 200, {"enabled": False}
        body: Dict[str, Any] = store.snapshot()
        names = [n for n in self.query.get("series", [""])[-1].split(",") if n]
        if names:
            body["series"] = store.query(names, since=self._query_float("since"),
                                         until=self._query_float("until"), step=self._query_float("step"))
        else:
            body["names"] = store.series_names()
        return 200, body

    def events_view(self, project: str):
        """The event log, oldest first: ``?since=<seq>``,
        ``?since_wall=<epoch s>``, ``?type=a,b``, ``?limit=n`` (the newest n)."""
        events = self.app.events
        types = [t for t in self.query.get("type", [""])[-1].split(",") if t] or None
        since_seq = self._query_float("since") or 0
        limit = self._query_float("limit")
        body = {"enabled": True, **events.snapshot()}
        body["events"] = events.events(since_seq=int(since_seq), types=types,
                                       since_wall=self._query_float("since_wall"),
                                       limit=None if limit is None else int(limit))
        return 200, body

    def quarantine_list(self, project: str):
        return 200, {"enabled": True, **self.app.quarantine.snapshot()}

    def quarantine_clear(self, project: str):
        """Re-admit quarantined models: body ``{"targets": [...]}`` clears
        those, an empty or absent body every one."""
        raw = self._read_body()
        targets = None
        if raw:
            try:
                body = json.loads(raw)
            except ValueError:
                raise HTTPError(400, "expected a JSON body") from None
            if body:
                targets = body.get("targets")
                if targets is not None and not isinstance(targets, list):
                    raise HTTPError(400, "targets must be a list")
        cleared = self.app.quarantine.clear(targets)
        if cleared:
            self._emit("quarantine.clear", targets=cleared)
        return 200, {"enabled": True, "cleared": cleared}

    def reload(self, project: str):
        """Rescan the model directory, then build and warm a new bank from
        the collection's models and swap it in (``swap.py``), one reload at
        a time, the old bank serving until the flip. A replaced or removed
        model's quarantine verdict is dropped: it belonged to the old
        artifact. A failed bank build or warm-up leaves the old bank
        serving: 500 with the error, the collection's changes and the
        serving generation."""
        app = self.app
        with app.reload_lock:
            changes = app.collection.refresh()
            for name in changes["updated"] + changes["removed"]:
                app.quarantine.drop(name)
            try:
                bank_models, swap = swap_collection_bank(app)
            except Exception as exc:
                logger.exception("bank rebuild failed; the old bank keeps serving")
                raise HTTPError(500, f"bank rebuild failed: {type(exc).__name__}: {exc}",
                                changes=changes, generation=app.bank.generation) from None
        self._emit("models.reload", added=len(changes.get("added", ())), updated=len(changes.get("updated", ())),
                   removed=len(changes.get("removed", ())))
        body = {"changes": changes, "models": app.collection.names(), "bank_models": bank_models}
        if swap is not None:
            body["swap"] = swap
        return 200, body

    # ------------------------- the placement plane ------------------------- #

    def _json_object_body(self) -> Optional[dict]:
        """The body as a JSON object; None when empty (or JSON ``null``,
        ``{}``...); 400 when it does not parse or is another value."""
        raw = self._read_body()
        if not raw:
            return None
        try:
            body = json.loads(raw)
        except ValueError:
            raise HTTPError(400, "expected a JSON body") from None
        if isinstance(body, dict):
            return body
        if body:
            raise HTTPError(400, "expected a JSON object body")
        return None

    def placement_view(self, project: str):
        """The live member -> shard placement with each shard's window load,
        the generation, the controller's knobs and counters, and with
        ``?dry_run=1`` the plan ``POST /rebalance`` would apply now."""
        controller = self.app.placement
        if controller is None:
            return 200, {"enabled": False}
        dry_run = self.query.get("dry_run", [""])[-1].lower() in _TRUE
        return 200, controller.placement_view(dry_run=dry_run)

    def rebalance(self, project: str):
        """Plan a rebalance and apply it through the swap (``?dry_run=1``
        only plans; body ``{"force": true}`` applies a plan below the
        threshold). A failed swap has rolled back: 500 with ``rolled_back``."""
        controller = self.app.placement
        if controller is None:
            raise HTTPError(404, "placement control plane not enabled")
        body = self._json_object_body()
        force = bool(body.get("force", False)) if body else False
        dry_run = self.query.get("dry_run", [""])[-1].lower() in _TRUE
        try:
            result = controller.rebalance(force=force, dry_run=dry_run)
        except Exception as exc:
            logger.exception("rebalance failed (rolled back)")
            return 500, {"error": f"{type(exc).__name__}: {exc}", "rolled_back": True,
                         "generation": int(self.app.generation() or 0), "request_id": self.request_id}
        if not dry_run:
            self._emit("rebalance.applied" if result.get("applied") else "rebalance.plan",
                       moves=len((result.get("plan") or {}).get("moves") or ()), applied=bool(result.get("applied")))
        return 200, result

    # ----------------------------- the mesh ------------------------------ #

    def mesh_view(self, project: str):
        """This replica's mesh identity and the members it owns now."""
        identity = self.app.mesh
        body: Dict[str, Any] = {"enabled": identity is not None, "owned": self.app.collection.names(),
                                "generation": int(self.app.generation() or 0)}
        if identity is not None:
            body.update({"replica_id": identity.replica_id, "replica_count": identity.replica_count,
                         "distributed": identity.distributed, "coordinator": identity.coordinator})
        return 200, body

    def mesh_member_artifact(self, project: str, target: str):
        """An owned member's artifact directory as a gzipped tar (what an
        acquiring replica pulls); 404 with the reason otherwise."""
        collection = self.app.collection
        if target not in collection.models:
            raise HTTPError(404, f"member {target!r} is not owned by this replica", owned=len(collection.models))
        path = scan_artifacts(collection.root, collection.target_name).get(target)
        if path is None:
            raise HTTPError(404, f"member {target!r} has no artifact dir on disk")
        return 200, Raw(pack_artifact_dir(path), "application/gzip", {"X-Gordo-Member": target})

    def _mesh_body(self) -> dict:
        """A mesh mutation's JSON object body, its ``member`` a plain
        directory name (it is joined into the artifact root); 400 otherwise."""
        raw = self._read_body()
        try:
            body = json.loads(raw)
        except ValueError:
            body = None
        member = body.get("member") if isinstance(body, dict) else None
        if (not isinstance(member, str) or not member or member != os.path.basename(member)
                or member in (".", "..") or os.path.isabs(member)):
            raise HTTPError(400, 'expected a JSON body {"member": "<name>", ...} with a plain member name '
                                 "(no path separators)")
        return body

    def _fetch_artifact(self, project: str, source: str, member: str) -> bytes:
        """The member's artifact tar from the replica at ``source``, within
        120 s (a hung source must not hold the reload lock)."""
        import urllib.error
        import urllib.request

        url = f"{source.rstrip('/')}/gordo/v0/{project}/mesh/member/{member}/artifact"
        try:
            with urllib.request.urlopen(url, timeout=120.0) as resp:
                return resp.read()
        except urllib.error.HTTPError as exc:
            raise ValueError(f"source replied {exc.code}: {exc.read().decode(errors='replace')[:300]}") from None

    def mesh_acquire(self, project: str):
        """Own a member: ``{"member": name}`` (its artifact on this
        replica's disk) or ``{"member": name, "source": url}`` (shipped
        from that replica first). Idempotent; the new bank lands through the
        ``/reload`` swap, and a failed swap gives the ownership back (500,
        ``rolled_back``)."""
        app = self.app
        body = self._mesh_body()
        member, source = body["member"], body.get("source")
        if source is not None and not isinstance(source, str):
            raise HTTPError(400, "source must be a URL string")
        collection = app.collection
        with app.reload_lock:
            if member in collection.models:
                return 200, {"acquired": False, "already_owned": True, "member": member,
                             "generation": int(app.generation() or 0)}
            if source:
                try:
                    unpack_artifact_dir(self._fetch_artifact(project, source, member),
                                        os.path.join(collection.root, member))
                except Exception as exc:
                    return 502, {"acquired": False, "member": member,
                                 "error": f"artifact fetch from {source} failed: {type(exc).__name__}: {exc}"}
            try:
                changes = collection.acquire(member)
            except FileNotFoundError as exc:
                raise HTTPError(404, str(exc), hint='pass {"source": "<replica base url>"} to ship the artifact '
                                                    "first") from None
            app.quarantine.drop(member)  # fresh bytes get a clean breaker slate
            try:
                bank_models, swap_info = swap_collection_bank(app)
            except Exception as exc:
                collection.release(member)
                logger.exception("mesh acquire of %r failed at bank swap", member)
                return 500, {"acquired": False, "member": member, "rolled_back": True,
                             "error": f"{type(exc).__name__}: {exc}", "generation": int(app.generation() or 0)}
        self._emit("mesh.acquire", member=member, shipped=bool(source))
        return 200, {"acquired": True, "member": member, "shipped": bool(source), "changes": changes,
                     "bank_models": bank_models, "swap": swap_info, "owned": collection.names()}

    def mesh_release(self, project: str):
        """Stop owning a member (after the destination acquired it and the
        routing moved); its artifact stays on disk. 404 with the reason for
        a member not served here; a failed swap re-acquires it (500)."""
        app = self.app
        member = self._mesh_body()["member"]
        collection = app.collection
        with app.reload_lock:
            try:
                changes = collection.release(member)
            except KeyError as exc:
                raise HTTPError(404, str(exc.args[0])) from None
            app.quarantine.drop(member)
            try:
                bank_models, swap_info = swap_collection_bank(app)
            except Exception as exc:
                reacquired = True
                try:
                    collection.acquire(member)
                except Exception:
                    reacquired = False
                    logger.exception("mesh release rollback could not re-acquire %r; the member is NOT served "
                                     "by this replica", member)
                logger.exception("mesh release of %r failed at bank swap", member)
                return 500, {"released": False, "member": member, "rolled_back": reacquired,
                             "reacquire_failed": not reacquired, "error": f"{type(exc).__name__}: {exc}",
                             "generation": int(app.generation() or 0)}
        self._emit("mesh.release", member=member)
        return 200, {"released": True, "member": member, "changes": changes, "bank_models": bank_models,
                     "swap": swap_info, "owned": collection.names()}

    # ------------------------- the streaming plane ------------------------- #

    def _stream_plane(self):
        """The streaming plane, or a 404 naming the knob (a plain 404
        would read as a mistyped URL)."""
        plane = self.app.stream
        if plane is None:
            raise HTTPError(404, "streaming plane not enabled (GORDO_STREAM=0)")
        return plane

    def drift_view(self, project: str):
        """Per-member drift over the window buffers and the drifted list;
        ``?refresh=1`` runs a sweep first (device work, on this thread)."""
        plane = self.app.stream
        if plane is None:
            return 200, {"enabled": False}
        if self.query.get("refresh", [""])[-1].lower() in _TRUE:
            plane.evaluate()
        return 200, {"enabled": True, **plane.drift_view()}

    def ingest(self, project: str, target: str):
        """Append rows to the target's window buffer: JSON ``{"rows":
        [[...], ...], "timestamps": [...]}`` (``null`` cells are dropout;
        timestamps epoch seconds or ISO 8601, absent = arrived now on the
        plane's clock) or a tensor body (float32 ``rows``, optional float64
        ``timestamps``). The answer is the buffer's accounting."""
        plane = self._stream_plane()
        self._entry(target)  # 404 for an unknown target, as scoring
        raw = self._read_body()
        if encoding_of(self.headers.get("Content-Type")) == "tensor":
            try:
                frames = unpack_frames(raw)
                if "rows" not in frames:
                    raise WireFormatError(f"tensor ingest body must carry a 'rows' frame (got {sorted(frames)})")
                values = rows_as_f32(frames["rows"], "rows")
                ts = frames.get("timestamps")
                if ts is None:
                    event_ts = np.full((len(values),), plane.clock.time())
                else:
                    event_ts = np.asarray(ts, np.float64).reshape(-1)
                    if len(event_ts) != len(values):
                        raise WireFormatError(f"{len(event_ts)} timestamps for {len(values)} rows")
                counts = plane.ingest(target, event_ts, values)
            except (WireFormatError, ValueError) as exc:
                raise HTTPError(400, str(exc)) from None
            return 200, {"target": target, **counts}
        try:
            body = json.loads(raw)
        except ValueError:
            raise HTTPError(400, "expected a JSON body with rows") from None
        rows = body.get("rows") if isinstance(body, dict) else None
        if not isinstance(rows, list) or not rows:
            raise HTTPError(400, "rows must be a non-empty list of lists")
        try:
            values = np.asarray([[np.nan if v is None else v for v in r] for r in rows], dtype=np.float32)
            raw_ts = body.get("timestamps")
            if raw_ts is None:
                event_ts = np.full((len(values),), plane.clock.time())
            elif not isinstance(raw_ts, list):
                raise ValueError("timestamps must be a list")
            elif len(raw_ts) != len(values):
                raise ValueError(f"{len(raw_ts)} timestamps for {len(values)} rows")
            elif raw_ts and isinstance(raw_ts[0], str):
                event_ts = np.array([to_ns(t) for t in raw_ts], np.int64) / 1e9
            else:
                event_ts = np.asarray(raw_ts, np.float64)
            counts = plane.ingest(target, event_ts, values)
        except ValueError as exc:
            raise HTTPError(400, str(exc)) from None
        return 200, {"target": target, **counts}

    def results_stream(self, project: str, target: str):
        """The push long poll: the target's scored windows since this
        subscriber's last poll, waiting up to ``?timeout=`` (10 s, at most
        60) for the first; ``?subscriber=`` keeps one bounded queue across
        polls (absent: an id is minted and echoed). ``dropped`` counts what
        the subscriber lost to its bounded queue; 429 past
        ``GORDO_PUSH_SUBSCRIBERS_MAX`` subscribers."""
        plane = self._stream_plane()
        broker = plane.broker
        if broker is None:
            raise HTTPError(404, "push mode not enabled (GORDO_PUSH=0)")
        self._entry(target)
        subscriber = self.query.get("subscriber", [""])[-1][:128] or uuid.uuid4().hex[:12]
        try:
            timeout = float(self.query.get("timeout", ["10"])[-1])
        except ValueError:
            raise HTTPError(400, "timeout must be a number") from None
        timeout = min(max(timeout, 0.0), 60.0)
        if not broker.subscribe(subscriber, target):
            # a full table drains on the poll timeout's cadence: a slot
            # frees within one long poll, which is the honest retry hint
            retry_s = max(timeout, 1.0)
            raise HTTPError(429, "push subscriber table full (GORDO_PUSH_SUBSCRIBERS_MAX)",
                            headers={"Retry-After": str(max(1, math.ceil(retry_s)))},
                            reason="push_subscribers_full", retry_after_s=round(retry_s, 2))
        results, dropped = broker.poll(subscriber, target, timeout)
        return 200, {"subscriber": subscriber, "target": target, "results": results, "dropped": dropped}

    def adapt(self, project: str):
        """Recalibrate (default) or refit the drifted members (or the body's
        ``targets``) and land them as a new bank generation. Body
        (optional): ``{"mode": "recalibrate"|"refit", "targets": [...]}``.
        A failed adaptation rolls back: 500 with ``rolled_back``."""
        plane = self._stream_plane()
        mode, targets = "recalibrate", None
        raw = self._read_body()
        if raw:
            try:
                body = json.loads(raw)
            except ValueError:
                raise HTTPError(400, "expected a JSON body") from None
            if isinstance(body, dict):
                mode = body.get("mode", "recalibrate")
                targets = body.get("targets")
            elif body:
                raise HTTPError(400, "expected a JSON object body")
        if mode not in ("recalibrate", "refit"):
            raise HTTPError(400, f"mode must be recalibrate|refit, got {mode!r}")
        if targets is not None and not isinstance(targets, list):
            raise HTTPError(400, "targets must be a list")
        try:
            return 200, plane.adapt(mode, targets=targets)
        except Exception as exc:
            # the rollback already ran: the serving generation and the
            # published models are untouched
            logger.exception("adaptation failed (rolled back)")
            return 500, {"error": f"{type(exc).__name__}: {exc}", "rolled_back": True,
                         "generation": int(self.app.generation() or 0), "request_id": self.request_id}

    def healthcheck(self, project: str, target: str):
        self._entry(target)
        return 200, {"gordo-server-version": __version__}

    def metadata(self, project: str, target: str):
        _, meta = self._entry(target)
        return 200, {
            "endpoint-metadata": meta,
            "env": {"model_collection_dir": self.app.collection.root},
        }

    def download_model(self, project: str, target: str):
        model, _ = self._entry(target)
        return 200, Raw(serializer.dumps(model), "application/octet-stream")

    # a sequence model answers for the rows after its warm-up: the index
    # is trimmed to the output rows, as the JAX server trims its frame

    def prediction(self, project: str, target: str):
        model, _ = self._entry(target)
        self._quarantine_gate(project, target)
        X, y, index = self._parse()
        out = score_prediction(self.app, self, target, model, X, y)
        if index is None:  # tensor in, tensor out
            return 200, Raw(encode_prediction_response(out, len(X)), TENSOR_CONTENT_TYPE)
        return 200, prediction_body(out, index[len(index) - len(out):])

    def anomaly_prediction(self, project: str, target: str):
        model, _ = self._entry(target)
        require_anomaly(model)
        self._quarantine_gate(project, target)
        X, y, index = self._parse()
        tags, arrays, offset, output_tags, body = score_anomaly(self.app, self, target, model, X, y,
                                                                wire=index is None)
        if body is not None:
            return 200, Raw(body, TENSOR_CONTENT_TYPE)
        n_out = len(arrays["model-output"])
        return 200, anomaly_body(tags, arrays, index[offset:][:n_out], output_tags)


class _QuietDisconnects:
    """A client that drops its connection before the answer is written
    (the loser of a hedged request, a spent deadline) is logged at DEBUG,
    not printed as a traceback: the answer had no one left to read it."""

    def handle_error(self, request, client_address) -> None:
        exc = sys.exc_info()[1]
        if isinstance(exc, ConnectionError):
            logger.debug("client %s went away before its answer: %s", client_address or "unix", exc)
            return
        super().handle_error(request, client_address)


class GordoServer(_QuietDisconnects, ThreadingHTTPServer):
    """The app behind a threading HTTP server; one thread per connection.

    ``worker`` tags the server as one accept loop of a pool
    (``workers.py``): its requests count into ``stats["workers"]``.
    ``reuse_port`` binds with ``SO_REUSEPORT``, so several servers listen
    on one port. With ``bind_and_activate=False`` it has no socket of its
    own and serves the connections a pool's acceptor hands it
    (``process_request``)."""

    daemon_threads = True
    request_queue_size = 256  # many clients connect at once

    def __init__(self, app, host: str, port: int, worker: Optional[str] = None, reuse_port: bool = False,
                 bind_and_activate: bool = True):
        self.app = app
        self.worker = worker
        self.reuse_port = reuse_port
        self._thread: Optional[threading.Thread] = None
        super().__init__((host, port), GordoHandler, bind_and_activate)

    def server_bind(self) -> None:
        if self.reuse_port:
            self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "GordoServer":
        """Serve on a background thread; :meth:`close` stops it."""
        # a short poll: stop() waits at most this long for the loop
        self._thread = threading.Thread(target=self.serve_forever, kwargs={"poll_interval": 0.05},
                                        name="gordo-http", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop serving and close the socket; the app keeps running."""
        if self._thread is not None:
            self.shutdown()
            self._thread.join()
            self._thread = None
        self.server_close()

    def close(self) -> None:
        """Stop serving, close the socket and stop the app's engine."""
        self.stop()
        self.app.close()


class GordoUnixServer(_QuietDisconnects, socketserver.ThreadingMixIn, socketserver.UnixStreamServer):
    """The app's routes on a Unix-domain socket at ``path``
    (``GORDO_UDS``): the HTTP surface of :class:`GordoServer` for a client
    on the same host, one thread per connection. A socket file left at
    ``path`` by an earlier server is replaced; any other file there is an
    error. :meth:`stop` removes the file; the app keeps running."""

    daemon_threads = True
    request_queue_size = 256

    def __init__(self, app, path: str, worker: Optional[str] = None):
        self.app = app
        self.worker = worker
        self._thread: Optional[threading.Thread] = None
        super().__init__(path, GordoHandler)

    def server_bind(self) -> None:
        path = self.server_address
        try:
            if stat.S_ISSOCK(os.stat(path).st_mode):
                os.unlink(path)
        except FileNotFoundError:
            pass
        super().server_bind()

    def start(self) -> "GordoUnixServer":
        self._thread = threading.Thread(target=self.serve_forever, kwargs={"poll_interval": 0.05},
                                        name="gordo-uds", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self.shutdown()
            self._thread.join()
            self._thread = None
        self.server_close()
        try:
            os.unlink(self.server_address)
        except OSError:
            pass
