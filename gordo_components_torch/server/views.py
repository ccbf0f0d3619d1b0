"""HTTP routes of the port's server, on the standard library's http.server.

Counterpart of these routes of ``gordo_components_tpu/server/views.py``:

- ``GET  /healthz`` and ``/gordo/v0/<project>/healthz``
- ``GET  /gordo/v0/<project>/ready``
- ``GET  /gordo/v0/<project>/models``
- ``GET  /gordo/v0/<project>/metadata-all`` (``?digest=1``)
- ``POST /gordo/v0/<project>/reload``
- ``GET  /gordo/v0/<project>/<target>/healthcheck``
- ``GET  /gordo/v0/<project>/<target>/metadata``
- ``GET  /gordo/v0/<project>/<target>/download-model``
- ``POST /gordo/v0/<project>/<target>/prediction``
- ``POST /gordo/v0/<project>/<target>/anomaly/prediction``

Bodies match the JAX server's JSON. A scoring POST is JSON, or parquet
when its content type contains ``parquet`` (the JAX server's rule; read by
the port's own reader, ``server/utils.extract_x_y_parquet``), and
``/models`` lists both in ``accepts``. A model the bank holds is
scored through the batching engine; any other (a bare ``Pipeline`` or
estimator, or every model when the bank is off) through its own
``predict``/``anomaly``: the per-model path. ``download-model`` answers the
model's artifact directory as a gzipped tar (``serializer.dumps``), where
the JAX server answers a pickle. ``metadata-all?digest=1`` is not gzipped.
Errors: 400 for a bad body or a request the model cannot score, 404 for an
unknown target or route, 405 for a route's other method, 422 for an
anomaly request to a model without ``anomaly``, 429 with ``Retry-After``
when the engine's queue is full, 503 from ``/healthz`` and ``/ready`` when
nothing is served.
"""

import json
import logging
import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs

from gordo_components_torch import __version__, serializer
from gordo_components_torch.server.bank import ModelBank
from gordo_components_torch.server.engine import EngineOverloaded
from gordo_components_torch.server.swap import swap_bank
from gordo_components_torch.server.utils import (
    anomaly_body,
    extract_x_y,
    extract_x_y_parquet,
    prediction_body,
)
from gordo_components_torch.utils.digest import metadata_digest

logger = logging.getLogger(__name__)

_P = r"^/gordo/v0/(?P<project>[^/]+)"
_T = _P + r"/(?P<target>[^/]+)"
_ROUTES = [
    ("GET", re.compile(r"^/healthz$"), "healthz"),
    ("GET", re.compile(_P + r"/healthz$"), "healthz"),
    ("GET", re.compile(_P + r"/ready$"), "ready"),
    ("GET", re.compile(_P + r"/models$"), "list_models"),
    ("GET", re.compile(_P + r"/metadata-all$"), "metadata_all"),
    ("POST", re.compile(_P + r"/reload$"), "reload"),
    ("GET", re.compile(_T + r"/healthcheck$"), "healthcheck"),
    ("GET", re.compile(_T + r"/metadata$"), "metadata"),
    ("GET", re.compile(_T + r"/download-model$"), "download_model"),
    ("POST", re.compile(_T + r"/prediction$"), "prediction"),
    ("POST", re.compile(_T + r"/anomaly/prediction$"), "anomaly_prediction"),
]
_TRUE = ("1", "true", "yes")
ACCEPTS = ["application/json", "application/x-parquet"]


class HTTPError(Exception):
    def __init__(self, status: int, error: str, headers: Optional[Dict[str, str]] = None, **extra):
        super().__init__(error)
        self.status = status
        self.body = {"error": error, **extra}
        self.headers = headers or {}


class GordoHandler(BaseHTTPRequestHandler):
    """One request; ``self.server.app`` is the :class:`~.App` it serves."""

    server_version = f"gordo-components-torch/{__version__}"

    def log_message(self, fmt, *args):
        logger.debug("%s " + fmt, self.address_string(), *args)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def _dispatch(self, method: str) -> None:
        path, _, query = self.path.partition("?")
        self.query = parse_qs(query)
        try:
            for route_method, pattern, handler in _ROUTES:
                match = pattern.match(path)
                if match is None:
                    continue
                if route_method != method:
                    raise HTTPError(405, f"{method} not allowed on {path}")
                status, body = getattr(self, handler)(**match.groupdict())
                self._send(status, body)
                return
            raise HTTPError(404, f"No route for {path}")
        except HTTPError as exc:
            self._send(exc.status, exc.body, exc.headers)
        except Exception as exc:
            logger.exception("request failed")
            self._send(500, {"error": f"{type(exc).__name__}: {exc}"})

    def _send(self, status: int, body: Any, headers: Optional[Dict[str, str]] = None) -> None:
        if isinstance(body, bytes):  # download-model's archive
            raw, content_type = body, "application/octet-stream"
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
        try:
            return self.app.collection.entry(target)
        except KeyError:
            raise HTTPError(404, f"No such model: {target}") from None

    def _read_body(self) -> bytes:
        return self.rfile.read(int(self.headers.get("Content-Length") or 0))

    def _parse(self):
        """(X, y, index) of a JSON or parquet POST body; 400 for one that
        does not parse."""
        raw = self._read_body()
        if "parquet" in (self.headers.get("Content-Type") or ""):
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

    def _engine(self, target: str):
        """The batching engine when the bank holds ``target``, else None:
        the per-model path."""
        bank, engine = self.app.bank, self.app.engine
        if engine is not None and bank is not None and target in bank:
            return engine
        return None

    def _bank_score(self, engine, target: str, X, y):
        try:
            return engine.score_blocking(target, X, y)
        except EngineOverloaded as exc:
            raise HTTPError(
                429, str(exc),
                headers={"Retry-After": str(max(1, math.ceil(exc.retry_after_s)))},
                reason="engine_overloaded",
                retry_after_s=round(exc.retry_after_s, 2),
            ) from None
        except (ValueError, KeyError) as exc:
            raise HTTPError(400, f"{type(exc).__name__}: {exc}") from None

    @staticmethod
    def _per_model(fn, *args):
        """A model's own ``predict``/``anomaly``; its errors are 400s, as
        the JAX server's per-model path answers them."""
        try:
            return fn(*args)
        except Exception as exc:
            logger.exception("per-model scoring failed")
            raise HTTPError(400, f"{type(exc).__name__}: {exc}") from None

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
        """``ok``, ``degraded`` (200: some artifact failed to load, or a
        bank bucket failed to build) or ``unhealthy`` (503: nothing is
        served), and why."""
        collection, bank = self.app.collection, self.app.bank
        models = len(collection.models)
        load_failures = dict(collection.load_failures)
        finalize_failures = dict(bank.finalize_failures) if bank is not None else {}
        if models == 0:
            status, http = "unhealthy", 503
        elif load_failures or finalize_failures:
            status, http = "degraded", 200
        else:
            status, http = "ok", 200
        return http, {
            "status": status,
            "models": models,
            "quarantined": {},
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
        return 200, body

    def reload(self, project: str):
        """Rescan the model directory, then build a new bank from the
        collection's models and swap it in (``swap.py``), one reload at a
        time. A failed bank build leaves the old bank serving: 500 with
        the error, the collection's changes and the serving generation."""
        app = self.app
        with app.reload_lock:
            changes = app.collection.refresh()
            bank_models, swap = None, None
            if app.bank is not None:
                try:
                    result = swap_bank(app, ModelBank.from_models(app.collection.models, **app.bank_config))
                except Exception as exc:
                    logger.exception("bank rebuild failed; the old bank keeps serving")
                    raise HTTPError(500, f"bank rebuild failed: {type(exc).__name__}: {exc}",
                                    changes=changes, generation=app.bank.generation) from None
                bank_models = result.bank_models
                swap = {"generation": result.generation, "pause_ms": round(result.pause_s * 1e3, 3)}
        body = {"changes": changes, "models": app.collection.names(), "bank_models": bank_models}
        if swap is not None:
            body["swap"] = swap
        return 200, body

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
        return 200, serializer.dumps(model)

    # a sequence model answers for the rows after its warm-up: the index
    # is trimmed to the output rows, as the JAX server trims its frame

    def prediction(self, project: str, target: str):
        model, _ = self._entry(target)
        X, y, index = self._parse()
        engine = self._engine(target)
        if engine is not None:
            out = self._bank_score(engine, target, X, y).model_output
        else:
            out = self._per_model(model.predict, X)
        return 200, prediction_body(out, index[len(index) - len(out):])

    def anomaly_prediction(self, project: str, target: str):
        model, _ = self._entry(target)
        if not hasattr(model, "anomaly"):
            raise HTTPError(422, "Model does not support anomaly scoring")
        X, y, index = self._parse()
        engine = self._engine(target)
        output_tags = None
        if engine is not None:
            result = self._bank_score(engine, target, X, y)
            tags, arrays, offset = result.tags, result.to_arrays(), result.offset
        else:
            arrays = self._per_model(model.anomaly, X, y)
            tags, offset = model.tags_, len(X) - len(arrays["model-output"])
            output_tags = getattr(model, "output_tags", None)
        n_out = len(arrays["model-output"])
        return 200, anomaly_body(tags, arrays, index[offset:][:n_out], output_tags)


class GordoServer(ThreadingHTTPServer):
    """The app behind a threading HTTP server; one thread per connection."""

    daemon_threads = True
    request_queue_size = 256  # many clients connect at once

    def __init__(self, app, host: str, port: int):
        self.app = app
        self._thread: Optional[threading.Thread] = None
        super().__init__((host, port), GordoHandler)

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "GordoServer":
        """Serve on a background thread; :meth:`close` stops it."""
        # a short poll: close() waits at most this long for the loop
        self._thread = threading.Thread(target=self.serve_forever, kwargs={"poll_interval": 0.05},
                                        name="gordo-http", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop serving, close the socket and stop the app's engine."""
        if self._thread is not None:
            self.shutdown()
            self._thread.join()
            self._thread = None
        self.server_close()
        self.app.close()
