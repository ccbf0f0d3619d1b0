"""HTTP routes of the port's server, on the standard library's http.server.

Counterpart of the scoring and metadata routes of
``gordo_components_tpu/server/views.py``:

- ``GET  /gordo/v0/<project>/models``
- ``GET  /gordo/v0/<project>/<target>/healthcheck``
- ``GET  /gordo/v0/<project>/<target>/metadata``
- ``POST /gordo/v0/<project>/<target>/prediction``
- ``POST /gordo/v0/<project>/<target>/anomaly/prediction``

Bodies match the JAX server's JSON. Errors: 400 for a bad body or a request
the model cannot score, 404 for an unknown target or route, 405 for a
route's other method, 429 with ``Retry-After`` when the engine's queue is
full.
"""

import json
import logging
import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from gordo_components_torch import __version__
from gordo_components_torch.server.engine import EngineOverloaded
from gordo_components_torch.server.utils import anomaly_body, extract_x_y, prediction_body

logger = logging.getLogger(__name__)

_P = r"^/gordo/v0/(?P<project>[^/]+)"
_ROUTES = [
    ("GET", re.compile(_P + r"/models$"), "list_models"),
    ("GET", re.compile(_P + r"/(?P<target>[^/]+)/healthcheck$"), "healthcheck"),
    ("GET", re.compile(_P + r"/(?P<target>[^/]+)/metadata$"), "metadata"),
    ("POST", re.compile(_P + r"/(?P<target>[^/]+)/prediction$"), "prediction"),
    ("POST", re.compile(_P + r"/(?P<target>[^/]+)/anomaly/prediction$"), "anomaly_prediction"),
]


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
        path = self.path.split("?", 1)[0]
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
        raw = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
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
        try:
            return self.app.collection.entry(target)
        except KeyError:
            raise HTTPError(404, f"No such model: {target}") from None

    def _read_json(self):
        length = int(self.headers.get("Content-Length") or 0)
        try:
            return json.loads(self.rfile.read(length))
        except ValueError:
            raise HTTPError(400, "Expected JSON body with an X entry") from None

    def _score(self, target: str) -> Tuple[Any, Any]:
        self._entry(target)
        try:
            X, y, index = extract_x_y(self._read_json())
        except ValueError as exc:
            raise HTTPError(400, str(exc)) from None
        try:
            result = self.app.engine.score_blocking(target, X, y)
        except EngineOverloaded as exc:
            raise HTTPError(
                429, str(exc),
                headers={"Retry-After": str(max(1, math.ceil(exc.retry_after_s)))},
                reason="engine_overloaded",
                retry_after_s=round(exc.retry_after_s, 2),
            ) from None
        except (ValueError, KeyError) as exc:
            raise HTTPError(400, f"{type(exc).__name__}: {exc}") from None
        return result, index

    # ----------------------------- routes ------------------------------ #

    def list_models(self, project: str):
        return 200, {
            "project": project,
            "models": self.app.collection.names(),
            "bank": self.app.bank.coverage(),
        }

    def healthcheck(self, project: str, target: str):
        self._entry(target)
        return 200, {"gordo-server-version": __version__}

    def metadata(self, project: str, target: str):
        _, meta = self._entry(target)
        return 200, {
            "endpoint-metadata": meta,
            "env": {"model_collection_dir": self.app.collection.root},
        }

    # a sequence model answers for the rows after its warm-up: the index
    # is trimmed to the output rows, as the JAX server trims its frame

    def prediction(self, project: str, target: str):
        result, index = self._score(target)
        out = result.model_output
        return 200, prediction_body(out, index[len(index) - len(out):])

    def anomaly_prediction(self, project: str, target: str):
        result, index = self._score(target)
        n_out = len(result.model_output)
        return 200, anomaly_body(
            result.tags, result.to_arrays(), index[result.offset:][:n_out]
        )


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
        self._thread = threading.Thread(target=self.serve_forever, name="gordo-http", daemon=True)
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
