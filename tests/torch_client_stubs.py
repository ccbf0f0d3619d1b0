"""Loopback stub servers for the bulk client's tests (``test_torch_client*.py``).

:class:`Stub` is a stdlib HTTP/1.1 keep-alive server that answers each
path from a script, ``{path: [(status, headers, body, delay_s), ...]}``
(the last answer repeats; a path's query string is matched too when the
script names it), or from ``handler(method, path, headers, body)``, and
records every request. :class:`RawStub` writes one answer's bytes as
given to every request, for framings ``http.server`` does not write
(chunked, HTTP/1.0 without a length). :class:`ClosingUnixSocket` accepts
connections on a Unix socket and closes each at once: a server that died
mid-run.
"""

import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def answer(status=200, body=b"{}", headers=None, delay_s=0.0, content_type="application/json"):
    if not isinstance(body, (bytes, bytearray)):
        body = json.dumps(body).encode()
    return status, {"Content-Type": content_type, **(headers or {})}, bytes(body), delay_s


class Stub:
    def __init__(self, script=None, handler=None):
        self.script = {k: list(v) for k, v in (script or {}).items()}
        self.handler = handler
        self.requests = []
        self._lock = threading.Lock()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _serve(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                with stub._lock:
                    stub.requests.append((self.command, self.path, dict(self.headers), body))
                status, headers, data, delay = stub.respond(self.command, self.path, dict(self.headers), body)
                if delay:
                    time.sleep(delay)
                try:
                    self.send_response(status)
                    for k, v in headers.items():
                        self.send_header(k, v)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                except OSError:  # the client gave up (a cancelled hedge)
                    self.close_connection = True

            do_GET = do_POST = _serve

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self._thread = threading.Thread(target=self.server.serve_forever, kwargs={"poll_interval": 0.05},
                                        daemon=True)
        self._thread.start()

    def respond(self, method, path, headers, body):
        if self.handler is not None:
            got = self.handler(method, path, headers, body)
            if got is not None:
                return got
        with self._lock:
            key = path if path in self.script else path.split("?", 1)[0]
            steps = self.script.get(key)
            if not steps:
                return answer(404, {"error": f"no script for {path}"})
            return steps.pop(0) if len(steps) > 1 else steps[0]

    def paths(self):
        with self._lock:
            return [p for _, p, _, _ in self.requests]

    def close(self):
        self.server.shutdown()
        self.server.server_close()


class RawStub:
    """A loopback server writing ``raw`` to each request of a connection,
    which it keeps open for the next unless ``close`` is set."""

    def __init__(self, raw: bytes, close: bool = False):
        self.raw, self.close_each = raw, close
        self.connections = 0
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.sock.settimeout(0.1)
        self.url = f"http://127.0.0.1:{self.sock.getsockname()[1]}"
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except (socket.timeout, OSError):
                continue
            self.connections += 1
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn):
        conn.settimeout(5)
        pending = b""
        with conn:
            try:
                while not self._stop.is_set():
                    while b"\r\n\r\n" not in pending:
                        data = conn.recv(65536)
                        if not data:
                            return
                        pending += data
                    pending = pending.split(b"\r\n\r\n", 1)[1]  # requests here carry no body
                    conn.sendall(self.raw)
                    if self.close_each:
                        return
            except OSError:
                return

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self.sock.close()


class ClosingUnixSocket:
    """A Unix socket whose every connection is closed unanswered."""

    def __init__(self, path):
        self.path = path
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.bind(path)
        self.sock.listen(64)
        self.sock.settimeout(0.1)
        self.accepted = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except (socket.timeout, OSError):
                continue
            self.accepted += 1
            conn.close()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self.sock.close()
        if os.path.exists(self.path):
            os.unlink(self.path)
