"""Multi-worker serving: N accept loops over one app, and the local
transports beside them.

Counterpart of ``gordo_components_tpu/server/workers.py``. What a worker
is here: the port's :class:`~.views.GordoServer` already answers each
connection on a thread of its own, so parsing, scoring and answering are
as wide as the connections; what stays one thread is the accept loop,
which takes every connection and starts its handler. A worker is one such
accept loop, a ``GordoServer`` over the pool's one
:class:`~gordo_components_torch.server.App` on a thread of its own,
tagged ``w0``..``wN-1``: the requests it accepts count into
``app.stats["workers"]`` under ``app.stats_lock``
(``gordo_server_worker_requests_total{worker}``, ``/stats`` ``workers``;
a server that is not in a pool of more than one has no tag, and no
samples). Each worker listens on a socket of its own bound with
``SO_REUSEPORT``, so the kernel spreads the connections over them. Where
the platform lacks ``SO_REUSEPORT``, one acceptor thread owns the one
listening socket and hands the connections to the workers round-robin.

The pool also serves the app's routes on a Unix-domain socket
(``uds_path``, :class:`~.views.GordoUnixServer`, tagged ``w0`` in a pool
of more than one, as JAX's primary loop serves it) and the shared-memory
ring (``shm_ring``, :class:`~.transport.ShmServer`), and names them in
``app.transports``. A transport that fails to bind or to map raises from
:meth:`ServerPool.start`.

One engine for all workers, where the JAX pool gives each worker loop an
engine of its own behind a shared dispatch lock: the app's
``BatchingEngine`` holds the weighted-fair queue and admission reads its
depth, and engines a worker would split both. The workers share the app,
so a ``/reload`` through any of them swaps the bank all of them score on
(``app.reload_lock`` serializes reloads).
"""

import os
import socket
import threading
from typing import List, Optional

from gordo_components_torch.server.transport import ShmServer
from gordo_components_torch.server.views import GordoServer, GordoUnixServer

__all__ = ["ServerPool", "resolve_workers"]


def resolve_workers(workers: Optional[int] = None) -> int:
    """The worker count: ``workers``, else ``GORDO_SERVER_WORKERS``
    (default 1: one accept loop, as without a pool); at least 1."""
    if workers is None:
        raw = os.environ.get("GORDO_SERVER_WORKERS", "1") or "1"
        try:
            workers = int(raw)
        except ValueError:
            raise ValueError(f"GORDO_SERVER_WORKERS must be an integer, got {raw!r}") from None
    return max(1, int(workers))


class ServerPool:
    """``workers`` accept loops over ``app`` on ``host:port`` (``port=0``
    picks a free one), with a Unix-socket listener at ``uds_path`` and the
    shared-memory ring ``shm_ring`` when given: one socket a worker where
    the platform has ``SO_REUSEPORT``, else the acceptor. :meth:`start`
    returns once every listener is bound; :meth:`stop` (or :meth:`close`)
    stops them all and then the app."""

    def __init__(self, app, host: str = "0.0.0.0", port: int = 5555, workers: Optional[int] = None,
                 uds_path: Optional[str] = None, shm_ring: Optional[str] = None):
        self.app = app
        self.host = host
        self.port = int(port)
        self.workers = resolve_workers(workers)
        self.uds_path = uds_path
        self.shm_ring_name = shm_ring
        self.reuse_port = hasattr(socket, "SO_REUSEPORT")
        self.servers: List[GordoServer] = []
        self.uds_server: Optional[GordoUnixServer] = None
        self.shm_server: Optional[ShmServer] = None
        self._accept_sock: Optional[socket.socket] = None
        self._acceptor: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._stopped = threading.Event()
        self._started = False

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _tag(self, i: int) -> Optional[str]:
        return f"w{i}" if self.workers > 1 else None

    def _server(self, i: int, bind: bool) -> GordoServer:
        server = GordoServer(self.app, self.host, self.port, worker=self._tag(i), reuse_port=self.reuse_port,
                             bind_and_activate=False)
        if bind:
            try:
                server.server_bind()
                server.server_activate()
            except BaseException:
                server.server_close()
                raise
        return server

    def start(self) -> "ServerPool":
        if self._started:
            raise RuntimeError("pool already started")
        self._started = True
        try:
            if self.reuse_port:
                for i in range(self.workers):
                    self.servers.append(self._server(i, bind=True))
                    self.port = self.servers[0].server_address[1]  # port=0 resolved once
                for server in self.servers:
                    server.start()
            else:
                sock = self._accept_sock = socket.create_server((self.host, self.port),
                                                                backlog=GordoServer.request_queue_size)
                sock.settimeout(0.05)  # stop() waits at most this long for the acceptor
                self.port = sock.getsockname()[1]
                self.servers = [self._server(i, bind=False) for i in range(self.workers)]
                self._acceptor = threading.Thread(target=self._accept_loop, name="gordo-acceptor", daemon=True)
                self._acceptor.start()
            if self.uds_path:
                self.uds_server = GordoUnixServer(self.app, self.uds_path, worker=self._tag(0)).start()
                self.app.transports["uds"] = self.uds_path
            if self.shm_ring_name:
                self.shm_server = ShmServer.create(self.app, self.shm_ring_name)
        except BaseException:
            self.stop()
            raise
        return self

    def _accept_loop(self) -> None:
        """The acceptor without ``SO_REUSEPORT``: connection i goes to
        worker i mod N, which answers it on a thread of its own."""
        i = 0
        while not self._stop.is_set():
            try:
                conn, peer = self._accept_sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # the socket was closed
            conn.settimeout(None)
            self.servers[i % self.workers].process_request(conn, peer)
            i += 1

    def serve_forever(self) -> None:
        """:meth:`start`, then block until :meth:`stop` or an interrupt."""
        self.start()
        self.wait()

    def wait(self) -> None:
        """Block the calling thread until :meth:`stop` (or an interrupt)."""
        while not self._stopped.wait(1.0):
            pass

    def stop(self) -> None:
        """Stop the ring, the listeners and the acceptor, then the app (its
        engine and samplers)."""
        if self._stopped.is_set():
            return
        self._stop.set()
        if self.shm_server is not None:
            self.shm_server.close()
            self.shm_server = None
        if self._acceptor is not None:
            self._acceptor.join(10.0)
        if self._accept_sock is not None:
            self._accept_sock.close()
        for server in reversed(self.servers):
            server.stop()
        if self.uds_server is not None:
            self.uds_server.stop()
        self.app.close()
        self._stopped.set()

    close = stop
