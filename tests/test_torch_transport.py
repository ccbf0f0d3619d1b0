"""The port's local transports and worker pool, on the CPU.

- The shared-memory ring (``utils/shm_ring.py``) against the JAX
  package's: the envelope's bytes and errors, a segment's header and slot
  bytes, and a port client against a JAX ring and a JAX client against a
  port ring, exchanging slots byte for byte.
- One port server (a dense detector from seeded weights, banked; a bare
  ``AutoEncoder``, per model) behind a ``ServerPool`` with a Unix socket
  and the ring: one tensor body gives the same bytes over TCP, the socket
  and the ring, sent one at a time; the socket answers 400 with the
  reason, 410 and 200 again after a clear, and logs its peer at DEBUG;
  the ring answers 404, 410, 422, 400 with the views' documents and 429
  for a ``__meta__`` tenant over its bucket; ``/stats``, ``/models`` and
  ``/metrics`` show the ring and the transports.
- The pool's workers (``server/workers.py``): ``resolve_workers`` from
  the environment; every worker counts requests under 2 workers; the
  acceptor's round-robin with ``SO_REUSEPORT`` taken away; a ``/reload``
  through one worker is seen through every one; one engine scores for
  all workers; no worker series with 1.

Every socket, thread and ring wait here has its own timeout.
"""

import http.client
import json
import logging
import os
import shutil
import socket
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from gordo_components_torch import serializer
from gordo_components_torch.convert import entry_from_numpy
from gordo_components_torch.models import AutoEncoder
from gordo_components_torch.models.factories.feedforward import hourglass_calc_dims
from gordo_components_torch.server import GordoServer, ServerPool, run_server
from gordo_components_torch.server.workers import resolve_workers
from gordo_components_torch.utils import shm_ring as port_ring
from gordo_components_torch.utils.wire import TENSOR_CONTENT_TYPE, pack_frames, unpack_frames
from gordo_components_tpu.utils import shm_ring as jax_ring

F = 4
TAGS = [f"tag-{i}" for i in range(F)]
P = "/gordo/v0/proj"
X = np.random.RandomState(3).rand(30, F).astype("float32")
TENSOR = {"Content-Type": TENSOR_CONTENT_TYPE}
TIMEOUT = 30.0
TENANTS = {"GORDO_QOS_TENANTS": json.dumps({"ring-t": {"rate": 0.001, "burst": 1}})}
_NAMES = iter(range(10 ** 6))


def ring_name() -> str:
    return f"gordo-test-{os.getpid()}-{next(_NAMES)}"


def dense_entry(name: str, seed: int):
    rng = np.random.RandomState(seed)
    enc = hourglass_calc_dims(0.5, 3, F)
    dims = [F, *enc, *enc[::-1], F]
    params = {"params": {f"Dense_{i}": {"kernel": rng.randn(a, b).astype("f4") / np.sqrt(a),
                                        "bias": (0.1 * rng.randn(b)).astype("f4")}
                         for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}}
    return entry_from_numpy(name, "AutoEncoder", "feedforward_hourglass", {}, F, params,
                            0.1 * rng.randn(F), 1.0 + rng.rand(F), 0.05 * rng.rand(F), 1.0 + rng.rand(F),
                            tags=TAGS)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    out = tmp_path_factory.mktemp("transport")
    serializer.dump(dense_entry("tr-dense", 0), str(out / "tr-dense"))
    bare = AutoEncoder(kind="feedforward_symmetric", dims=[2], epochs=1, device="cpu").fit(X)
    serializer.dump(bare, str(out / "tr-bare"))
    return str(out)


@pytest.fixture
def uds_path():
    # a short path: AF_UNIX paths are bounded (108 bytes on Linux)
    d = tempfile.mkdtemp(prefix="gordo-uds-")
    yield os.path.join(d, "s")
    if os.path.exists(os.path.join(d, "s")):
        os.unlink(os.path.join(d, "s"))
    os.rmdir(d)


def serve(root, **kwargs):
    env = {k: os.environ.get(k) for k in TENANTS}
    os.environ.update(TENANTS)
    try:
        return run_server(root, host="127.0.0.1", port=0, device="cpu", background=True, **kwargs)
    finally:
        for k, v in env.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def call(base, method, path, raw=None, headers=None):
    """(status, content type, body bytes) of one request on a new connection."""
    req = urllib.request.Request(base + path, data=raw, headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, resp.headers.get_content_type(), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers.get_content_type(), exc.read()


class UnixConnection(http.client.HTTPConnection):
    def __init__(self, path):
        super().__init__("localhost", timeout=TIMEOUT)
        self.unix_path = path

    def connect(self):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self.unix_path)
        self.sock = sock


def uds_call(path, method, url, raw=None, headers=None):
    conn = UnixConnection(path)
    try:
        conn.request(method, url, body=raw, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.headers.get_content_type(), resp.read()
    finally:
        conn.close()


# --------------------------------------------------------------------------- #
# the ring against the JAX ring
# --------------------------------------------------------------------------- #

ENVELOPE_ERRORS = {
    "bad-endpoint": lambda r: r.pack_envelope("m", "bogus", b""),
    "empty-target": lambda r: r.pack_envelope("", "anomaly", b""),
    "short-payload": lambda r: r.unpack_envelope(memoryview(b"\x01")),
    "truncated": lambda r: r.unpack_envelope(memoryview(b"\x09\x00abc")),
    "unknown-code": lambda r: r.unpack_envelope(memoryview(b"\x01\x00m\x07body")),
}


@pytest.mark.parametrize("case", sorted(ENVELOPE_ERRORS))
def test_envelope_errors_match_jax(case):
    got = want = None
    try:
        ENVELOPE_ERRORS[case](port_ring)
    except port_ring.ShmRingError as exc:
        got = str(exc)
    try:
        ENVELOPE_ERRORS[case](jax_ring)
    except jax_ring.ShmRingError as exc:
        want = str(exc)
    assert got == want is not None


@pytest.mark.parametrize("target, endpoint", [("machine-a", "anomaly"), ("m" * 300, "prediction"), ("måskin", "anomaly")])
def test_envelope_bytes_match_jax(target, endpoint):
    body = pack_frames([("X", X)])
    env = port_ring.pack_envelope(target, endpoint, body)
    assert env == jax_ring.pack_envelope(target, endpoint, body)
    t, e, view = port_ring.unpack_envelope(memoryview(env))
    assert (t, e, bytes(view)) == jax_ring.unpack_envelope(memoryview(env))[:2] + (body,)


def test_segments_are_the_jax_bytes():
    """A ring made by each package, with one request and one answer
    written by each: the same header and slot bytes."""
    payload = port_ring.pack_envelope("m", "anomaly", pack_frames([("X", X[:5])]))
    rings = [port_ring.ShmRing.create(ring_name(), slots=3, slot_mb=0.01),
             jax_ring.ShmRing.create(ring_name(), slots=3, slot_mb=0.01)]
    try:
        for ring in rings:
            ring.write_request(0, payload)
            ring.write_response(1, 410, b'{"error": "gone"}')
            ring.write_response(2, 200, b"x" * (ring.payload_max + 1))  # 413 instead
        a, b = (bytes(r.buf[:port_ring.HEADER_SIZE + 3 * r.slot_size]) for r in rings)
        assert a == b
        assert [r.state(i) for r in rings for i in range(3)] == [port_ring.REQ, port_ring.RESP, port_ring.RESP] * 2
        assert rings[0].read_response(2) == rings[1].read_response(2)
        assert rings[0].read_response(2)[0] == 413
    finally:
        for ring in rings:
            ring.close()


@pytest.mark.parametrize("client_pkg, ring_pkg", [(port_ring, jax_ring), (jax_ring, port_ring)],
                         ids=["port-client-jax-ring", "jax-client-port-ring"])
def test_a_client_and_the_other_packages_ring_exchange_slots(client_pkg, ring_pkg):
    name = ring_name()
    ring = ring_pkg.ShmRing.create(name, slots=2, slot_mb=0.05)
    # one process plays both ends here: the client's attach must not
    # untrack the segment its creator will unlink
    client_pkg._OWNED_NAMES.add(ring.shm.name)
    client = client_pkg.ShmRingClient(name)
    body = pack_frames([("X", X)])
    out = []
    thread = threading.Thread(target=lambda: out.append(client.request("tr-dense", body, "prediction", TIMEOUT)))
    try:
        thread.start()
        t0 = time.monotonic()
        while ring.state(0) != ring_pkg.REQ:
            assert time.monotonic() - t0 < TIMEOUT, "no request arrived"
            time.sleep(0.001)
        assert bytes(ring.request_view(0)) == port_ring.pack_envelope("tr-dense", "prediction", body)
        ring.set_state(0, ring_pkg.BUSY)
        ring.write_response(0, 207, b"the answer")
        thread.join(TIMEOUT)
        assert not thread.is_alive() and out == [(207, b"the answer")]
        assert ring.state(0) == ring_pkg.FREE
    finally:
        client.close()
        client_pkg._OWNED_NAMES.discard(ring.shm.name)
        ring.close()


# --------------------------------------------------------------------------- #
# the transports of one port server
# --------------------------------------------------------------------------- #

@pytest.fixture
def pool(root, uds_path):
    name = ring_name()
    server = serve(root, uds_path=uds_path, shm_ring=name)
    client = port_ring.ShmRingClient(name)
    try:
        yield server, client
    finally:
        client.close()
        server.close()


def test_one_body_gives_the_same_bytes_over_tcp_uds_and_ring(pool):
    server, client = pool
    assert isinstance(server, ServerPool) and server.workers == 1
    for endpoint, path in (("anomaly", "anomaly/prediction"), ("prediction", "prediction")):
        for rows in (1, 30):
            body = pack_frames([("X", X[:rows])])
            url = f"{P}/tr-dense/{path}"
            tcp = call(server.url, "POST", url, body, TENSOR)
            uds = uds_call(server.uds_path, "POST", url, body, TENSOR)
            ring = client.request("tr-dense", body, endpoint, TIMEOUT)
            assert tcp[:2] == uds[:2] == (200, TENSOR_CONTENT_TYPE)
            assert tcp[2] == uds[2] == ring[1] and ring[0] == 200
            frames = unpack_frames(ring[1])
            assert len(frames["data" if endpoint == "prediction" else "total-anomaly-scaled"]) == rows
    # the per-model path too
    body = pack_frames([("X", X)])
    tcp = call(server.url, "POST", f"{P}/tr-bare/prediction", body, TENSOR)
    assert tcp[0] == 200 and tcp[2] == client.request("tr-bare", body, "prediction", TIMEOUT)[1]


def test_uds_answers_400_with_the_reason_then_410(pool):
    server, _ = pool
    url = f"{P}/tr-dense/anomaly/prediction"
    status, _, raw = uds_call(server.uds_path, "POST", url, pack_frames([("X", X)])[:-5], TENSOR)
    assert status == 400 and json.loads(raw)["error"].startswith("tensor body: truncated body")
    quarantine = server.app.quarantine
    for _ in range(quarantine.threshold):
        quarantine.record_failure("tr-dense", "uds-test-poison")
    status, _, raw = uds_call(server.uds_path, "POST", url, pack_frames([("X", X)]), TENSOR)
    assert status == 410 and json.loads(raw)["reason"] == "uds-test-poison"
    quarantine.clear(["tr-dense"])
    assert uds_call(server.uds_path, "POST", url, pack_frames([("X", X)]), TENSOR)[0] == 200


@pytest.mark.parametrize("transport", ["tcp", "uds"])
def test_a_body_no_handler_reads_is_drained_before_the_answer(pool, transport):
    """A 404 target and ``/reload`` read no body: left in the socket, it
    turned the close into a reset that could discard the answer."""
    server, _ = pool
    big = b"\0" * (4 << 20)
    for url, want in ((f"{P}/ghost/anomaly/prediction", 404), (f"{P}/reload", 200)):
        for _ in range(2):
            if transport == "tcp":
                status, _, raw = call(server.url, "POST", url, big, TENSOR)
            else:
                status, _, raw = uds_call(server.uds_path, "POST", url, big, TENSOR)
            assert status == want and json.loads(raw)


def test_uds_request_logs_its_peer_at_debug(pool, caplog):
    server, _ = pool
    with caplog.at_level(logging.DEBUG, logger="gordo_components_torch.server.views"):
        status, _, raw = uds_call(server.uds_path, "GET", f"{P}/models")
    assert status == 200 and json.loads(raw)["transports"]["uds"] == server.uds_path
    lines = [r.getMessage() for r in caplog.records if r.name == "gordo_components_torch.server.views"]
    assert any(line.startswith("unix ") and "/models" in line for line in lines), lines


def test_ring_answers_the_views_error_documents(pool):
    server, client = pool
    good = pack_frames([("X", X)])
    cases = {
        "404": ("ghost", good, "anomaly", f"{P}/ghost/anomaly/prediction"),
        "422": ("tr-bare", good, "anomaly", f"{P}/tr-bare/anomaly/prediction"),
        "400": ("tr-dense", good[:-3], "anomaly", f"{P}/tr-dense/anomaly/prediction"),
        "400-model": ("tr-dense", pack_frames([("X", X[:, :2])]), "prediction", f"{P}/tr-dense/prediction"),
    }
    for key, (target, body, endpoint, url) in cases.items():
        status, raw = client.request(target, body, endpoint, TIMEOUT)
        http_status, _, http_raw = call(server.url, "POST", url, body, TENSOR)
        assert (status, raw) == (http_status, http_raw) and status == int(key[:3]), key
    quarantine = server.app.quarantine
    for _ in range(quarantine.threshold):
        quarantine.record_failure("tr-dense", "ring-test-poison")
    status, raw = client.request("tr-dense", good, "anomaly", TIMEOUT)
    http = json.loads(call(server.url, "POST", f"{P}/tr-dense/anomaly/prediction", good, TENSOR)[2])
    assert status == 410 and json.loads(raw) == {k: v for k, v in http.items() if k != "clear"}
    assert json.loads(raw)["reason"] == "ring-test-poison"
    quarantine.clear()
    # admission reads the sidecar alone: the ring is no fairness bypass
    meta = ("__meta__", np.frombuffer(json.dumps({"tenant": "ring-t"}).encode(), np.uint8))
    statuses = [client.request("tr-dense", pack_frames([meta, ("X", X)]), "anomaly", TIMEOUT) for _ in range(2)]
    assert [s for s, _ in statuses] == [200, 429]
    refused = json.loads(statuses[1][1])
    assert (refused["reason"], refused["tenant"], refused["class"]) == ("tenant_rate", "ring-t", "interactive")
    stats = json.loads(call(server.url, "GET", f"{P}/stats")[2])
    assert stats["shm"]["requests"] == 7 and stats["shm"]["errors"] == 6
    assert stats["transports"] == {"uds": server.uds_path, "shm": server.shm_ring_name}
    text = call(server.url, "GET", f"{P}/metrics")[2].decode()
    assert "gordo_shm_requests_total 7" in text and "gordo_shm_errors_total 6" in text
    assert "gordo_server_worker_requests_total" not in text  # one worker: no tags


def test_a_ring_name_in_use_by_something_else_fails_the_start(root):
    from multiprocessing import shared_memory

    name = ring_name()
    other = shared_memory.SharedMemory(name=name, create=True, size=128)
    try:
        with pytest.raises(port_ring.ShmRingError, match="not a gordo scoring ring"):
            serve(root, shm_ring=name)
    finally:
        other.close()
        other.unlink()


# --------------------------------------------------------------------------- #
# the workers
# --------------------------------------------------------------------------- #

def test_resolve_workers_reads_the_environment(monkeypatch):
    monkeypatch.delenv("GORDO_SERVER_WORKERS", raising=False)
    assert resolve_workers(None) == 1
    monkeypatch.setenv("GORDO_SERVER_WORKERS", "3")
    assert resolve_workers(None) == 3
    assert resolve_workers(2) == 2
    monkeypatch.setenv("GORDO_SERVER_WORKERS", "0")
    assert resolve_workers(None) == 1
    monkeypatch.setenv("GORDO_SERVER_WORKERS", "two")
    with pytest.raises(ValueError, match="GORDO_SERVER_WORKERS must be an integer, got 'two'"):
        resolve_workers(None)


def post_from_threads(base, n, path=f"{P}/tr-dense/anomaly/prediction", threads=8):
    """``n`` tensor POSTs, each on a new connection, from ``threads`` threads."""
    body = pack_frames([("X", X)])
    out, lock = [], threading.Lock()

    def work(k):
        for _ in range(k):
            answer = call(base, "POST", path, body, TENSOR)
            with lock:
                out.append(answer)

    pool = [threading.Thread(target=work, args=(n // threads,)) for _ in range(threads)]
    for th in pool:
        th.start()
    for th in pool:
        th.join(TIMEOUT)
    assert len(out) == n
    return out


def test_every_worker_counts_and_one_engine_scores_for_all(root):
    server = serve(root, workers=2)
    try:
        assert [s.worker for s in server.servers] == ["w0", "w1"]
        assert all(s.app is server.app for s in server.servers)
        answers = post_from_threads(server.url, 48)
        assert {a[:2] for a in answers} == {(200, TENSOR_CONTENT_TYPE)}
        stats = json.loads(call(server.url, "GET", f"{P}/stats")[2])
        workers = stats["workers"]
        assert set(workers) == {"w0", "w1"} and min(workers.values()) > 0
        assert sum(workers.values()) == 49  # the /stats GET counts too
        # one engine, the app's, scored every worker's requests
        assert stats["bank_engine"]["requests"] == 48
        text = call(server.url, "GET", f"{P}/metrics")[2].decode()
        for worker in ("w0", "w1"):
            assert f'gordo_server_worker_requests_total{{worker="{worker}"}}' in text
    finally:
        server.close()


def test_the_acceptor_hands_connections_round_robin(root, monkeypatch):
    monkeypatch.delattr(socket, "SO_REUSEPORT", raising=False)
    server = serve(root, workers=2)
    try:
        assert server.reuse_port is False and server._acceptor is not None
        answers = [call(server.url, "POST", f"{P}/tr-dense/anomaly/prediction", pack_frames([("X", X)]), TENSOR)
                   for _ in range(6)]
        assert all(a == answers[0] for a in answers) and answers[0][0] == 200
        with server.app.stats_lock:
            assert server.app.stats["workers"] == {"w0": 3, "w1": 3}
    finally:
        server.close()


def test_a_reload_through_one_worker_is_seen_by_every_worker(root, tmp_path):
    served = tmp_path / "served"
    shutil.copytree(root, served)
    server = serve(str(served), workers=2)
    try:
        before = post_from_threads(server.url, 16, threads=4)
        serializer.dump(dense_entry("tr-dense", 1), str(served / "tr-dense"))
        status, _, raw = call(server.url, "POST", f"{P}/reload", b"{}", {"Content-Type": "application/json"})
        assert status == 200 and json.loads(raw)["changes"]["updated"] == ["tr-dense"]
        with server.app.stats_lock:
            counted = dict(server.app.stats["workers"])
        after = post_from_threads(server.url, 32, threads=8)
        with server.app.stats_lock:
            now = dict(server.app.stats["workers"])
        # both workers answered after the reload, all from the new bank
        assert all(now[w] > counted[w] for w in ("w0", "w1"))
        assert len({a[2] for a in after}) == 1 and after[0][2] != before[0][2]
        assert server.app.generation() == 1
    finally:
        server.close()


def test_one_worker_has_no_worker_series(root):
    server = serve(root)
    try:
        assert type(server) is GordoServer and server.worker is None
        call(server.url, "POST", f"{P}/tr-dense/anomaly/prediction", pack_frames([("X", X)]), TENSOR)
        stats = json.loads(call(server.url, "GET", f"{P}/stats")[2])
        assert stats["workers"] == {} and "transports" not in stats and "shm" not in stats
        assert "gordo_server_worker_requests_total" not in call(server.url, "GET", f"{P}/metrics")[2].decode()
        assert "transports" not in json.loads(call(server.url, "GET", f"{P}/models")[2])
    finally:
        server.close()
