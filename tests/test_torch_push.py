"""Score-on-ingest push on the port's server against the JAX server's, on the CPU.

Two JAX detectors are fitted (tests/test_saturate.py's ``sat-a`` and
``sat-b``, one epoch), written as JAX artifacts and converted with
``tools/jax_artifact_to_torch.py``. Each case of tests/test_saturate.py's
push block runs on both servers (the JAX one through aiohttp's test server
on a local socket, the port's on its own) and their answers are held
together:

- ``GORDO_STREAM=1`` alone: no broker, the long poll's 404 names
  ``GORDO_PUSH``, no ``gordo_push_*`` series;
- a long poll parked before an ingest receives that window scored
  (``rows``, ``scored``, the watermark, ``anomalies``, the threshold
  equal; the scores within the bank's band), a second ingest only its new
  rows; ``/drift``'s push block and the series;
- ``GORDO_PUSH_QUEUE=1``: three windows into a one-deep queue keep the
  freshest and count two drops;
- ``GORDO_PUSH_SUBSCRIBERS_MAX=2``: the third subscriber's 429 (body and
  ``Retry-After``); an unknown target's 404;
- the port's ``PushSubscriber`` against both: one poll delivers, the
  minted id is kept; failed polls reconnect on a seeded decorrelated
  jitter within base and cap.
"""

import asyncio
import contextlib
import importlib.util
import json
import os
import random
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from gordo_components_torch.client.http import Session
from gordo_components_torch.client.subscribe import PushSubscriber
from gordo_components_torch.server import run_server
from gordo_components_tpu import serializer as jax_serializer
from gordo_components_tpu.models import AutoEncoder, DiffBasedAnomalyDetector
from gordo_components_tpu.server import build_app as jax_build_app

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = importlib.util.spec_from_file_location(
    "jax_artifact_to_torch", os.path.join(REPO, "tools", "jax_artifact_to_torch.py"))
TOOL = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(TOOL)

P = "/gordo/v0/p"
N_FEATURES = 4
BAND = dict(rtol=0, atol=1e-5)  # the bank's (tests/test_torch_bank.py)
PUSH = {"GORDO_STREAM": "1", "GORDO_PUSH": "1", "GORDO_PUSH_INTERVAL_S": "0.05", "GORDO_SERVER_WARMUP": "0"}


def _x(n=30, seed=1):
    return np.random.RandomState(seed).rand(n, N_FEATURES).astype("float32")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    rng = np.random.RandomState(0)
    X = rng.rand(200, N_FEATURES).astype("float32")
    jax_root, port_root = tmp_path_factory.mktemp("jax-push"), tmp_path_factory.mktemp("port-push")
    for name in ("sat-a", "sat-b"):
        det = DiffBasedAnomalyDetector(base_estimator=AutoEncoder(epochs=1, batch_size=64))
        det.fit(X + (0.01 if name == "sat-b" else 0.0))
        jax_serializer.dump(det, str(jax_root / name), metadata={"name": name})
    assert TOOL.main([str(jax_root), str(port_root)]) == 0
    return str(jax_root), str(port_root)


@contextlib.contextmanager
def env_set(values):
    before = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _Jax:
    """The JAX server behind aiohttp's test server, and its app."""

    def __init__(self, client):
        self.client = client
        self.app = client.server.app
        self.url = str(client.make_url("")).rstrip("/")

    async def get(self, path):
        resp = await self.client.get(path)
        return resp.status, dict(resp.headers), json.loads(await resp.read() or b"null")

    async def post(self, path, body):
        resp = await self.client.post(path, json=body)
        return resp.status, dict(resp.headers), await resp.json()


class _Port:
    """The port's server, its answers in the same shape."""

    def __init__(self, server):
        self.server = server
        self.app = server.app
        self.url = server.url

    def _call(self, method, path, body=None):
        raw = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(self.url + path, data=raw, method=method,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, dict(resp.headers), json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            return exc.code, dict(exc.headers), json.loads(exc.read())

    async def get(self, path):
        return await asyncio.to_thread(self._call, "GET", path)

    async def post(self, path, body):
        return await asyncio.to_thread(self._call, "POST", path, body)


def both(roots, env, scenario):
    """``scenario(server)`` (a coroutine function) on the JAX server, then
    on the port's, under ``env``: (JAX's result, the port's)."""
    jax_root, port_root = roots

    async def on_jax():
        client = TestClient(TestServer(jax_build_app(jax_root, devices=1)))
        await client.start_server()
        try:
            return await scenario(_Jax(client))
        finally:
            await client.close()

    with env_set(env):
        jax = asyncio.run(on_jax())
        server = run_server(port_root, host="127.0.0.1", port=0, device="cpu", background=True)
    try:
        port = asyncio.run(scenario(_Port(server)))
    finally:
        server.close()
    return jax, port


async def _ingest(s, target, rows, stamps):
    status, _, body = await s.post(f"{P}/{target}/ingest", {"rows": rows, "timestamps": stamps})
    assert status == 200, body
    return body


def _plane(s):
    return s.app["stream"] if isinstance(s, _Jax) else s.app.stream


def _same_doc(got, want):
    assert {k: v for k, v in got.items() if k not in ("total_scaled", "at")} == \
        {k: v for k, v in want.items() if k not in ("total_scaled", "at")}
    np.testing.assert_allclose(got["total_scaled"], want["total_scaled"], **BAND)


def test_push_default_off(roots):
    async def scenario(s):
        status, _, body = await s.get(f"{P}/sat-a/results/stream")
        plane = _plane(s)
        rendered = (s.app["metrics"] if isinstance(s, _Jax) else s.app.metrics).render()
        return status, body, plane.broker is None, "gordo_push_" in rendered

    jax, port = both(roots, {**PUSH, "GORDO_PUSH": None}, scenario)
    assert port == jax == (404, {"error": "push mode not enabled (GORDO_PUSH=0)"}, True, False)


def test_push_scores_on_ingest_and_long_polls(roots):
    now = float(int(time.time()))

    async def scenario(s):
        rows = _x(40).tolist()
        poll = asyncio.ensure_future(s.get(f"{P}/sat-a/results/stream?subscriber=s1&timeout=8"))
        await asyncio.sleep(0.3)
        await _ingest(s, "sat-a", rows, [now + i for i in range(40)])
        first = await poll
        await _ingest(s, "sat-a", rows[:10], [now + 40 + i for i in range(10)])
        second = await s.get(f"{P}/sat-a/results/stream?subscriber=s1&timeout=8")
        _, _, drift = await s.get(f"{P}/drift")
        rendered = (s.app["metrics"] if isinstance(s, _Jax) else s.app.metrics).render()
        return first, second, drift["push"], [f in rendered for f in ("gordo_push_windows_scored_total",
                                                                     "gordo_push_dropped_total")]

    jax, port = both(roots, PUSH, scenario)
    for got, want in zip(port[:2], jax[:2]):
        assert got[0] == want[0] == 200
        g, w = got[2], want[2]
        assert (g["subscriber"], g["target"], g["dropped"]) == (w["subscriber"], w["target"], w["dropped"])
        assert len(g["results"]) == len(w["results"]) == 1
        _same_doc(g["results"][0], w["results"][0])
    doc = port[0][2]["results"][0]
    assert doc["rows"] == doc["scored"] == 40 and abs(doc["watermark"] - (now + 39)) < 1e-6
    assert port[1][2]["results"][0]["rows"] == 10
    assert port[2]["enabled"] and port[2]["windows_scored"] >= 2 and sorted(port[2]) == sorted(jax[2])
    assert port[3] == jax[3] == [True, True]


def test_push_bounded_queue_drops_oldest(roots):
    now = float(int(time.time()))

    async def scenario(s):
        plane = _plane(s)
        assert plane.broker.subscribe("slow", "sat-a")
        for b in range(3):
            await _ingest(s, "sat-a", _x(8).tolist(), [now + b * 8 + i for i in range(8)])
            for _ in range(200):
                if plane.push_stats["windows_scored"] >= b + 1:
                    break
                await asyncio.sleep(0.05)
        status, _, body = await s.get(f"{P}/sat-a/results/stream?subscriber=slow&timeout=1")
        return status, body, plane.broker.dropped_total

    jax, port = both(roots, {**PUSH, "GORDO_PUSH_QUEUE": "1"}, scenario)
    assert port[0] == jax[0] == 200 and port[2] == jax[2] == 2
    assert port[1]["dropped"] == jax[1]["dropped"] == 2 and len(port[1]["results"]) == 1
    _same_doc(port[1]["results"][0], jax[1]["results"][0])
    assert abs(port[1]["results"][0]["watermark"] - (now + 23)) < 1e-6


def test_push_subscriber_table_bounded_and_unknown_target(roots):
    async def scenario(s):
        out = [await s.get(f"{P}/sat-a/results/stream?subscriber=a&timeout=0"),
               await s.get(f"{P}/sat-b/results/stream?subscriber=b&timeout=0"),
               await s.get(f"{P}/sat-a/results/stream?subscriber=c&timeout=0"),
               await s.get(f"{P}/nope/results/stream?timeout=0"),
               await s.get(f"{P}/sat-a/results/stream?subscriber=a&timeout=x")]
        return [(status, headers.get("Retry-After"), body) for status, headers, body in out]

    jax, port = both(roots, {**PUSH, "GORDO_PUSH_SUBSCRIBERS_MAX": "2"}, scenario)
    assert [s for s, _, _ in port] == [s for s, _, _ in jax] == [200, 200, 429, 404, 400]
    assert port[2] == jax[2] and "GORDO_PUSH_SUBSCRIBERS_MAX" in port[2][2]["error"]
    assert port[2][1] == "1" and port[3][2] == jax[3][2] and port[4][2] == jax[4][2]


def test_push_subscriber_delivers_keeps_identity_and_reconnects_with_jitter(roots):
    now = float(int(time.time()))

    async def scenario(s):
        async with Session(timeout=30) as session:
            sub = PushSubscriber(s.url, "p", "sat-a", poll_timeout_s=8.0)
            poll = asyncio.ensure_future(sub.poll_once(session))
            await asyncio.sleep(0.3)
            await _ingest(s, "sat-a", _x(40).tolist(), [now + i for i in range(40)])
            batch = await poll
            minted = sub.subscriber
            sub.poll_timeout_s = 0.0  # nothing more is pushed: answer at once
            await sub.poll_once(session)

            async def drive(seed, n=6):
                herd = PushSubscriber(s.url, "p", "nope", poll_timeout_s=0.0, reconnect_base_s=0.005,
                                      reconnect_cap_s=0.05, rng=random.Random(seed))
                stop = asyncio.Event()
                task = asyncio.ensure_future(herd.run(session, stop=stop))
                deadline = time.monotonic() + 10
                while len(herd.reconnect_delays) < n and time.monotonic() < deadline:
                    await asyncio.sleep(0.01)
                stop.set()
                task.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await task
                return herd

            a, b, replay = await drive(7), await drive(8), await drive(7)
        return batch, minted, sub.subscriber, sub.stats["polls"], a, b, replay

    for batch, minted, kept, polls, a, b, replay in both(roots, PUSH, scenario):
        assert len(batch) == 1 and batch[0]["rows"] == 40 and polls == 2
        assert minted and kept == minted
        assert a.stats["failures"] >= 6 and a.stats["reconnects"] >= 6 and a.last_status == 404
        assert len(set(round(d, 9) for d in a.reconnect_delays)) >= 4
        assert a.reconnect_delays[:6] != b.reconnect_delays[:6]
        assert a.reconnect_delays[:6] == replay.reconnect_delays[:6]
        assert all(0.0 < d <= 0.05 for d in a.reconnect_delays)
