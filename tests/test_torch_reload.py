"""``POST /reload`` of the port's server, on the CPU: the cases of the JAX
package's ``tests/test_reload.py``.

A running server picks up new, updated and removed artifacts, rebuilds its
bank to the side and swaps it in (``server/swap.py``): under a continuous
load of three client threads no response is other than 200 while the
generation goes to 1 and then 2, each flip pausing under 250 ms (the JAX
test's limit). A corrupt artifact is reported under ``failed`` and in
``/healthz``'s ``load_failures`` while the rest keep serving, its earlier
version too; a bank whose build fails leaves the old one serving. The
new bank is warmed before the flip (its arena holds the warm shapes before
its first request) unless ``GORDO_SERVER_WARMUP=0``, and a warm-up that
raises fails the reload with a 500, the old bank serving.

The detectors are the port's own, fitted once on seeded rows (one epoch,
120 rows of 3 tags) and dumped into each test's directory.
"""

import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from gordo_components_torch import serializer
from gordo_components_torch.models import AutoEncoder, DiffBasedAnomalyDetector
from gordo_components_torch.models.transformers import MinMaxScaler, Pipeline
from gordo_components_torch.server import ModelBank, run_server

X = [[0.1, 0.2, 0.3]] * 4


def _detector(seed, scale=1.0):
    rows = (np.random.RandomState(seed).rand(120, 3) * scale).astype("float32")
    return DiffBasedAnomalyDetector(base_estimator=AutoEncoder(epochs=1, batch_size=64, device="cpu")).fit(rows)


@pytest.fixture(scope="module")
def fitted():
    rows = np.random.RandomState(5).rand(120, 3).astype("float32")
    pipe = Pipeline([("s", MinMaxScaler()), ("m", AutoEncoder(epochs=1, batch_size=64, device="cpu"))]).fit(rows)
    return {"m-a": _detector(0), "m-b": _detector(1), "m-a2": _detector(7, scale=100.0),
            "m-a3": _detector(2), "pipe": pipe}


def dump(fitted, src, root, name):
    serializer.dump(fitted[src], str(root / name), metadata={"name": name})


@pytest.fixture()
def serve(fitted, tmp_path):
    """A server on ``tmp_path`` holding ``m-a``; yields (server, root)."""
    dump(fitted, "m-a", tmp_path, "m-a")
    servers = []

    def start(**kwargs):
        servers.append(run_server(str(tmp_path), host="127.0.0.1", port=0, device="cpu",
                                  background=True, **kwargs))
        return servers[-1]

    try:
        yield start, tmp_path
    finally:
        for server in servers:
            server.close()


def call(server, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(server.url + path, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def reload(server):
    return call(server, "/gordo/v0/p/reload", {})


def test_reload_picks_up_new_and_removed(serve, fitted):
    start, root = serve
    server = start()
    assert call(server, "/gordo/v0/p/models")[1]["models"] == ["m-a"]
    assert call(server, "/gordo/v0/p/m-b/healthcheck")[0] == 404
    dump(fitted, "m-b", root, "m-b")
    dump(fitted, "pipe", root, "pipe")
    status, body = reload(server)
    assert status == 200
    assert body["changes"]["added"] == ["m-b", "pipe"]
    assert body["models"] == ["m-a", "m-b", "pipe"]
    assert body["bank_models"] == 2 and body["swap"]["generation"] == 1
    status, body = call(server, "/gordo/v0/p/m-b/anomaly/prediction", {"X": X})
    assert status == 200 and "total-anomaly-scaled" in body["data"]
    assert call(server, "/gordo/v0/p/pipe/prediction", {"X": X})[0] == 200
    shutil.rmtree(root / "m-a")
    status, body = reload(server)
    assert body["changes"]["removed"] == ["m-a"]
    assert call(server, "/gordo/v0/p/m-a/healthcheck")[0] == 404


def test_reload_updated_artifact_changes_scores(serve, fitted):
    start, root = serve
    server = start()
    r1 = call(server, "/gordo/v0/p/m-a/anomaly/prediction", {"X": X})[1]
    time.sleep(0.01)  # a new mtime on every file system
    dump(fitted, "m-a2", root, "m-a")
    assert reload(server)[1]["changes"]["updated"] == ["m-a"]
    r2 = call(server, "/gordo/v0/p/m-a/anomaly/prediction", {"X": X})[1]
    assert r1["data"]["model-output"] != r2["data"]["model-output"]


def test_reload_noop(serve):
    start, _ = serve
    server = start()
    status, body = reload(server)
    assert status == 200
    assert body["changes"] == {"added": [], "updated": [], "removed": [], "failed": {}}


def test_reload_swaps_generation_with_zero_non_200s(serve, fitted):
    start, root = serve
    dump(fitted, "m-b", root, "m-b")
    server = start()
    statuses, stop = [], threading.Event()

    def load():
        i = 0
        while not stop.is_set():
            name = ("m-a", "m-b")[i % 2]
            i += 1
            statuses.append(call(server, f"/gordo/v0/p/{name}/anomaly/prediction", {"X": X})[0])

    loaders = [threading.Thread(target=load) for _ in range(3)]
    for t in loaders:
        t.start()
    try:
        for gen in (1, 2):
            time.sleep(0.05)
            status, body = reload(server)
            assert status == 200 and body["swap"]["generation"] == gen, body
            assert body["swap"]["pause_ms"] < 250.0, body
        time.sleep(0.2)
    finally:
        stop.set()
        for t in loaders:
            t.join()
    assert statuses and set(statuses) == {200}, (sorted(set(statuses)), len(statuses))
    app = server.app
    assert app.bank.generation == 2 and app.engine.bank is app.bank


def test_reload_isolates_corrupt_artifact(serve, fitted):
    start, root = serve
    server = start()
    dump(fitted, "m-b", root, "m-good")
    (root / "m-bad").mkdir()
    (root / "m-bad" / "detector.json").write_text("not json")
    status, body = reload(server)
    assert status == 200
    assert body["changes"]["added"] == ["m-good"] and "m-bad" in body["changes"]["failed"]
    assert set(body["models"]) == {"m-a", "m-good"}
    status, health = call(server, "/healthz")
    assert (status, health["status"]) == (200, "degraded") and "m-bad" in health["load_failures"]

    # a corrupt update of a served model: its earlier version keeps serving
    (root / "m-a" / "params.npz").write_bytes(b"garbage mid-write")
    later = time.time() + 5
    os.utime(root / "m-a" / "params.npz", (later, later))
    body = reload(server)[1]
    assert "m-a" in body["changes"]["failed"] and "m-a" in body["models"]
    assert call(server, "/gordo/v0/p/m-a/anomaly/prediction", {"X": X})[0] == 200

    # fixed, the next reload takes it: the failed load recorded no mtime
    dump(fitted, "m-a3", root, "m-a")
    body = reload(server)[1]
    assert "m-a" in body["changes"]["updated"] and "m-a" not in body["changes"]["failed"]
    assert "m-bad" in body["changes"]["failed"]


def test_reload_keeps_the_old_bank_when_the_build_fails(serve, monkeypatch):
    start, _ = serve
    server = start()
    old = server.app.bank

    def fail(models, **kwargs):
        raise MemoryError("no room for the new bank")

    monkeypatch.setattr(ModelBank, "from_models", fail)
    status, body = reload(server)
    assert status == 500 and "MemoryError" in body["error"] and body["generation"] == 0
    assert server.app.bank is old and server.app.engine.bank is old
    assert call(server, "/gordo/v0/p/m-a/anomaly/prediction", {"X": X})[0] == 200


def test_reload_starts_the_engine_with_the_first_banked_model(fitted, tmp_path):
    dump(fitted, "pipe", tmp_path, "pipe")
    server = run_server(str(tmp_path), host="127.0.0.1", port=0, device="cpu", background=True)
    try:
        assert server.app.engine is None and len(server.app.bank) == 0
        dump(fitted, "m-b", tmp_path, "m-b")
        assert reload(server)[1]["bank_models"] == 1
        assert server.app.engine is not None and server.app.engine.bank is server.app.bank
        assert call(server, "/gordo/v0/p/m-b/anomaly/prediction", {"X": X})[0] == 200
    finally:
        server.close()


def test_reload_with_the_bank_off(serve, fitted):
    start, root = serve
    server = start(use_bank=False)
    dump(fitted, "m-b", root, "m-b")
    status, body = reload(server)
    assert status == 200 and body["bank_models"] is None and "swap" not in body
    assert body["changes"]["added"] == ["m-b"]
    assert call(server, "/gordo/v0/p/m-b/anomaly/prediction", {"X": X})[0] == 200


def _warm_shapes(bank):
    """The (shape, dtype) keys a warm-up fills the arena with: each
    bucket's (B, T, F) input and target and (B,) index buffers at every
    warm (T, B)."""
    keys = set()
    for bucket in bank._buckets.values():
        for T, B in bank.warmup_shapes(bucket, (256,), (1,)):
            keys |= {((B, T, bucket.n_features), "float32"), ((B,), "int32")}
    return keys


def _arena_keys(bank):
    return {(shape, np.dtype(dtype).name) for shape, dtype in bank.arena._pool}


def test_reload_warms_the_new_bank_before_the_flip(serve, fitted, monkeypatch):
    """C5: the reloaded bank is built and warmed before the swap, so its
    arena holds the warm shapes before its first request, and the swap
    records both times; the body keeps the JAX keys."""
    monkeypatch.delenv("GORDO_SERVER_WARMUP", raising=False)
    start, root = serve
    server = start()
    dump(fitted, "m-b", root, "m-b")
    dump(fitted, "pipe", root, "pipe")
    status, body = reload(server)
    assert status == 200 and sorted(body) == ["bank_models", "changes", "models", "swap"]
    assert sorted(body["swap"]) == ["generation", "pause_ms"] and body["swap"]["generation"] == 1
    bank = server.app.bank
    stats = bank.arena.stats()
    assert _arena_keys(bank) == _warm_shapes(bank) and stats["misses"] == stats["pooled_buffers"] == 3
    assert stats["hits"] == 0 and stats["outstanding"] == 0
    assert bank.build_s > 0 and bank.warmup_s > 0
    # the first request after the flip (200 rows: T = 256) takes the warmed buffers
    assert call(server, "/gordo/v0/p/m-b/anomaly/prediction", {"X": [[0.1, 0.2, 0.3]] * 200})[0] == 200
    assert bank.arena.stats()["hits"] == 3 and bank.arena.stats()["misses"] == 3


def test_reload_serves_cold_with_the_warmup_off(serve, fitted, monkeypatch):
    monkeypatch.setenv("GORDO_SERVER_WARMUP", "0")
    start, root = serve
    server = start()
    dump(fitted, "m-b", root, "m-b")
    status, body = reload(server)
    assert status == 200 and body["swap"]["generation"] == 1
    bank = server.app.bank
    assert bank.arena.stats()["misses"] == bank.arena.stats()["pooled_buffers"] == 0
    assert bank.warmup_s < bank.build_s


def test_reload_keeps_the_old_bank_when_the_warmup_raises(serve, fitted, monkeypatch):
    monkeypatch.delenv("GORDO_SERVER_WARMUP", raising=False)
    start, root = serve
    server = start()
    server.app._warmup.join()
    old = server.app.bank
    dump(fitted, "m-b", root, "m-b")

    def fail(self, *args, **kwargs):
        raise RuntimeError("warm-up failed on the card")

    monkeypatch.setattr(ModelBank, "warmup", fail)
    status, body = reload(server)
    assert status == 500 and "RuntimeError: warm-up failed" in body["error"] and body["generation"] == 0
    assert body["changes"]["added"] == ["m-b"]
    assert server.app.bank is old and server.app.engine.bank is old
    assert call(server, "/gordo/v0/p/m-a/anomaly/prediction", {"X": X})[0] == 200
