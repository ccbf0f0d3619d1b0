"""The port's collection routes against the JAX server's, on the CPU.

The JAX server's own test collection (``tests/test_server.py``: a detector
as ``machine-a``, a bare ``AutoEncoder`` as ``machine-b``), with a bare
``Pipeline(MinMaxScaler, AutoEncoder)`` as ``machine-c``, is fitted in JAX
on the same seeded rows and written as JAX artifacts. The JAX server serves
that directory; ``tools/jax_artifact_to_torch.py`` converts it, and the
port serves the result. Both get the same requests:

- ``/models``, ``/ready``, ``/healthz`` and ``metadata-all?digest=1``
  answer the same bodies (``accepts`` lists JSON, the tensor format and
  parquet in both, and ``devices`` is 1 where the JAX bank spans the test mesh's CPU devices);
  ``metadata-all`` without the digest the same keys, each target's
  metadata holding the JAX server's;
- ``prediction`` on the per-model path (``machine-b``, ``machine-c``) and
  ``anomaly/prediction`` through the bank (``machine-a``) answer the same
  keys and index, values within atol=1e-5; an anomaly request to a model
  without ``anomaly`` answers 422 with the JAX server's error;
- ``download-model`` answers 200 on both; the port's bytes load
  (``serializer.loads``) into a model that predicts bitwise as the served
  one.

With the bank off (``GORDO_SERVER_BANK=0``) the detector's bodies come from
its own ``anomaly()``/``predict`` and agree with the banked bodies within
the JAX suite's bank-vs-per-model band, rtol=1e-4, atol=1e-5
(``tests/test_bank.py``).
"""

import asyncio
import importlib.util
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer
from jax import device_count as jax_device_count
from sklearn.pipeline import Pipeline as SkPipeline
from sklearn.preprocessing import MinMaxScaler as SkMinMaxScaler

from gordo_components_torch import serializer
from gordo_components_torch.server import build_app, run_server
from gordo_components_tpu import serializer as jax_serializer
from gordo_components_tpu.models import AutoEncoder, DiffBasedAnomalyDetector
from gordo_components_tpu.server import build_app as jax_build_app

ATOL = 1e-5
BAND = dict(rtol=1e-4, atol=1e-5)  # bank vs per-model, tests/test_bank.py
_SPEC = importlib.util.spec_from_file_location(
    "jax_artifact_to_torch",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                 "jax_artifact_to_torch.py"))
TOOL = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(TOOL)

X_BODY = {"X": np.random.RandomState(1).rand(20, 3).tolist(),
          "index": [f"2020-01-01T00:{m:02d}:00Z" for m in range(20)]}
GETS = ["/gordo/v0/proj/models", "/gordo/v0/proj/ready", "/healthz", "/gordo/v0/proj/healthz",
        "/gordo/v0/proj/metadata-all", "/gordo/v0/proj/metadata-all?digest=1"]
POSTS = [(f"/gordo/v0/proj/{t}/{route}", X_BODY) for t in ("machine-a", "machine-b", "machine-c")
         for route in ("prediction", "anomaly/prediction")]
DOWNLOADS = [f"/gordo/v0/proj/{t}/download-model" for t in ("machine-a", "machine-b", "machine-c")]


async def _jax_answers(root):
    """(status, body) of every request above, from the JAX server."""
    client = TestClient(TestServer(jax_build_app(root)))
    await client.start_server()
    try:
        out = {}
        for path in GETS:
            resp = await client.get(path)
            out[path] = resp.status, await resp.json()
        for path, body in POSTS:
            resp = await client.post(path, json=body)
            out[path] = resp.status, await resp.json()
        for path in DOWNLOADS:
            resp = await client.get(path)
            out[path] = resp.status, len(await resp.read())
        return out
    finally:
        await client.close()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    Xv = np.random.RandomState(0).rand(200, 3).astype("float32")
    jax_root, port_root = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    models = {
        "machine-a": DiffBasedAnomalyDetector(base_estimator=AutoEncoder(epochs=2, batch_size=64)),
        "machine-b": AutoEncoder(epochs=2, batch_size=64),
        "machine-c": SkPipeline([("scale", SkMinMaxScaler()), ("model", AutoEncoder(epochs=1, batch_size=64))]),
    }
    for name, model in models.items():
        model.fit(Xv)
        jax_serializer.dump(model, str(jax_root / name), metadata={"name": name})
    assert TOOL.main([str(jax_root), str(port_root)]) == 0
    jax = asyncio.run(_jax_answers(str(jax_root)))
    for status, body in jax.values():
        if isinstance(body, dict) and "bank" in body:
            # the JAX bank shards over the test mesh's virtual CPU devices
            # (tests/conftest.py); the port's bank is on one device
            assert body["bank"]["devices"] == jax_device_count()
            body["bank"]["devices"] = 1
    server = run_server(str(port_root), host="127.0.0.1", port=0, device="cpu", background=True)
    try:
        yield server, models, jax, str(port_root)
    finally:
        server.close()


def call(server, path, body=None):
    """(status, JSON body or raw bytes) of one request to the port."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(server.url + path, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            raw = resp.read()
            is_json = resp.headers["Content-Type"] == "application/json"
            return resp.status, json.loads(raw) if is_json else raw
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def assert_same_body(got, want, path="body", **tol):
    """Same keys and nesting, floats within the band, the rest equal."""
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_same_body(got[k], want[k], f"{path}.{k}", **tol)
    elif isinstance(want, list) and want and isinstance(want[0], (float, list)):
        np.testing.assert_allclose(got, want, err_msg=path, **(tol or {"rtol": 0, "atol": ATOL}))
    else:
        assert got == want, path


def test_models_matches_jax(served):
    server, _, jax, _ = served
    status, body = call(server, "/gordo/v0/proj/models")
    jax_status, jax_body = jax["/gordo/v0/proj/models"]
    assert status == jax_status == 200
    # JSON, the tensor format and parquet, in the JAX order
    assert body.pop("accepts") == ["application/json", "application/x-gordo-tensor", "application/x-parquet"] == jax_body.pop("accepts")
    assert body == jax_body
    assert body["bank"]["fallback"] == {"machine-b": "not a DiffBasedAnomalyDetector (AutoEncoder)",
                                        "machine-c": "not a DiffBasedAnomalyDetector (Pipeline)"}


@pytest.mark.parametrize("path", ["/gordo/v0/proj/ready", "/healthz", "/gordo/v0/proj/healthz",
                                  "/gordo/v0/proj/metadata-all?digest=1"])
def test_control_routes_match_jax(served, path):
    server, _, jax, _ = served
    assert call(server, path) == jax[path]


def test_metadata_all_holds_the_jax_metadata(served):
    server, _, jax, _ = served
    status, body = call(server, "/gordo/v0/proj/metadata-all")
    _, want = jax["/gordo/v0/proj/metadata-all"]
    assert status == 200 and body["bank"] == want["bank"] and sorted(body) == sorted(want)
    for name, target in want["targets"].items():
        got = body["targets"][name]
        assert got["healthy"] is True
        assert got["endpoint-metadata"].items() >= target["endpoint-metadata"].items()


def test_ready_and_healthz_without_models(served):
    server = served[0]
    collection = server.app.collection
    state = collection._state
    collection._state = ({}, {})
    try:
        assert call(server, "/gordo/v0/proj/ready") == (503, {"ready": False, "models": 0})
        status, body = call(server, "/healthz")
        assert (status, body["status"]) == (503, "unhealthy")
    finally:
        collection._state = state


@pytest.mark.parametrize("path, body", POSTS, ids=[p for p, _ in POSTS])
def test_scoring_matches_jax(served, path, body):
    """Bank path (machine-a), per-model path (b, c) and the 422."""
    server, _, jax, _ = served
    status, got = call(server, path, body)
    jax_status, want = jax[path]
    assert status == jax_status
    assert_same_body(got, want)


def test_per_model_bad_body_and_width(served):
    server = served[0]
    assert call(server, "/gordo/v0/proj/machine-b/prediction", {"nope": 1})[0] == 400
    status, body = call(server, "/gordo/v0/proj/machine-c/prediction", {"X": [[1.0, 2.0]]})
    assert status == 400 and "error" in body


@pytest.mark.parametrize("path", DOWNLOADS)
def test_download_model_round_trips(served, path):
    server, _, jax, _ = served
    status, raw = call(server, path)
    assert status == jax[path][0] == 200
    target = path.split("/")[-2]
    model, _ = server.app.collection.entry(target)
    back = serializer.loads(raw, device="cpu")
    assert type(back) is type(model)
    X = np.asarray(X_BODY["X"], np.float32)
    np.testing.assert_array_equal(back.predict(X), model.predict(X))


@pytest.mark.parametrize("name", ["machine-a", "machine-b", "machine-c"])
def test_converted_models_match_jax(served, name):
    """tools/jax_artifact_to_torch.py: the port's model scores as JAX's."""
    _, models, _, root = served
    X = np.asarray(X_BODY["X"], np.float32)
    port = serializer.load(os.path.join(root, name), device="cpu")
    np.testing.assert_allclose(port.predict(X), models[name].predict(X), rtol=0, atol=ATOL)
    if name == "machine-a":
        frame = models[name].anomaly(X)
        for key, got in port.anomaly(X).items():
            want = frame[key].to_numpy() if key.startswith(("model", "tag")) else frame[(key, "")].to_numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=key)


def test_bank_off_scores_per_model_within_the_bank_band(served, monkeypatch):
    server, _, _, root = served
    paths = [f"/gordo/v0/proj/machine-a/{r}" for r in ("anomaly/prediction", "prediction")]
    banked = [call(server, p, X_BODY) for p in paths]
    monkeypatch.setenv("GORDO_SERVER_BANK", "0")
    bank_app, server.app = server.app, build_app(root, device="cpu")
    try:
        assert server.app.bank is None and server.app.engine is None
        assert "bank" not in call(server, "/gordo/v0/proj/models")[1]
        for path, (status, want) in zip(paths, banked):
            got_status, got = call(server, path, X_BODY)
            assert got_status == status == 200
            assert_same_body(got, want, **BAND)
        assert server.app.collection.models["machine-a"]._scorer is not None
    finally:
        server.app.close()
        server.app = bank_app


def test_banked_models_build_no_per_model_module(served):
    """A model the bank holds never builds its own module; a bare
    estimator builds its module at its first request."""
    root = served[3]
    app = build_app(root, device="cpu")
    try:
        X = np.asarray(X_BODY["X"], np.float32)
        app.engine.score_blocking("machine-a", X)
        models = app.collection.models
        assert models["machine-a"]._scorer is None
        assert models["machine-b"]._module is None
        models["machine-b"].predict(X)
        assert models["machine-b"]._module is not None
    finally:
        app.close()
