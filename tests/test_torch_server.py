"""The port's HTTP server against the JAX server's response bodies.

A tiny JAX detector is fitted, carried across to a port artifact directory
and served by the port on the CPU (port 0). An ``anomaly/prediction`` body
must have exactly the keys and nesting of the JAX server's
``frame_to_dict(detector.anomaly(X))`` for the same model and request, index
included, with values within atol=1e-5; ``/prediction`` must match the JAX
detector's reconstruction.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest
from sklearn.pipeline import Pipeline
from sklearn.preprocessing import MinMaxScaler

from gordo_components_torch import __version__, serializer
from gordo_components_torch.convert import entry_from_numpy
from gordo_components_torch.server import EngineOverloaded, run_server
from gordo_components_tpu.models import AutoEncoder, DiffBasedAnomalyDetector
from gordo_components_tpu.server.bank import _extract_entry
from gordo_components_tpu.server.utils import extract_x_y, frame_to_dict

ATOL = 1e-5
TAGS = ["tag-a", "tag-b", "tag-c", "tag-d", "tag-e"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    rng = np.random.RandomState(7)
    X = rng.rand(80, len(TAGS)).astype("float32")
    det = DiffBasedAnomalyDetector(
        base_estimator=Pipeline([("scale", MinMaxScaler()),
                                 ("model", AutoEncoder(epochs=1, batch_size=64))])
    )
    det.fit(pd.DataFrame(X, columns=TAGS))
    e, reason = _extract_entry("machine-1", det)
    assert e is not None, reason
    root = tmp_path_factory.mktemp("models")
    serializer.dump(
        entry_from_numpy("machine-1", e.registry_type, e.kind, e.factory_kwargs, e.n_features,
                         e.params, e.in_shift, e.in_scale, e.err_shift, e.err_scale,
                         tags=det.tags_),
        str(root / "machine-1"),
    )
    server = run_server(str(root), host="127.0.0.1", port=0, device="cpu", background=True)
    try:
        yield server, det, X, str(root)
    finally:
        server.close()


def call(server, path, body=None, raw=None):
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(server.url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), json.load(resp)
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), json.loads(exc.read())


def assert_same_body(got, want, path="body"):
    """Same keys and nesting, index equal, floats within ATOL."""
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_same_body(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list) and want and isinstance(want[0], float):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=path)
    else:
        assert got == want, path


BODIES = {
    "iso-index": lambda X: {"X": X.tolist(), "index": [
        f"2020-01-01T{h:02d}:{m:02d}:00Z" for h in range(3) for m in range(0, 60, 10)][:len(X)]},
    "offset-index": lambda X: {"X": X.tolist(), "index": [
        f"2021-06-0{1 + i % 9}T12:00:00+02:00" for i in range(len(X))]},
    "no-index": lambda X: {"X": X.tolist()},
    "column-dict": lambda X: {"X": {t: X[:, i].tolist() for i, t in enumerate(TAGS)}},
    "with-y": lambda X: {"X": X.tolist(), "y": (X + 0.05).tolist()},
}


@pytest.mark.parametrize("kind", sorted(BODIES))
def test_anomaly_body_matches_jax_frame_to_dict(served, kind):
    server, det, X, _ = served
    body = BODIES[kind](X[:13])
    status, _, got = call(server, "/gordo/v0/proj/machine-1/anomaly/prediction", body)
    assert status == 200, got
    # what the JAX server answers for the same body (views.anomaly_prediction)
    Xf, yf = extract_x_y(body)
    assert_same_body(got, frame_to_dict(det.anomaly(Xf, yf)))


def test_prediction_matches_jax_reconstruction(served):
    server, det, X, _ = served
    body = BODIES["iso-index"](X[:6])
    status, _, got = call(server, "/gordo/v0/proj/machine-1/prediction", body)
    assert status == 200, got
    np.testing.assert_allclose(got["data"], det.predict(X[:6]), atol=ATOL, rtol=0)
    assert got["index"] == [str(t) for t in pd.to_datetime(body["index"], utc=True)]


def test_models_healthcheck_and_metadata(served):
    server, _, _, root = served
    status, _, body = call(server, "/gordo/v0/proj/models")
    assert status == 200
    assert body["project"] == "proj" and body["models"] == ["machine-1"]
    assert body["bank"] == {"banked": 1, "n_buckets": 1, "device": "cpu"}
    status, _, body = call(server, "/gordo/v0/proj/machine-1/healthcheck")
    assert (status, body) == (200, {"gordo-server-version": __version__})
    status, _, body = call(server, "/gordo/v0/proj/machine-1/metadata")
    assert status == 200
    assert body["endpoint-metadata"]["tags"] == TAGS
    assert body["endpoint-metadata"]["kind"] == "feedforward_hourglass"
    assert body["env"] == {"model_collection_dir": root}


@pytest.mark.parametrize(
    "path, raw, status",
    [
        ("/gordo/v0/proj/machine-1/anomaly/prediction", b"not json", 400),
        ("/gordo/v0/proj/machine-1/anomaly/prediction", b'{"Y": [[1, 2]]}', 400),
        ("/gordo/v0/proj/machine-1/anomaly/prediction", b'{"X": [[1, 2, 3]]}', 400),
        ("/gordo/v0/proj/machine-1/prediction", b'{"X": [["a", "b"]]}', 400),
        ("/gordo/v0/proj/ghost/anomaly/prediction", b'{"X": [[1, 2, 3, 4, 5]]}', 404),
        ("/gordo/v0/proj/ghost/healthcheck", None, 404),
        ("/gordo/v0/nowhere", None, 404),
        ("/gordo/v0/proj/models", b"{}", 405),
    ],
)
def test_error_statuses(served, path, raw, status):
    server = served[0]
    got, _, body = call(server, path, raw=raw)
    assert got == status, body
    assert "error" in body


def test_overloaded_engine_answers_429_with_retry_after(served, monkeypatch):
    server, _, X, _ = served

    def shed(*args, **kwargs):
        raise EngineOverloaded(512, 1.2)

    monkeypatch.setattr(server.app.engine, "score_blocking", shed)
    status, headers, body = call(
        server, "/gordo/v0/proj/machine-1/anomaly/prediction", {"X": X[:2].tolist()}
    )
    assert status == 429
    assert headers["Retry-After"] == "2"
    assert body["reason"] == "engine_overloaded"


def test_served_dir_is_a_port_artifact(served):
    root = served[3]
    assert sorted(os.listdir(os.path.join(root, "machine-1"))) == [
        "detector.json", "params.npz", "scalers.npz"
    ]
