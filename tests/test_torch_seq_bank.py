"""The port's LSTM serving path against the JAX package's, on the CPU.

Tiny JAX ``LSTMAutoEncoder`` and ``LSTMForecast`` detectors are fitted for
one epoch (two of them behind a sklearn ``MinMaxScaler``), decomposed by the
JAX bank's own ``_extract_entry`` and carried across by ``convert.py``. The
port's ``ModelBank.score_many`` must match the JAX bank, the port detector's
``anomaly()`` the JAX ``anomaly()`` frame (``model-input`` trimmed by the
warm-up offset), and the port server's bodies the JAX server's, within
rtol=1e-4, atol=1e-5: the JAX suite's band for the time-major scan against
the per-member layout (tests/test_seq_fastpath.py), since the two forwards
accumulate their products in another order.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.pipeline import Pipeline
from sklearn.preprocessing import MinMaxScaler

from gordo_components_torch import serializer
from gordo_components_torch.convert import entry_from_numpy
from gordo_components_torch.models import DiffBasedAnomalyDetector as PortDetector
from gordo_components_torch.server import ModelBank as PortBank
from gordo_components_torch.server import run_server
from gordo_components_tpu.models import DiffBasedAnomalyDetector, LSTMAutoEncoder, LSTMForecast
from gordo_components_tpu.server.bank import ModelBank, _extract_entry
from gordo_components_tpu.server.utils import extract_x_y, frame_to_dict

TOL = dict(rtol=1e-4, atol=1e-5)
LOOKBACK = 8
KEYS = ("model-input", "model-output", "tag-anomaly-unscaled", "tag-anomaly-scaled",
        "total-anomaly-unscaled", "total-anomaly-scaled")
# name -> (estimator class, behind a MinMaxScaler)
DETECTORS = {
    "ae": (LSTMAutoEncoder, False),
    "aes": (LSTMAutoEncoder, True),
    "fc": (LSTMForecast, False),
    "fcs": (LSTMForecast, True),
}


def port_entry(name, det):
    e, reason = _extract_entry(name, det)
    assert e is not None, reason
    return entry_from_numpy(
        name, e.registry_type, e.kind, e.factory_kwargs, e.n_features, e.params,
        e.in_shift, e.in_scale, e.err_shift, e.err_scale, tags=det.tags_,
        lookback=e.lookback, target_offset=e.target_offset,
    )


@pytest.fixture(scope="module")
def fleet():
    rng = np.random.RandomState(0)
    models, data = {}, {}
    for name, (cls, scaled) in DETECTORS.items():
        est = cls(kind="lstm_model", dims=(4,), lookback_window=LOOKBACK, epochs=1, batch_size=64)
        if scaled:
            est = Pipeline([("scale", MinMaxScaler()), ("model", est)])
        det = DiffBasedAnomalyDetector(base_estimator=est)
        X = (rng.rand(64, 3) * (2.0 if scaled else 1.0)).astype("float32")
        det.fit(pd.DataFrame(X, columns=[f"{name}-tag-{i}" for i in range(3)]))
        models[name], data[name] = det, X
    return models, data, {n: port_entry(n, d) for n, d in models.items()}


def _requests(data):
    rng = np.random.RandomState(1)
    return [
        ("ae", data["ae"][:30], None),
        ("fcs", data["fcs"][:40], None),
        ("aes", data["aes"][:LOOKBACK], None),  # one output row
        ("fc", data["fc"][:25], data["fc"][5:30] + 0.1),
        ("ae", data["ae"][20:63], rng.rand(43, 3).astype("float32")),
    ]


def _assert_arrays(got, want, what):
    for key in KEYS:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        if key.startswith("total") and w.ndim == 2:
            w = w[:, 0]  # a frame's total column: pandas' collapsed "" level
        assert g.shape == w.shape, (what, key)
        np.testing.assert_allclose(g, w, err_msg=f"{what} {key}", **TOL)


def test_entries_carry_lookback_and_target_offset(fleet):
    _, _, entries = fleet
    assert (entries["ae"].lookback, entries["ae"].target_offset, entries["ae"].offset) == (8, 0, 7)
    assert (entries["fc"].lookback, entries["fc"].target_offset, entries["fc"].offset) == (8, 1, 8)
    bank = PortBank.from_entries(list(entries.values()), device="cpu")
    # autoencoder and forecast are separate buckets, scaled or not
    assert bank.n_buckets == 2
    labels = sorted(b.label for b in bank._buckets.values())
    assert labels == ["LSTMAutoEncoder:lstm_model:f3:l8", "LSTMForecast:lstm_model:f3:l8:o1"]
    with pytest.raises(ValueError, match="scores rows"):
        entry_from_numpy("x", "AutoEncoder", "feedforward_hourglass", {}, 3, {}, *[np.ones(3)] * 4,
                         lookback=8)


def test_score_many_matches_jax_bank(fleet):
    models, data, entries = fleet
    requests = _requests(data)
    want = ModelBank.from_models(models, registry=False, bank_kernel="interpret").score_many(requests)
    got = PortBank.from_entries(list(entries.values()), device="cpu").score_many(requests)
    for (name, X, _), g, w in zip(requests, got, want):
        assert g.offset == w.offset == entries[name].offset
        assert g.tags == list(models[name].tags_)
        _assert_arrays(g.to_arrays(), w.to_arrays(), name)
        np.testing.assert_array_equal(g.to_arrays()["model-input"], X[g.offset:])


def test_chunked_requests_match_jax_bank(fleet):
    """Requests longer than ``max_rows_per_call`` are cut into chunks that
    overlap by the warm-up; the reassembled rows match the JAX bank."""
    models, data, entries = fleet
    requests = [(n, data[n][:61], None) for n in DETECTORS] + [("fc", data["fc"][3:20], None)]
    want = ModelBank.from_models(models, registry=False, bank_kernel="interpret").score_many(requests)
    bank = PortBank.from_entries(list(entries.values()), max_rows_per_call=16, device="cpu")
    for (name, _, _), g, w in zip(requests, bank.score_many(requests), want):
        _assert_arrays(g.to_arrays(), w.to_arrays(), f"chunked {name}")


@pytest.mark.parametrize("name", sorted(DETECTORS))
def test_detector_anomaly_matches_jax_frame(fleet, name):
    models, data, entries = fleet
    X = data[name][:33]
    frame = models[name].anomaly(pd.DataFrame(X, columns=models[name].tags_))
    port = PortDetector.from_entry(entries[name], device="cpu").anomaly(X)
    _assert_arrays(port, {k: frame[k].to_numpy() for k in KEYS}, name)
    np.testing.assert_array_equal(port["model-input"], X[entries[name].offset:])


def test_requests_within_the_warm_up_are_refused(fleet):
    _, data, entries = fleet
    bank = PortBank.from_entries(list(entries.values()), device="cpu")
    with pytest.raises(ValueError, match="need more than 8 rows"):
        bank.score("fc", data["fc"][:8])
    assert bank.score("fc", data["fc"][:9]).model_output.shape == (1, 3)
    with pytest.raises(ValueError, match="need more than 7 rows"):
        PortDetector.from_entry(entries["ae"], device="cpu").anomaly(data["ae"][:7])


def test_lstm_artifact_round_trip(fleet, tmp_path):
    _, data, entries = fleet
    e = entries["fcs"]
    serializer.dump(e, str(tmp_path / "fcs"))
    with open(tmp_path / "fcs" / "detector.json") as f:
        meta = json.load(f)
    assert (meta["lookback"], meta["target_offset"]) == (8, 1)
    with np.load(tmp_path / "fcs" / "params.npz") as npz:
        assert "params/OptimizedLSTMCell_0/hf/kernel" in npz.files
        assert "params/Dense_0/bias" in npz.files
    back = serializer.load_entry(str(tmp_path / "fcs"))
    assert (back.registry_type, back.lookback, back.target_offset) == ("LSTMForecast", 8, 1)
    for k in e.params:
        np.testing.assert_array_equal(back.params[k], e.params[k])
    X = data["fcs"][:20]
    a = serializer.load(str(tmp_path / "fcs"), device="cpu").anomaly(X)
    b = PortDetector.from_entry(e, device="cpu").anomaly(X)
    for key in KEYS:
        np.testing.assert_array_equal(a[key], b[key])


def test_artifacts_without_sequence_keys_load_as_feedforward(tmp_path):
    """A ``gordo-torch-artifact/v1`` directory written before sequence
    models (no ``lookback``/``target_offset`` in ``detector.json``)."""
    rng = np.random.RandomState(5)
    F = 3
    params = {"params": {
        "Dense_0": {"kernel": rng.randn(F, 2).astype("f4"), "bias": np.zeros(2, "f4")},
        "Dense_1": {"kernel": rng.randn(2, F).astype("f4"), "bias": np.zeros(F, "f4")},
    }}
    entry = entry_from_numpy("old", "AutoEncoder", "feedforward_model",
                             {"encoding_dim": [2], "decoding_dim": []}, F, params,
                             np.zeros(F), np.ones(F), np.zeros(F), np.ones(F))
    serializer.dump(entry, str(tmp_path / "old"))
    path = tmp_path / "old" / "detector.json"
    meta = json.loads(path.read_text())
    del meta["lookback"], meta["target_offset"]
    path.write_text(json.dumps(meta))
    back = serializer.load_entry(str(tmp_path / "old"))
    assert (back.lookback, back.target_offset, back.offset) == (1, 0, 0)
    X = rng.rand(5, F).astype("f4")
    got = serializer.load(str(tmp_path / "old"), device="cpu").anomaly(X)
    assert got["model-output"].shape == (5, F)
    np.testing.assert_array_equal(got["model-input"], X)


def test_lstm_detector_defaults_to_cuda(fleet, tmp_path, monkeypatch):
    serializer.dump(fleet[2]["ae"], str(tmp_path / "ae"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serializer.load(str(tmp_path / "ae"))
    serializer.load(str(tmp_path / "ae"), device="cpu")


# ------------------------------------------------------------------ #
# HTTP: the index is trimmed to the output rows
# ------------------------------------------------------------------ #


def _call(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _assert_same_body(got, want, path="body"):
    """Same keys and nesting, equal index, floats within TOL."""
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_same_body(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list) and want and isinstance(want[0], float):
        np.testing.assert_allclose(got, want, err_msg=path, **TOL)
    else:
        assert got == want, path


@pytest.fixture(scope="module")
def served(fleet, tmp_path_factory):
    root = tmp_path_factory.mktemp("lstm-models")
    for name, entry in fleet[2].items():
        serializer.dump(entry, str(root / name))
    server = run_server(str(root), host="127.0.0.1", port=0, device="cpu", background=True)
    try:
        yield server
    finally:
        server.close()


@pytest.mark.parametrize("name", ["aes", "fc"])
def test_http_bodies_match_jax_with_trimmed_index(fleet, served, name):
    models, data, entries = fleet
    X = data[name][:20]
    index = [f"2020-01-01T00:{m:02d}:00Z" for m in range(20)]
    body = {"X": X.tolist(), "index": index}
    base = f"{served.url}/gordo/v0/proj/{name}"
    status, got = _call(base + "/anomaly/prediction", body)
    assert status == 200, got
    Xf, yf = extract_x_y(body)
    want = frame_to_dict(models[name].anomaly(Xf, yf))
    _assert_same_body(got, want)
    off = entries[name].offset
    assert got["index"] == [s.replace("Z", "+00:00") for s in index[off:]]
    status, got = _call(base + "/prediction", body)
    assert status == 200, got
    np.testing.assert_allclose(got["data"], models[name].predict(X), **TOL)
    assert got["index"] == [str(t) for t in pd.to_datetime(index, utc=True)[off:]]


def test_http_request_within_the_warm_up_answers_400(fleet, served):
    _, data, _ = fleet
    status, body = _call(f"{served.url}/gordo/v0/proj/fc/anomaly/prediction",
                         {"X": data["fc"][:8].tolist()})
    assert status == 400
    assert "need more than 8 rows" in body["error"]
