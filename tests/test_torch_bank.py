"""The port's bank and detector against the JAX package's, on the CPU.

A few tiny JAX detectors are fitted (two behind a sklearn ``MinMaxScaler``),
decomposed by the JAX bank's own ``_extract_entry`` and carried across by
``convert.py``. The port's ``ModelBank.score_many`` over a mixed two-bucket
batch must match the JAX bank (Pallas kernel in interpreter mode), and the
port detector's ``anomaly()`` the JAX ``anomaly()`` frame, within atol=1e-5
(matrix products accumulate in another order; the JAX detector applies
sklearn's scaler in its own arithmetic, the bank its composed affine).
"""

import threading
import time

import numpy as np
import pandas as pd
import pytest
from sklearn.pipeline import Pipeline
from sklearn.preprocessing import MinMaxScaler

from gordo_components_torch import serializer
from gordo_components_torch.convert import entry_from_numpy
from gordo_components_torch.models import DiffBasedAnomalyDetector as PortDetector
from gordo_components_torch.server import BatchingEngine, EngineOverloaded
from gordo_components_torch.server import ModelBank as PortBank
from gordo_components_tpu.models import AutoEncoder, DiffBasedAnomalyDetector
from gordo_components_tpu.server.bank import ModelBank, _extract_entry

ATOL = 1e-5
KEYS = ("model-input", "model-output", "tag-anomaly-unscaled", "tag-anomaly-scaled",
        "total-anomaly-unscaled", "total-anomaly-scaled")


def port_entry(name, det):
    e, reason = _extract_entry(name, det)
    assert e is not None, reason
    return entry_from_numpy(
        name, e.registry_type, e.kind, e.factory_kwargs, e.n_features, e.params,
        e.in_shift, e.in_scale, e.err_shift, e.err_scale, tags=det.tags_,
    )


@pytest.fixture(scope="module")
def fleet():
    rng = np.random.RandomState(0)
    data = {"a": rng.rand(96, 4), "b": rng.rand(96, 4), "c": rng.rand(96, 6), "d": rng.rand(96, 6)}
    models = {}
    for name, X in data.items():
        ae = AutoEncoder(epochs=1, batch_size=64)
        est = Pipeline([("scale", MinMaxScaler()), ("model", ae)]) if name in "bd" else ae
        det = DiffBasedAnomalyDetector(base_estimator=est)
        cols = [f"{name}-tag-{i}" for i in range(X.shape[1])]
        det.fit(pd.DataFrame(X.astype("float32"), columns=cols))
        models[name] = det
    data = {k: v.astype("float32") for k, v in data.items()}
    return models, data, {n: port_entry(n, d) for n, d in models.items()}


def _requests(data):
    rng = np.random.RandomState(1)
    return [
        ("a", data["a"][:37], None),
        ("c", data["c"][:20], None),
        ("b", data["b"][:64], None),
        ("d", data["d"][:5], data["d"][5:10] + 0.1),
        ("a", data["a"][40:41], rng.rand(1, 4).astype("float32")),
    ]


def test_entries_carry_across(fleet):
    models, _, entries = fleet
    assert entries["c"].n_features == 6
    assert entries["b"].tags == ["b-tag-0", "b-tag-1", "b-tag-2", "b-tag-3"]
    # the sklearn scaler is composed into the input affine, not identity
    assert not np.allclose(entries["b"].in_scale, 1.0)
    assert np.allclose(entries["a"].in_scale, 1.0)
    assert PortBank.from_entries(list(entries.values()), device="cpu").n_buckets == 2


def test_score_many_matches_jax_bank(fleet):
    models, data, entries = fleet
    requests = _requests(data)
    want = ModelBank.from_models(models, registry=False, bank_kernel="interpret").score_many(requests)
    bank = PortBank.from_entries(list(entries.values()), device="cpu")
    got = bank.score_many(requests)
    for (name, X, _), g, w in zip(requests, got, want):
        assert g.tags == list(models[name].tags_)
        ga, wa = g.to_arrays(), w.to_arrays()
        for key in KEYS:
            assert ga[key].shape == np.asarray(wa[key]).shape, (name, key)
            np.testing.assert_allclose(ga[key], wa[key], atol=ATOL, rtol=0, err_msg=f"{name} {key}")


def test_chunked_requests_match_unchunked(fleet):
    _, data, entries = fleet
    requests = _requests(data)
    whole = PortBank.from_entries(list(entries.values()), device="cpu").score_many(requests)
    chunked = PortBank.from_entries(
        list(entries.values()), max_rows_per_call=16, device="cpu"
    ).score_many(requests)
    for g, w in zip(chunked, whole):
        for key in KEYS:
            np.testing.assert_allclose(g.to_arrays()[key], w.to_arrays()[key], atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["a", "b", "c", "d"])
def test_detector_anomaly_matches_jax_frame(fleet, name):
    models, data, entries = fleet
    X = data[name][:33]
    frame = models[name].anomaly(pd.DataFrame(X, columns=models[name].tags_))
    port = PortDetector.from_entry(entries[name], device="cpu").anomaly(X)
    for key in KEYS:
        want = np.squeeze(frame[key].to_numpy())  # totals: pandas' collapsed "" column
        np.testing.assert_allclose(port[key], want, atol=ATOL, rtol=0, err_msg=key)


def test_artifact_round_trip(fleet, tmp_path):
    _, data, entries = fleet
    e = entries["b"]
    serializer.dump(e, str(tmp_path / "b"))
    back = serializer.load_entry(str(tmp_path / "b"))
    assert (back.name, back.kind, back.n_features, back.tags) == (e.name, e.kind, e.n_features, e.tags)
    for k in e.params:
        np.testing.assert_array_equal(back.params[k], e.params[k])
    for k in ("in_shift", "in_scale", "err_shift", "err_scale"):
        np.testing.assert_array_equal(getattr(back, k), getattr(e, k))
    with np.load(tmp_path / "b" / "params.npz") as npz:
        assert sorted(npz.files)[:2] == ["params/Dense_0/bias", "params/Dense_0/kernel"]
    X = data["b"][:9]
    a = serializer.load(str(tmp_path / "b"), device="cpu").anomaly(X)
    b = PortDetector.from_entry(e, device="cpu").anomaly(X)
    for key in KEYS:
        np.testing.assert_array_equal(a[key], b[key])


def test_bank_rejects_bad_requests(fleet):
    _, data, entries = fleet
    bank = PortBank.from_entries(list(entries.values()), device="cpu")
    with pytest.raises(KeyError):
        bank.score("ghost", data["a"][:5])
    with pytest.raises(ValueError, match="expected"):
        bank.score("a", data["c"][:5])
    with pytest.raises(ValueError, match="empty"):
        bank.score("a", data["a"][:0])
    with pytest.raises(ValueError, match="y shape"):
        bank.score("a", data["a"][:5], data["a"][:4])
    with pytest.raises(ValueError, match="duplicate"):
        PortBank.from_entries([entries["a"], entries["a"]], device="cpu")


def test_engine_coalesces_and_matches_direct_scoring(fleet):
    _, data, entries = fleet
    bank = PortBank.from_entries(list(entries.values()), device="cpu")
    engine = BatchingEngine(bank, max_batch=8, flush_ms=20.0)
    engine.start()
    try:
        requests = [(n, data[n][i:i + 7], None) for i in range(6) for n in "abcd"]
        bad = ("a", data["c"][:3], None)  # wrong width: fails alone
        futures = [engine.submit(*r) for r in requests + [bad]]
        results = [f.result(30) for f in futures[:-1]]
        with pytest.raises(ValueError):
            futures[-1].result(30)
    finally:
        engine.stop()
    assert engine.stats["requests"] == len(requests) + 1
    assert engine.stats["batches"] < len(requests)  # requests were coalesced
    for (name, X, _), res in zip(requests, results):
        np.testing.assert_allclose(
            res.total_scaled, bank.score(name, X).total_scaled, atol=1e-6, rtol=0
        )


def test_engine_sheds_when_the_queue_is_full(fleet):
    _, data, entries = fleet
    release = threading.Event()

    class SlowBank:
        def score_many(self, requests, deadline=None, return_exceptions=False):
            release.wait(30)
            return [None] * len(requests)

    engine = BatchingEngine(SlowBank(), max_batch=1, flush_ms=0.0, max_queue=1)
    engine.start()
    try:
        first = engine.submit("a", data["a"][:2])
        give_up = time.monotonic() + 30
        while engine._queue.qsize() and time.monotonic() < give_up:
            time.sleep(0.01)  # until the worker has taken the first request
        engine.submit("a", data["a"][:2])  # fills the queue
        with pytest.raises(EngineOverloaded) as info:
            engine.submit("a", data["a"][:2])
        assert info.value.retry_after_s > 0
        assert engine.stats["shed"] == 1
    finally:
        release.set()
        first.result(30)
        engine.stop()
