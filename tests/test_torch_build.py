"""The port's builders on the CPU: ``extract_fleetable`` gives the JAX
package's answer on its own test configurations, and ``build_fleet`` builds
artifacts the port's server answers from, hits its cache on a rerun and
records what it cannot build under ``failed``.

The served scores are held against each built detector's own ``anomaly()``
within atol=1e-5 (the bank multiplies in batches, the detector row by row).
A fleet-built artifact's error scaler and thresholds are held against the
JAX package's FleetTrainer, fitted on the same rows from the same initial
parameters, within rtol=1e-4, atol=1e-5 (the band of test_torch_fleet.py)."""

import importlib
import json
import os
import urllib.request

import numpy as np
import pytest

from gordo_components_torch import __version__, serializer
from gordo_components_torch.builder import build_fleet, build_model, calculate_model_key, provide_saved_model
from gordo_components_torch.builder import fleet_build as port_fb
from gordo_components_torch.convert import feedforward_to_flax
from gordo_components_torch.models import lookup_factory, train_core
from gordo_components_torch.parallel import FleetTrainer
from gordo_components_torch.server import run_server
from gordo_components_torch.workflow import DEFAULT_MODEL_CONFIG, Machine
from gordo_components_tpu.builder import fleet_build as jax_fb
from gordo_components_tpu.parallel import FleetTrainer as JaxFleetTrainer
from gordo_components_tpu.workflow.config import DEFAULT_MODEL_CONFIG as JAX_DEFAULT

_DET = "gordo_components_tpu.models.DiffBasedAnomalyDetector"
_AE = "gordo_components_tpu.models.AutoEncoder"


def _pipe(steps, **det):
    return {_DET: {"base_estimator": {"sklearn.pipeline.Pipeline": {"steps": steps}}, **det}}


# the configurations tests/test_fleet_build.py feeds the JAX extract_fleetable
CONFIGS = [
    JAX_DEFAULT,
    _pipe(["sklearn.preprocessing.MinMaxScaler",
           {_AE: {"kind": "feedforward_symmetric", "dims": [8], "epochs": 2, "batch_size": 64}}]),
    _pipe(["sklearn.preprocessing.StandardScaler", {_AE: {"epochs": 2, "batch_size": 64}}]),
    _pipe(["gordo_components_tpu.models.transformers.JaxStandardScaler",
           {_AE: {"epochs": 2, "batch_size": 64}}]),
    _pipe(["sklearn.preprocessing.MinMaxScaler", {_AE: {"input_scaler": "standard"}}]),
    _pipe([{"sklearn.preprocessing.StandardScaler": {"with_mean": False}}, _AE]),
    {"gordo_components_tpu.models.LSTMAutoEncoder": {"lookback_window": 8}},
    {"gordo_components.model.anomaly.DiffBasedAnomalyDetector": {"base_estimator": {
        "sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler",
            {"gordo_components.model.models.KerasAutoEncoder": {"kind": "feedforward_hourglass"}}]}}}},
    _pipe(["sklearn.preprocessing.MinMaxScaler", {_AE: {"kind": "feedforward_symmetric"}}],
          bespoke_detector_knob=1),
    _pipe(["sklearn.preprocessing.MinMaxScaler", {_AE: {"kind": "feedforward_symmetric"}}],
          threshold_quantile=0.99),
    _pipe([{"sklearn.preprocessing.MinMaxScaler": {"feature_range": [-1, 1]}}, _AE]),
    _pipe(["sklearn.preprocessing.MinMaxScaler", {_AE: {"bespoke_knob": 1}}]),
    _pipe(["sklearn.preprocessing.MinMaxScaler", {_AE: {"data_parallel": True}}]),
    _pipe(["sklearn.preprocessing.MinMaxScaler", {_AE: {"loss": "mse"}}]),
    _pipe(["sklearn.preprocessing.MinMaxScaler", {_AE: {"validation_split": 0.2}}]),
    _pipe([{_AE: {"epochs": 1}}]),
    {_DET: {"base_estimator": {_AE: {"epochs": 1}}}},
    _pipe(["sklearn.preprocessing.MinMaxScaler",
           {"gordo_components_tpu.models.LSTMForecast": {"lookback_window": 12, "epochs": 5}}],
          require_thresholds=True),
    _pipe(["sklearn.preprocessing.MinMaxScaler",
           {"gordo_components.model.models.KerasLSTMAutoEncoder": {"kind": "lstm_hourglass"}}]),
    _pipe(["sklearn.preprocessing.MinMaxScaler", {_AE: {"early_stopping_patience": 3,
                                                        "learning_rate": 0.01}}]),
]


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_extract_fleetable_matches_jax(i):
    config = CONFIGS[i]
    want = jax_fb.extract_fleetable(config)
    assert port_fb.extract_fleetable(config) == want
    if want is not None:
        assert port_fb._group_key(want) == jax_fb._group_key(want)
        assert port_fb._member_hparams_of(want) == jax_fb._member_hparams_of(want)


def test_port_default_config_is_fleetable():
    assert port_fb.extract_fleetable(DEFAULT_MODEL_CONFIG) == {"kind": "feedforward_hourglass"}


def _dataset(name, hours=12, tags=3):
    return {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00Z",
            "train_end_date": f"2020-01-01T{hours:02d}:00:00Z",
            "tag_list": [f"{name}-{j}" for j in range(tags)]}


FLEET_MODEL = {"gordo_components_torch.models.DiffBasedAnomalyDetector": {"base_estimator": {
    "sklearn.pipeline.Pipeline": {"steps": [
        "sklearn.preprocessing.MinMaxScaler",
        {"gordo_components_torch.models.AutoEncoder": {
            "kind": "feedforward_symmetric", "dims": [4], "epochs": 2, "batch_size": 32}}]}}}}


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.load(resp)


def test_build_fleet_serve_and_rerun(tmp_path, monkeypatch):
    machines = [Machine(name=f"m{i}", dataset=_dataset(f"m{i}"), model=FLEET_MODEL) for i in range(3)]
    machines.append(Machine(name="bespoke", dataset=_dataset("bespoke"), model={
        "gordo_components_torch.models.DiffBasedAnomalyDetector": {"base_estimator": {
            "gordo_components_torch.models.AutoEncoder": {"dims": [2], "kind": "feedforward_symmetric",
                                                          "epochs": 1}}}}))
    machines.append({"name": "lstm", "dataset": _dataset("lstm"), "model": _pipe([
        "sklearn.preprocessing.MinMaxScaler",
        {"gordo_components_tpu.models.LSTMAutoEncoder": {"kind": "lstm_hourglass", "lookback_window": 4}}])})
    machines.append(Machine(name="cv", dataset=_dataset("cv"), model=FLEET_MODEL,
                            evaluation={"cross_validation": True, "n_splits": 2}))
    # a top-level config that is not a detector: no port artifact yet
    machines.append(Machine(name="c1", dataset=_dataset("c1"), model={"sklearn.pipeline.Pipeline": {
        "steps": ["sklearn.preprocessing.MinMaxScaler", _AE]}}))
    out, reg = str(tmp_path / "out"), str(tmp_path / "reg")
    report = build_fleet(machines, out, model_register_dir=reg, group_retries=0, device="cpu")
    assert sorted(report) == ["bespoke", "lstm", "m0", "m1", "m2"]
    assert sorted(report.failed) == ["c1", "cv"]
    assert report.failed["c1"].startswith("NotImplementedError") and "Pipeline" in report.failed["c1"]
    assert not os.path.exists(os.path.join(out, "c1"))
    assert "cross-validation" in report.failed["cv"]
    manifest = report.manifest()
    assert (manifest["n_built"], manifest["n_failed"]) == (5, 2)
    lstm_meta = serializer.load_metadata(os.path.join(out, "lstm"))
    assert lstm_meta["registry_type"] == "LSTMAutoEncoder" and lstm_meta["lookback"] == 4
    assert lstm_meta["model"]["fleet_trained"]

    meta = serializer.load_metadata(os.path.join(out, "m0"))
    assert meta["model"]["fleet_trained"] and meta["name"] == "m0"
    assert meta["registry_type"] == "AutoEncoder" and meta["tags"] == ["m0-0", "m0-1", "m0-2"]
    assert meta["model"]["model_builder_cache_key"] == calculate_model_key(
        "m0", FLEET_MODEL, machines[0].dataset, {})
    assert serializer.load_metadata(os.path.join(out, "bespoke"))["gordo_components_torch_version"] == __version__

    server = run_server(out, host="127.0.0.1", port=0, device="cpu", background=True)
    try:
        rng = np.random.RandomState(0)
        for name in ("m0", "m2", "bespoke", "lstm"):
            X = rng.rand(20, 3).astype("f4")
            status, body = _post(f"{server.url}/gordo/v0/p/{name}/anomaly/prediction", {"X": X.tolist()})
            assert status == 200
            want = serializer.load(os.path.join(out, name), device="cpu").anomaly(X)
            np.testing.assert_allclose(body["data"]["total-anomaly-scaled"],
                                       want["total-anomaly-scaled"], rtol=0, atol=1e-5)
    finally:
        server.close()

    # rerun: every built machine is a cache hit, nothing trains
    def no_training(*a, **k):
        raise AssertionError("a cache hit must not train")

    monkeypatch.setattr(FleetTrainer, "fit", no_training)
    monkeypatch.setattr(importlib.import_module("gordo_components_torch.builder.build_model"),
                        "build_model", no_training)
    again = build_fleet(machines[:5], out, model_register_dir=reg, device="cpu")
    assert dict(again) == {k: v for k, v in report.items()} and not again.failed


def test_fleet_built_artifact_matches_jax_fleet_trainer(tmp_path, monkeypatch):
    # batch 128 over 72 rows: each epoch is one step over all real rows, so
    # the shuffle cannot matter; build_fleet's fit is given known initial params
    arch = dict(kind="feedforward_symmetric", dims=(4,))
    model = {"gordo_components_torch.models.DiffBasedAnomalyDetector": {"base_estimator": {
        "sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler",
            {"gordo_components_torch.models.AutoEncoder": {
                **arch, "dims": list(arch["dims"]), "epochs": 3, "batch_size": 128,
                "learning_rate": 1e-2}}]}}}}
    seen = {}
    real_fit = FleetTrainer.fit

    def seeded(self, members, member_hparams=None, initial_params=None):
        stack = train_core.StackedDense(lookup_factory("AutoEncoder", arch["kind"])(3, dims=arch["dims"]))
        states = stack.state_dicts(stack.init([train_core.member_generator(11, i) for i in range(len(members))]))
        seen["members"] = {n: np.asarray(v.values, "f4") for n, v in members.items()}
        seen["initial"] = dict(zip(members, states))
        return real_fit(self, members, member_hparams, initial_params=seen["initial"])

    monkeypatch.setattr(FleetTrainer, "fit", seeded)
    machines = [Machine(name=f"m{i}", dataset=_dataset(f"m{i}"), model=model) for i in range(2)]
    out = str(tmp_path / "out")
    report = build_fleet(machines, out, group_retries=0, device="cpu")
    assert sorted(report) == ["m0", "m1"] and not report.failed
    want = JaxFleetTrainer(epochs=3, batch_size=128, learning_rate=1e-2, input_scaler="minmax", **arch).fit(
        seen["members"], initial_params={n: feedforward_to_flax(sd) for n, sd in seen["initial"].items()})
    band = dict(rtol=1e-4, atol=1e-5)
    for name, w in want.items():
        got = serializer.load(os.path.join(out, name), device="cpu")
        for g, ref in zip(got.error_scaler_, w.error_scaler):
            np.testing.assert_allclose(g, np.asarray(ref), **band)
        np.testing.assert_allclose(got.feature_thresholds_, w.feature_thresholds, **band)
        np.testing.assert_allclose(got.total_threshold_, w.total_threshold, **band)


def test_build_fleet_group_retry_and_unported_options(tmp_path, monkeypatch):
    machines = [Machine(name=f"m{i}", dataset=_dataset(f"m{i}", hours=4), model=FLEET_MODEL) for i in range(2)]
    calls = []
    real_fit = FleetTrainer.fit

    def flaky(self, *a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("transient")
        return real_fit(self, *a, **k)

    monkeypatch.setattr(FleetTrainer, "fit", flaky)
    report = build_fleet(machines, str(tmp_path / "out"), device="cpu")
    assert sorted(report) == ["m0", "m1"] and report.group_retries == 1
    for kw in ({"checkpoint_dir": "x"}, {"distributed": True}, {"state_dir": "x"}):
        with pytest.raises(NotImplementedError):
            build_fleet(machines, str(tmp_path / "o2"), device="cpu", **kw)
    monkeypatch.setenv("GORDO_FAULTS", "fleet_build.group:raise")
    with pytest.raises(NotImplementedError, match="GORDO_FAULTS"):
        build_fleet(machines, str(tmp_path / "o3"), device="cpu")


def test_build_model_and_provide_saved_model(tmp_path):
    ds = _dataset("one", hours=6)
    model, meta = build_model("one", FLEET_MODEL, ds, metadata={"owner": "x"}, device="cpu")
    assert meta["model"]["trained"] and meta["user-defined"] == {"owner": "x"}
    assert meta["dataset"]["rows_after_dropna"] == 36 and meta["name"] == "one"
    assert "total-anomaly-threshold" in meta["model"]
    reg, out = str(tmp_path / "reg"), str(tmp_path / "out")
    path = provide_saved_model("one", FLEET_MODEL, ds, output_dir=out, model_register_dir=reg, device="cpu")
    assert os.path.dirname(path) == reg and serializer.is_artifact_dir(out)
    stamp = os.path.getmtime(os.path.join(path, "params.npz"))
    assert provide_saved_model("one", FLEET_MODEL, ds, output_dir=out, model_register_dir=reg,
                               device="cpu") == path
    assert os.path.getmtime(os.path.join(path, "params.npz")) == stamp
    with pytest.raises(NotImplementedError, match="cross-validation"):
        build_model("one", FLEET_MODEL, ds, evaluation_config={"cv_mode": "cross_val_only"}, device="cpu")
    assert calculate_model_key("one", FLEET_MODEL, ds) != calculate_model_key("two", FLEET_MODEL, ds)


C1_CONFIGS = {
    "pipeline": {"sklearn.pipeline.Pipeline": {"steps": ["sklearn.preprocessing.MinMaxScaler", _AE]}},
    "estimator": {_AE: {"epochs": 1}},
}


@pytest.mark.parametrize("which", sorted(C1_CONFIGS))
def test_non_detector_configs_raise_before_fit_or_write(tmp_path, monkeypatch, which):
    """A top-level config that is not a detector (legal in the JAX package)
    has no port artifact yet: NotImplementedError before any fit or write,
    single and through build_fleet."""
    from gordo_components_torch.models import AutoEncoder

    model = C1_CONFIGS[which]
    fits = []
    monkeypatch.setattr(AutoEncoder, "fit", lambda self, *a, **k: fits.append(1))
    ds = _dataset("c1", hours=4)
    out, reg = str(tmp_path / "out"), str(tmp_path / "reg")
    with pytest.raises(NotImplementedError, match="not ported"):
        provide_saved_model("c1", model, ds, output_dir=out, model_register_dir=reg, device="cpu")
    report = build_fleet([Machine(name="c1", dataset=ds, model=model)], str(tmp_path / "fleet"),
                         model_register_dir=reg, device="cpu")
    assert not report and report.failed["c1"].startswith("NotImplementedError")
    with pytest.raises(NotImplementedError, match="not ported"):
        serializer.dump(serializer.from_definition(model), str(tmp_path / "dump"))
    assert fits == []
    assert not any(os.path.exists(p) for p in (out, reg, str(tmp_path / "fleet"), str(tmp_path / "dump")))


def test_single_build_of_an_lstm_detector(tmp_path):
    model = _pipe(["sklearn.preprocessing.MinMaxScaler", {
        "gordo_components_tpu.models.LSTMForecast": {
            "kind": "lstm_symmetric", "dims": [3], "lookback_window": 6, "epochs": 2, "batch_size": 16}}],
        threshold_quantile=0.95)
    ds = _dataset("seq", hours=8)
    path = provide_saved_model("seq", model, ds, output_dir=str(tmp_path / "out"), device="cpu")
    meta = serializer.load_metadata(path)
    assert (meta["registry_type"], meta["lookback"], meta["target_offset"]) == ("LSTMForecast", 6, 1)
    assert meta["model"]["trained"] and meta["model"]["model_config"] == model
    assert meta["thresholds"]["threshold-method"] == "exact"
    X = np.random.RandomState(1).rand(30, 3).astype("f4")
    scored = serializer.load(path, device="cpu").anomaly(X)
    assert scored["total-anomaly-scaled"].shape == (30 - 6,)
