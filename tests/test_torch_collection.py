"""Models the bank cannot hold, in the port, against the JAX package on the CPU.

A bare estimator and a bare ``Pipeline`` are legal model configs in the JAX
package (``tests/test_builder.py``, ``tests/test_server.py``). Here the same
small models are fitted in JAX on the same seeded rows and carried across
to the port by ``tools/jax_artifact_to_torch.py``'s functions; the port
writes them as ``model.json`` artifacts, loads the class that was dumped,
and its ``predict`` matches JAX's within atol=1e-5 (the port's scaler
computes ``(x - shift) * scale``, sklearn's ``x * scale_ + min_``, and the
products accumulate in another order). A load, and ``loads(dumps(...))``,
predicts bitwise as the model that was dumped. Single and fleet builds of
such configs build, write and load; cross-validating a bare Pipeline gives
the JAX builder's metric set; ``ModelBank.from_models`` gives each model
the reason JAX's ``_extract_entry`` gives it.
"""

import importlib.util
import io
import os
import tarfile

import numpy as np
import pytest
from sklearn.pipeline import Pipeline as SkPipeline
from sklearn.preprocessing import MinMaxScaler as SkMinMaxScaler

from gordo_components_torch import serializer
from gordo_components_torch.builder import build_fleet, build_model, provide_saved_model
from gordo_components_torch.models import AutoEncoder, DiffBasedAnomalyDetector, LSTMAutoEncoder
from gordo_components_torch.models.transformers import MinMaxScaler, Pipeline
from gordo_components_torch.serializer.artifacts import unpack_artifact_dir
from gordo_components_torch.server import ModelBank
from gordo_components_torch.server import bank as port_bank
from gordo_components_torch.workflow import Machine
from gordo_components_tpu.builder.build_model import build_model as jax_build_model
from gordo_components_tpu.models import AutoEncoder as JaxAutoEncoder
from gordo_components_tpu.models import DiffBasedAnomalyDetector as JaxDetector
from gordo_components_tpu.server.bank import _extract_entry as jax_extract_entry

ATOL = 1e-5
_SPEC = importlib.util.spec_from_file_location(
    "jax_artifact_to_torch",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                 "jax_artifact_to_torch.py"))
TOOL = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(TOOL)

_AE = "gordo_components_tpu.models.AutoEncoder"
NON_DETECTORS = {
    "pipeline": {"sklearn.pipeline.Pipeline": {"steps": [
        "sklearn.preprocessing.MinMaxScaler", {_AE: {"epochs": 1, "batch_size": 32}}]}},
    "estimator": {_AE: {"epochs": 1, "batch_size": 32}},
}
DATA = {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00Z",
        "train_end_date": "2020-01-01T12:00:00Z", "tag_list": ["a", "b", "c"]}


@pytest.fixture(scope="module")
def fitted():
    """JAX models fitted on the same rows, their port copies, and a
    port-fitted Pipeline over an LSTM (the sequence path)."""
    X = np.random.RandomState(0).rand(200, 3).astype("float32")
    jax_models = {
        "detector": JaxDetector(base_estimator=SkPipeline([
            ("scale", SkMinMaxScaler()), ("model", JaxAutoEncoder(epochs=1, batch_size=64))])),
        "estimator": JaxAutoEncoder(epochs=1, batch_size=64),
        "pipeline": SkPipeline([("scale", SkMinMaxScaler()), ("model", JaxAutoEncoder(epochs=1, batch_size=64))]),
    }
    for m in jax_models.values():
        m.fit(X)
    port = {name: TOOL.convert_model(m) for name, m in jax_models.items()}
    port["detector"] = DiffBasedAnomalyDetector.from_entry(port["detector"], device="cpu")
    port["lstm-pipeline"] = Pipeline([("s", MinMaxScaler()), ("m", LSTMAutoEncoder(
        kind="lstm_symmetric", dims=[3], lookback_window=4, epochs=1, batch_size=64, device="cpu"))]).fit(X)
    return X, jax_models, port


@pytest.mark.parametrize("name", ["estimator", "pipeline", "lstm-pipeline", "detector"])
def test_artifact_round_trip(fitted, name, tmp_path):
    X, jax_models, port = fitted
    model = port[name]
    serializer.dump(model, str(tmp_path / "a"), metadata={"name": name})
    files = sorted(os.listdir(tmp_path / "a"))
    want = {"estimator": ["metadata.json", "model.json", "params.npz"],
            "detector": ["detector.json", "metadata.json", "params.npz", "scalers.npz"]}
    assert files == want.get(name, ["metadata.json", "model.json", "params.npz", "scalers.npz"])
    assert serializer.is_artifact_dir(str(tmp_path / "a"))
    meta = serializer.load_metadata(str(tmp_path / "a"))
    assert meta["name"] == name
    for back in (serializer.load(str(tmp_path / "a"), device="cpu"),
                 serializer.loads(serializer.dumps(model), device="cpu")):
        assert type(back) is type(model)
        np.testing.assert_array_equal(back.predict(X[:40]), model.predict(X[:40]))
    if name in jax_models:
        np.testing.assert_allclose(model.predict(X[:40]), jax_models[name].predict(X[:40]), rtol=0, atol=ATOL)
    if name == "pipeline":
        assert meta["model_type"] == "Pipeline" and meta["steps"][0]["class"] == "MinMaxScaler"
        assert type(back.steps[0][1]) is MinMaxScaler and back.steps[-1][0] == "model"


@pytest.mark.parametrize("member", ["../evil.json", "/abs.json", "link"])
def test_unpack_refuses_unsafe_archive_members(member, tmp_path):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        info = tarfile.TarInfo(member)
        if member == "link":
            info.type, info.linkname = tarfile.SYMTYPE, "/etc/passwd"
            tar.addfile(info)
        else:
            info.size = 2
            tar.addfile(info, io.BytesIO(b"{}"))
    with pytest.raises(ValueError, match="refusing"):
        unpack_artifact_dir(buf.getvalue(), str(tmp_path / "out"))
    assert not os.listdir(tmp_path / "out")


def test_dump_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(TypeError):
        serializer.dump(object(), str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="not been fitted"):
        serializer.dump(AutoEncoder(device="cpu"), str(tmp_path / "b"))
    unfitted = Pipeline([("s", MinMaxScaler()), ("m", AutoEncoder(device="cpu"))])
    with pytest.raises(TypeError, match="fitted scaler"):
        serializer.dump(unfitted, str(tmp_path / "c"))
    assert not any(os.path.exists(tmp_path / d) for d in "abc")


@pytest.mark.parametrize("which", sorted(NON_DETECTORS))
def test_non_detector_configs_build_single_and_in_fleet(which, tmp_path):
    """A top-level config that is not a detector builds, is written as
    model.json and loads as the class the config names, single and
    through build_fleet (its single-build path), as in the JAX package."""
    model = NON_DETECTORS[which]
    kind = {"pipeline": Pipeline, "estimator": AutoEncoder}[which]
    out, reg = str(tmp_path / "out"), str(tmp_path / "reg")
    path = provide_saved_model("c1", model, DATA, output_dir=out, model_register_dir=reg, device="cpu")
    report = build_fleet([Machine(name="c1", dataset=DATA, model=model)], str(tmp_path / "fleet"),
                         model_register_dir=reg, device="cpu")
    assert dict(report) == {"c1": path} and not report.failed  # the same config: a cache hit
    X = np.random.RandomState(1).rand(20, 3).astype("float32")
    for d in (path, out, os.path.join(tmp_path, "fleet", "c1")):
        loaded = serializer.load(d, device="cpu")
        assert type(loaded) is kind and loaded.predict(X).shape == (20, 3)
    meta = serializer.load_metadata(out)["model"]
    assert meta["trained"] and meta["model_config"] == model
    assert (meta["final_step"] if which == "pipeline" else meta)["type"] == "AutoEncoder"


def test_cross_validation_bare_pipeline_gets_the_full_metric_set():
    """tests/test_builder.py's bare-Pipeline case: the Pipeline routes to
    its final estimator, so cross-validation records the four metrics."""
    config = NON_DETECTORS["pipeline"]
    evaluation = {"cross_validation": True, "n_splits": 2}
    _, md = build_model("m", config, DATA, evaluation_config=evaluation, device="cpu")
    _, jax_md = jax_build_model("m", config, DATA, evaluation_config=evaluation)
    cv, jax_cv = md["model"]["cross-validation"], jax_md["model"]["cross-validation"]
    assert set(cv) == set(jax_cv)
    for metric in ("explained-variance", "r2-score", "mean-squared-error", "mean-absolute-error"):
        assert len(cv[metric]["per-fold"]) == 2
        assert cv[metric]["mean"] == pytest.approx(np.mean(cv[metric]["per-fold"]))


class _Unbankable:
    """An estimator class neither bank knows."""

    def predict(self, X):
        return X


def _unsupported(detector_cls, err):
    det = detector_cls(base_estimator=_Unbankable())
    det.error_scaler_ = err
    return det


@pytest.mark.parametrize("case", ["detector", "estimator", "pipeline", "unfitted", "unsupported"])
def test_from_models_reasons_match_jax_extract_entry(fitted, case):
    _, jax_models, port = fitted
    jax_model, port_model = {
        "unfitted": (JaxDetector(), DiffBasedAnomalyDetector()),
        "unsupported": (_unsupported(JaxDetector, jax_models["detector"].error_scaler_),
                        _unsupported(DiffBasedAnomalyDetector, port["detector"].error_scaler_)),
    }.get(case, (jax_models.get(case), port.get(case)))
    want = jax_extract_entry("m", jax_model)[1]
    entry, reason = port_bank._extract_entry("m", port_model)
    assert reason == want
    bank = ModelBank.from_models({"m": port_model}, device="cpu")
    assert bank.coverage() == {"banked": int(want is None), "fallback": {} if want is None else {"m": want},
                               "n_buckets": int(want is None), "devices": 1, "device": "cpu"}


def test_from_models_isolates_a_failing_extraction_and_bucket(fitted, monkeypatch):
    _, _, port = fitted
    lstm = DiffBasedAnomalyDetector(base_estimator=port["lstm-pipeline"])
    lstm.fit(np.random.RandomState(2).rand(60, 3).astype("float32"))
    broken = DiffBasedAnomalyDetector.from_entry(port["detector"].to_entry(), device="cpu")
    monkeypatch.setattr(broken, "to_entry", lambda name=None: 1 / 0)
    real = port_bank._make_bucket

    def make(entries, device, *storage):
        if entries[0].registry_type == "LSTMAutoEncoder":
            raise MemoryError("no room")
        return real(entries, device, *storage)

    monkeypatch.setattr(port_bank, "_make_bucket", make)
    models = {"dense": port["detector"], "lstm": lstm, "broken": broken, "bare": port["estimator"]}
    bank = ModelBank.from_models(models, device="cpu")
    assert "dense" in bank and len(bank) == 1 and bank.n_buckets == 1
    assert bank.fallback == {
        "broken": "extraction error: ZeroDivisionError: division by zero",
        "bare": "not a DiffBasedAnomalyDetector (AutoEncoder)",
        "lstm": "bucket finalize failed: MemoryError: no room",
    }
    assert list(bank.finalize_failures.values()) == ["bucket finalize failed: MemoryError: no room"]
    assert next(iter(bank.finalize_failures)).startswith("LSTMAutoEncoder:")
    X = np.random.RandomState(3).rand(8, 3).astype("float32")
    np.testing.assert_allclose(bank.score("dense", X).total_scaled,
                               port["detector"].anomaly(X)["total-anomaly-scaled"], rtol=0, atol=ATOL)
