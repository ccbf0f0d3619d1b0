"""The port's estimators, scalers, detector fit and config definitions
against the JAX package's, on the CPU.

Bands: the detector's error scaler and thresholds, given the same base
parameters, within rtol=1e-5, atol=1e-6 (its pipeline's min-max scaler
computes ``(x - shift) * scale`` where sklearn computes ``x * scale_ +
min_``, and the products round differently); the port's scalers against
sklearn's within rtol=1e-5, atol=1e-6.
"""

import jax
import numpy as np
import pandas as pd
import pytest
from sklearn.pipeline import Pipeline as SkPipeline
from sklearn.preprocessing import MinMaxScaler as SkMinMax
from sklearn.preprocessing import StandardScaler as SkStandard

from gordo_components_torch.convert import feedforward_from_flax
from gordo_components_torch.models import (
    AutoEncoder,
    ConvAutoEncoder,
    DiffBasedAnomalyDetector,
)
from gordo_components_torch.models.transformers import MinMaxScaler, Pipeline, StandardScaler
from gordo_components_torch.serializer import from_definition, import_locate
from gordo_components_tpu.models import AutoEncoder as JaxAE
from gordo_components_tpu.models import DiffBasedAnomalyDetector as JaxDetector
from gordo_components_tpu.workflow.config import DEFAULT_MODEL_CONFIG as JAX_DEFAULT

BAND = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def frame():
    rng = np.random.RandomState(0)
    t = np.arange(300)[:, None]
    X = np.sin(0.03 * t * np.arange(1, 5)) + 0.05 * rng.randn(300, 4)
    return pd.DataFrame(X.astype("f4"), columns=[f"tag-{i}" for i in range(4)])


@pytest.mark.parametrize("q", [1.0, 0.9])
@pytest.mark.parametrize("scaled", [True, False])
def test_detector_fit_matches_jax_given_the_same_base_params(frame, q, scaled):
    jax_ae = JaxAE(kind="feedforward_symmetric", dims=(3,), epochs=2, batch_size=64)
    jax_det = JaxDetector(
        base_estimator=SkPipeline([("s", SkMinMax()), ("m", jax_ae)]) if scaled else jax_ae,
        threshold_quantile=q,
    ).fit(frame)

    ae = AutoEncoder(kind="feedforward_symmetric", dims=(3,), device="cpu")
    ae.params_ = feedforward_from_flax(jax.tree.map(np.asarray, jax_ae.params_))
    ae.n_features_ = 4
    ae.fit = lambda X, y=None: ae  # keep the JAX parameters: only the detector fits
    det = DiffBasedAnomalyDetector(
        base_estimator=Pipeline([("s", MinMaxScaler()), ("m", ae)]) if scaled else ae,
        threshold_quantile=q,
    ).fit(frame)
    for got, want in zip(det.error_scaler_, jax_det.error_scaler_):
        np.testing.assert_allclose(got, want, **BAND)
    np.testing.assert_allclose(det.feature_thresholds_, jax_det.feature_thresholds_, **BAND)
    np.testing.assert_allclose(det.total_threshold_, jax_det.total_threshold_, **BAND)
    assert det.threshold_method_ == "exact" and det.tags_ == list(frame.columns)
    got, want = det.get_metadata(), jax_det.get_metadata()
    assert got.keys() == want.keys()
    assert got["feature-thresholds"].keys() == want["feature-thresholds"].keys()
    # its anomaly() against the JAX frame
    ours, theirs = det.anomaly(frame), jax_det.anomaly(frame)
    np.testing.assert_allclose(ours["total-anomaly-scaled"],
                               theirs[("total-anomaly-scaled", "")].values, rtol=1e-4, atol=1e-5)


def test_fitted_detector_round_trips_through_its_entry(frame, tmp_path):
    from gordo_components_torch import serializer

    det = DiffBasedAnomalyDetector(base_estimator=Pipeline([
        ("s", MinMaxScaler()), ("m", AutoEncoder(epochs=2, batch_size=64, device="cpu"))])).fit(frame)
    entry = det.to_entry("m")
    assert entry.registry_type == "AutoEncoder" and entry.tags == list(frame.columns)
    serializer.dump(det, str(tmp_path / "m"), metadata={"name": "m"})
    loaded = serializer.load(str(tmp_path / "m"), device="cpu")
    for k, v in det.anomaly(frame).items():
        np.testing.assert_array_equal(loaded.anomaly(frame)[k], v)
    np.testing.assert_array_equal(loaded.feature_thresholds_, det.feature_thresholds_.astype("f8"))
    assert loaded.total_threshold_ == det.total_threshold_
    assert serializer.load_metadata(str(tmp_path / "m"))["name"] == "m"
    # a pipeline step that is not affine cannot be banked
    odd = DiffBasedAnomalyDetector(base_estimator=Pipeline([
        ("odd", type("Odd", (), {"fit_transform": lambda s, X: X, "transform": lambda s, X: X})()),
        ("m", AutoEncoder(epochs=1, device="cpu"))])).fit(frame)
    with pytest.raises(ValueError, match="non-affine"):
        odd.to_entry()


def test_autoencoder_fit_history_and_early_stopping(frame):
    ae = AutoEncoder(kind="feedforward_hourglass", epochs=6, batch_size=64, device="cpu")
    ae.fit(frame)
    loss = ae.history["loss"]
    assert len(loss) == 6 and loss[-1] < loss[0]
    assert ae.get_metadata()["parameter_count"] == sum(v.size for v in ae.params_.values())
    from gordo_components_tpu.ops.losses import explained_variance

    np.testing.assert_allclose(ae.score(frame), float(explained_variance(
        frame.values, ae.predict(frame))), rtol=1e-5, atol=1e-6)
    assert set(ae.score_metrics(frame)) == {
        "explained-variance", "r2-score", "mean-squared-error", "mean-absolute-error"}
    assert ae.predict(frame).shape == frame.shape
    # validation split + early stopping with a min_delta no epoch beats:
    # stop after the second epoch, keeping the first epoch's parameters
    es = AutoEncoder(kind="feedforward_hourglass", epochs=20, batch_size=64, device="cpu",
                     validation_split=0.2, early_stopping_patience=1,
                     early_stopping_min_delta=10.0).fit(frame)
    assert len(es.history["loss"]) == 2 and len(es.history["val_loss"]) == 2
    one = AutoEncoder(kind="feedforward_hourglass", epochs=1, batch_size=64, device="cpu",
                      validation_split=0.2).fit(frame)
    for k in one.params_:
        np.testing.assert_array_equal(es.params_[k], one.params_[k])


def test_unported_estimator_features_raise(frame):
    with pytest.raises(NotImplementedError, match="conv"):
        ConvAutoEncoder(kind="conv1d_autoencoder", lookback_window=16, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        AutoEncoder(compute_dtype="bfloat16", device="cpu").fit(frame)
    with pytest.raises(NotImplementedError, match="conv"):
        import_locate("gordo_components_tpu.models.ConvAutoEncoder")()
    with pytest.raises(NotImplementedError, match="vae"):
        AutoEncoder(loss="vae", device="cpu").fit(frame)


@pytest.mark.parametrize("ours, theirs", [(MinMaxScaler, SkMinMax), (StandardScaler, SkStandard)])
def test_scalers_against_sklearn(frame, ours, theirs):
    X = frame.values
    got = ours().fit(frame)
    want = theirs().fit(X)
    np.testing.assert_allclose(got.transform(X), want.transform(X), **BAND)
    np.testing.assert_allclose(got.inverse_transform(got.transform(X)), X, **BAND)
    assert got.scaler_params_.shift.shape == (4,)


def test_definitions_resolve_to_port_classes():
    det = from_definition(JAX_DEFAULT)
    assert type(det) is DiffBasedAnomalyDetector
    assert type(det.base_estimator) is Pipeline
    (_, scaler), (_, est) = det.base_estimator.steps
    assert type(scaler) is MinMaxScaler and type(est) is AutoEncoder
    assert est.kind == "feedforward_hourglass"
    old = from_definition({"gordo_components.model.anomaly.DiffBasedAnomalyDetector": {
        "base_estimator": {"gordo_components.model.models.KerasAutoEncoder": {"epochs": 3}}}})
    assert type(old.base_estimator) is AutoEncoder and old.base_estimator.epochs == 3
    assert import_locate("gordo_components_tpu.models.transformers.JaxStandardScaler") is StandardScaler
    assert import_locate("sklearn.preprocessing.StandardScaler") is StandardScaler
    with pytest.raises(ImportError, match="RobustScaler"):
        from_definition({"sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.RobustScaler", "gordo_components_tpu.models.AutoEncoder"]}})
    named = from_definition({"sklearn.pipeline.Pipeline": {"steps": [
        ["scale", "sklearn.preprocessing.MinMaxScaler"], "gordo_components_tpu.models.AutoEncoder"]}})
    assert [n for n, _ in named.steps] == ["scale", "step_1"]
