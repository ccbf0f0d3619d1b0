"""``into_definition`` of the port against the JAX package's, on the CPU.

Each config resolves in both packages (``from_definition``) and is written
back (``into_definition``). The port's definition equals the JAX
package's with the package name ``gordo_components_tpu`` replaced by
``gordo_components_torch`` and sklearn's private module path
``sklearn.preprocessing._data`` by its public one, and it resolves back in
the port to an object with the same definition.
"""

import json

import pytest

from gordo_components_torch import serializer
from gordo_components_tpu.serializer import definitions as jax_definitions

_DET = "gordo_components_tpu.models.DiffBasedAnomalyDetector"
_AE = "gordo_components_tpu.models.AutoEncoder"
CONFIGS = {
    "estimator": {_AE: {"epochs": 1}},
    "estimator-defaults": _AE,
    "pipeline": {"sklearn.pipeline.Pipeline": {"steps": ["sklearn.preprocessing.MinMaxScaler", _AE]}},
    "named-steps": {"sklearn.pipeline.Pipeline": {"steps": [
        ["scale", "sklearn.preprocessing.StandardScaler"],
        ["model", {_AE: {"kind": "feedforward_symmetric", "dims": [4, 2]}}]]}},
    "scaler-kwargs": {"sklearn.pipeline.Pipeline": {"steps": [
        {"sklearn.preprocessing.MinMaxScaler": {"feature_range": [-1, 1]}}, _AE]}},
    "detector": {_DET: {"base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
        "sklearn.preprocessing.MinMaxScaler",
        {"gordo_components_tpu.models.LSTMForecast": {"lookback_window": 6, "compute_dtype": "bfloat16"}}]}},
        "threshold_quantile": 0.99}},
    "reference-paths": {"gordo_components.model.anomaly.DiffBasedAnomalyDetector": {"base_estimator": {
        "gordo_components.model.models.KerasLSTMAutoEncoder": {"kind": "lstm_hourglass"}}}},
    "conv": {_DET: {"base_estimator": {"gordo_components_tpu.models.ConvAutoEncoder": {
        "lookback_window": 8, "channels": [4, 2]}}}},
}


def _as_port(definition):
    text = json.dumps(definition, default=list)
    return json.loads(text.replace("gordo_components_tpu.", "gordo_components_torch.")
                      .replace("sklearn.preprocessing._data.", "sklearn.preprocessing."))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_into_definition_matches_jax(name):
    config = CONFIGS[name]
    got = serializer.into_definition(serializer.from_definition(config))
    want = jax_definitions.into_definition(jax_definitions.from_definition(config))
    assert json.loads(json.dumps(got, default=list)) == _as_port(want)
    again = serializer.pipeline_into_definition(serializer.pipeline_from_definition(got))
    assert json.dumps(again, default=list) == json.dumps(got, default=list)


def test_transformer_list_entries_are_named():
    """``transformer_list`` entries are resolved and auto-named as
    ``steps`` are (JAX ``_resolve_value``)."""
    from gordo_components_torch.models.transformers import MinMaxScaler
    from gordo_components_torch.serializer.definitions import _resolve_value

    got = _resolve_value("transformer_list", ["sklearn.preprocessing.MinMaxScaler",
                                              ["mine", "sklearn.preprocessing.MinMaxScaler"]])
    assert [n for n, _ in got] == ["step_0", "mine"]
    assert all(isinstance(obj, MinMaxScaler) for _, obj in got)


# ---------------------------------------------------------------------- #
# the rest of the definition surface: RobustScaler, MaxAbsScaler, the
# scalers' arguments, PCA, FeatureUnion, TransformedTargetRegressor
# ---------------------------------------------------------------------- #
#
# Bands. Fitted attributes: bitwise where the port calls the numpy function
# sklearn calls (RobustScaler, MaxAbsScaler; PCA's covariance_eigh solver
# and its mean_); PCA's full solver takes numpy's SVD where sklearn takes
# scipy's: components within atol 1e-5 in float32 and 1e-10 in float64.
# The port's affine transform against sklearn's rtol 1e-5 / atol 1e-6 (its
# (x - shift) * scale rounds unlike sklearn's division). Models built on the
# same base parameters against the JAX package's at the JAX suite's band,
# rtol 1e-4 / atol 1e-5.

import importlib.util  # noqa: E402
import os  # noqa: E402
from statistics import NormalDist  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
from scipy.special import ndtri  # noqa: E402
from sklearn.compose import TransformedTargetRegressor as SkTTR  # noqa: E402
from sklearn.decomposition import PCA as SkPCA  # noqa: E402
from sklearn.pipeline import FeatureUnion as SkUnion  # noqa: E402
from sklearn.pipeline import Pipeline as SkPipeline  # noqa: E402
from sklearn.preprocessing import MaxAbsScaler as SkMaxAbs  # noqa: E402
from sklearn.preprocessing import MinMaxScaler as SkMinMax  # noqa: E402
from sklearn.preprocessing import RobustScaler as SkRobust  # noqa: E402
from sklearn.preprocessing import StandardScaler as SkStandard  # noqa: E402

from gordo_components_torch.builder import build_fleet, build_model  # noqa: E402
from gordo_components_torch.builder.build_model import place  # noqa: E402
from gordo_components_torch.convert import feedforward_from_flax  # noqa: E402
from gordo_components_torch.models import AutoEncoder, DiffBasedAnomalyDetector  # noqa: E402
from gordo_components_torch.models import compose, transformers  # noqa: E402
from gordo_components_torch.server import ModelBank  # noqa: E402
from gordo_components_torch.server import bank as port_bank  # noqa: E402
from gordo_components_tpu.builder.build_model import build_model as jax_build_model  # noqa: E402
from gordo_components_tpu.models import AutoEncoder as JaxAE  # noqa: E402
from gordo_components_tpu.models import DiffBasedAnomalyDetector as JaxDetector  # noqa: E402
from gordo_components_tpu.server.bank import _affine_from_scaler  # noqa: E402
from gordo_components_tpu.server.bank import _extract_entry as jax_extract_entry  # noqa: E402

BAND = dict(rtol=1e-4, atol=1e-5)
AFFINE_BAND = dict(rtol=1e-5, atol=1e-6)
_SPEC = importlib.util.spec_from_file_location(
    "jax_artifact_to_torch",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools", "jax_artifact_to_torch.py"))
TOOL = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(TOOL)
_PRIVATE = {"sklearn.decomposition._pca.": "sklearn.decomposition.",
            "sklearn.compose._target.": "sklearn.compose."}


def _as_port_all(definition):
    text = json.dumps(_as_port(definition))
    for private, public in _PRIVATE.items():
        text = text.replace(private, public)
    return json.loads(text)


def _rows(n=200, F=5, seed=0, dtype=np.float64, nan=True):
    rng = np.random.RandomState(seed)
    X = (rng.randn(n, F) * np.linspace(5, 0.5, F)) @ rng.randn(F, F) + 3
    if nan:
        X[7, 2] = np.nan
        X[:, -1] = 1.5  # a constant feature: a zero scale becomes 1
    return X.astype(dtype)


SCALERS = {
    "robust": ({}, ("center_", "scale_")),
    "robust-no-center": ({"with_centering": False}, ("center_", "scale_")),
    "robust-no-scale": ({"with_scaling": False}, ("center_", "scale_")),
    "robust-range": ({"quantile_range": (10.0, 90.0)}, ("center_", "scale_")),
    "robust-unit-variance": ({"unit_variance": True}, ("center_", "scale_")),
    "maxabs": ({}, ("max_abs_", "scale_")),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(SCALERS))
def test_robust_and_maxabs_fits_are_sklearns_to_the_bit(case, dtype):
    kwargs, attrs = SCALERS[case]
    ours_cls, theirs_cls = ((transformers.MaxAbsScaler, SkMaxAbs) if case == "maxabs"
                            else (transformers.RobustScaler, SkRobust))
    X = _rows(dtype=dtype)
    ours, theirs = ours_cls(**kwargs).fit(X), theirs_cls(**kwargs).fit(X)
    for attr in attrs:
        got, want = getattr(ours, attr), getattr(theirs, attr)
        if want is None:
            assert got is None, attr
        else:
            assert got.dtype == want.dtype, attr
            np.testing.assert_array_equal(got, want, err_msg=attr)
    # the affine the bank composes is the JAX bank's, bitwise
    shift, scale = _affine_from_scaler(theirs, X.shape[1])
    np.testing.assert_array_equal(ours.scaler_params_.shift, shift)
    np.testing.assert_array_equal(ours.scaler_params_.scale, scale)
    X32 = X.astype(np.float32)
    np.testing.assert_allclose(ours.transform(X32), theirs.transform(X32), **AFFINE_BAND)


def test_unit_variance_quantile_gap_against_scipy():
    """``statistics.NormalDist().inv_cdf`` against ``scipy.special.ndtri``:
    0 ULP at the default quartiles, 1-3 ULP at 5-10 % and 90-95 % (so a
    ``unit_variance`` scale over another range may differ by that)."""
    normal = NormalDist()
    gaps = {q: abs(normal.inv_cdf(q) - ndtri(q)) / np.spacing(abs(ndtri(q)))
            for q in (0.25, 0.75, 0.1, 0.9, 0.05, 0.95)}
    assert gaps[0.25] == gaps[0.75] == 0 and max(gaps.values()) <= 3, gaps
    X = _rows()
    kwargs = dict(quantile_range=(10.0, 90.0), unit_variance=True)
    np.testing.assert_allclose(transformers.RobustScaler(**kwargs).fit(X).scale_, SkRobust(**kwargs).fit(X).scale_,
                               rtol=4 * np.finfo(np.float64).eps, atol=0)


@pytest.mark.parametrize("kwargs", [{"with_mean": False}, {"with_std": False},
                                    {"with_mean": False, "with_std": False}], ids=["no-mean", "no-std", "neither"])
def test_standard_scaler_arguments_against_sklearn(kwargs):
    X = _rows(dtype=np.float32, nan=False)
    ours, theirs = transformers.StandardScaler(**kwargs).fit(X), SkStandard(**kwargs).fit(X)
    np.testing.assert_allclose(ours.transform(X), theirs.transform(X), **AFFINE_BAND)
    shift, scale = _affine_from_scaler(theirs, X.shape[1])
    if not kwargs.get("with_mean", True):
        # sklearn keeps mean_ without centering; the JAX bank's affine takes
        # it as the shift all the same, the port centres as sklearn does: not
        shift = np.zeros_like(shift)
    np.testing.assert_allclose(ours.scaler_params_.shift, shift, **AFFINE_BAND)
    np.testing.assert_allclose(ours.scaler_params_.scale, scale, **AFFINE_BAND)
    assert transformers.affine_params(ours) is ours.scaler_params_


@pytest.mark.parametrize("ours_cls, theirs_cls, kwargs", [
    (transformers.MinMaxScaler, SkMinMax, {"feature_range": (-1, 1), "clip": True}),
    (transformers.MaxAbsScaler, SkMaxAbs, {"clip": True}),
], ids=["minmax", "maxabs"])
def test_clipping_scalers_clip_and_are_not_affine(ours_cls, theirs_cls, kwargs):
    X = _rows(dtype=np.float32, nan=False)
    ours, theirs = ours_cls(**kwargs).fit(X[:100]), theirs_cls(**kwargs).fit(X[:100])
    np.testing.assert_allclose(ours.transform(X), theirs.transform(X), **AFFINE_BAND)
    assert np.abs(ours.transform(X)).max() <= 1.0
    assert transformers.affine_params(ours) is None and ours.scaler_params_ is not None


PCAS = {
    "eigh-int": ((200, 5), {"n_components": 3}, "covariance_eigh"),
    "eigh-share": ((200, 5), {"n_components": 0.9}, "covariance_eigh"),
    "eigh-all": ((200, 5), {}, "covariance_eigh"),
    "eigh-whiten": ((200, 5), {"n_components": 3, "whiten": True}, "covariance_eigh"),
    "full-small": ((30, 5), {"n_components": 3}, "full"),
    "full-asked": ((200, 5), {"n_components": 2, "svd_solver": "full"}, "full"),
    "full-share": ((200, 5), {"n_components": 0.8, "svd_solver": "full"}, "full"),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(PCAS))
def test_pca_fit_against_sklearn(case, dtype):
    shape, kwargs, solver = PCAS[case]
    X = _rows(*shape, seed=1, dtype=dtype, nan=False)
    ours, theirs = transformers.PCA(**kwargs), SkPCA(**kwargs)
    got_t, want_t = ours.fit_transform(X), theirs.fit_transform(X)
    assert theirs._fit_svd_solver == solver
    assert ours.n_components_ == theirs.n_components_ and ours.n_samples_ == theirs.n_samples_
    np.testing.assert_array_equal(ours.mean_, theirs.mean_)
    atol = 1e-5 if dtype == np.float32 else 1e-10
    for attr in ("components_", "explained_variance_", "explained_variance_ratio_", "singular_values_"):
        got, want = getattr(ours, attr), getattr(theirs, attr)
        assert got.dtype == want.dtype, attr
        if solver == "covariance_eigh":  # numpy's eigh on the same covariance, as sklearn
            np.testing.assert_array_equal(got, want, err_msg=attr)
        else:
            np.testing.assert_allclose(got, want, rtol=atol, atol=atol, err_msg=attr)
    np.testing.assert_allclose(ours.noise_variance_, theirs.noise_variance_, rtol=atol)
    # every row's largest entry is positive (svd_flip, u_based_decision=False)
    assert (ours.components_[np.arange(ours.n_components_), np.abs(ours.components_).argmax(1)] > 0).all()
    scale = np.abs(want_t).max()
    np.testing.assert_allclose(got_t, want_t, rtol=0, atol=atol * 10 * scale)
    np.testing.assert_allclose(ours.transform(X), theirs.transform(X), rtol=0, atol=atol * 10 * scale)
    np.testing.assert_allclose(ours.inverse_transform(got_t), theirs.inverse_transform(want_t), rtol=0,
                               atol=atol * 10 * np.abs(X).max())
    assert ours.get_feature_names_out(["a"] * shape[1]) == list(theirs.get_feature_names_out())


@pytest.mark.parametrize("kwargs, shape, match", [
    ({"n_components": 2, "svd_solver": "randomized"}, (200, 5), "'randomized'"),
    ({"n_components": 2, "svd_solver": "arpack"}, (200, 5), "'arpack'"),
    ({"n_components": 5}, (600, 100), "'randomized' \\(picked by auto\\)"),
    ({"n_components": "mle"}, (200, 5), "'mle'"),
], ids=["randomized", "arpack", "auto-randomized", "mle"])
def test_pca_solvers_it_does_not_port_raise_by_name(kwargs, shape, match):
    with pytest.raises(NotImplementedError, match=match):
        transformers.PCA(**kwargs).fit(_rows(*shape, nan=False))


_AE_DEF = {_AE: {"kind": "feedforward_symmetric", "dims": [3], "epochs": 1, "batch_size": 64}}
ROUND_TRIPS = {
    # tests/test_serializer.py's FeatureUnion and TransformedTargetRegressor
    "feature-union": {"sklearn.pipeline.Pipeline": {"steps": [
        {"sklearn.pipeline.FeatureUnion": {"transformer_list": [
            ["scaled", "sklearn.preprocessing.MinMaxScaler"],
            ["pca", {"sklearn.decomposition.PCA": {"n_components": 2}}]]}}, _AE_DEF]}},
    "ttr": {"sklearn.compose.TransformedTargetRegressor": {
        "regressor": {_AE: {"kind": "feedforward_symmetric", "dims": [3], "epochs": 1, "seed": 3}},
        "transformer": "sklearn.preprocessing.MinMaxScaler", "check_inverse": False}},
    "robust": {"sklearn.pipeline.Pipeline": {"steps": [
        {"sklearn.preprocessing.RobustScaler": {"with_centering": False, "unit_variance": True}},
        _AE_DEF]}},
    "maxabs": {"sklearn.pipeline.Pipeline": {"steps": ["sklearn.preprocessing.MaxAbsScaler", _AE_DEF]}},
    "standard-kwargs": {"sklearn.pipeline.Pipeline": {"steps": [
        {"sklearn.preprocessing.StandardScaler": {"with_std": False}}, _AE_DEF]}},
    "pca-whiten": {"sklearn.pipeline.Pipeline": {"steps": [
        {"sklearn.decomposition.PCA": {"n_components": 3, "whiten": True}}, _AE_DEF]}},
    "minmax-clip": {"sklearn.pipeline.Pipeline": {"steps": [
        {"sklearn.preprocessing.MinMaxScaler": {"clip": True}}, _AE_DEF]}},
}


def _jax_ae(model):
    """The JAX AutoEncoder inside a fitted JAX model."""
    while not isinstance(model, JaxAE):
        model = (model.base_estimator if hasattr(model, "base_estimator") else model.steps[-1][1]
                 if hasattr(model, "steps") else model.regressor_)
    return model


def _adopt(monkeypatch, jax_model):
    """Every port AutoEncoder fit takes the fitted JAX AutoEncoder's
    parameters instead of training: the models are then held to the same
    base parameters."""
    jax_ae = _jax_ae(jax_model)

    def fit(self, X, y=None, **kwargs):
        self.params_ = feedforward_from_flax(jax.tree.map(np.asarray, jax_ae.params_))
        self.n_features_ = int(jax_ae.n_features_)
        self._module = None
        return self

    monkeypatch.setattr(AutoEncoder, "fit", fit)


@pytest.mark.parametrize("name", sorted(ROUND_TRIPS))
def test_definition_round_trip_matches_jax(name, monkeypatch):
    """Definition -> object -> definition in both packages, then both fit
    the same rows (the port on the JAX model's base parameters) and
    predict alike."""
    config = ROUND_TRIPS[name]
    ours = serializer.pipeline_from_definition(config)
    theirs = jax_definitions.pipeline_from_definition(config)
    got, want = serializer.pipeline_into_definition(ours), jax_definitions.pipeline_into_definition(theirs)
    json.dumps(got)
    assert json.loads(json.dumps(got, default=list)) == _as_port_all(want)
    again = serializer.pipeline_into_definition(serializer.pipeline_from_definition(got))
    assert json.dumps(again, default=list) == json.dumps(got, default=list)
    X = np.random.RandomState(0).rand(100, 6).astype("float32")
    y = X if name == "ttr" else None  # a regressor needs its target
    theirs.fit(X, y)
    _adopt(monkeypatch, theirs)
    place(ours, "cpu")
    ours.fit(X, y)
    np.testing.assert_allclose(ours.predict(X[:10]), theirs.predict(X[:10]), **BAND)


@pytest.fixture(scope="module")
def bank_rows():
    return ((np.random.RandomState(7).rand(150, 4).astype("float32") - 0.3) * 5.0)


BANK_SCALERS = {
    "robust": (lambda: SkRobust(), lambda: transformers.RobustScaler()),
    "robust-no-center": (lambda: SkRobust(with_centering=False),
                         lambda: transformers.RobustScaler(with_centering=False)),
    "robust-no-scale": (lambda: SkRobust(with_scaling=False), lambda: transformers.RobustScaler(with_scaling=False)),
    "maxabs": (lambda: SkMaxAbs(), lambda: transformers.MaxAbsScaler()),
    "standard-no-std": (lambda: SkStandard(with_std=False), lambda: transformers.StandardScaler(with_std=False)),
}


def _detectors(X, sk_step, port_step, monkeypatch):
    jax_det = JaxDetector(base_estimator=SkPipeline([("scale", sk_step), ("model", JaxAE(epochs=2, batch_size=64))]))
    jax_det.fit(X)
    _adopt(monkeypatch, jax_det)
    det = DiffBasedAnomalyDetector(base_estimator=transformers.Pipeline(
        [("scale", port_step), ("model", AutoEncoder(epochs=2, batch_size=64, device="cpu"))]))
    return jax_det, det.fit(X)


@pytest.mark.parametrize("case", sorted(BANK_SCALERS))
def test_bank_affine_scaler_family_matches_jax_anomaly(case, bank_rows, monkeypatch):
    """tests/test_bank.py's affine cases: the port banks the detector and
    its bank answers as the JAX detector's anomaly()."""
    sk_step, port_step = BANK_SCALERS[case]
    jax_det, det = _detectors(bank_rows, sk_step(), port_step(), monkeypatch)
    bank = ModelBank.from_models({"m": det}, device="cpu")
    assert bank.coverage()["banked"] == 1 and jax_extract_entry("m", jax_det)[1] is None
    got = bank.score("m", bank_rows[:41]).to_arrays()
    want = jax_det.anomaly(bank_rows[:41])
    for group, values in got.items():
        np.testing.assert_allclose(values, want[group].values.reshape(values.shape), err_msg=group, **BAND)


def _model_space_want(jax_det, X):
    """The JAX detector's model-space scoring pieces as anomaly arrays."""
    out = jax_det._predict_model_space(X)
    target = jax_det._model_space(X)[: len(out)]
    diff = np.abs(target - out)
    shift, scale = (np.asarray(a) for a in jax_det.error_scaler_)
    scaled = (diff - shift) * scale
    return {"model-input": X, "model-output": out, "tag-anomaly-unscaled": diff, "tag-anomaly-scaled": scaled,
            "total-anomaly-unscaled": np.linalg.norm(diff, axis=1),
            "total-anomaly-scaled": np.linalg.norm(scaled, axis=1)}


NON_AFFINE = {
    "pca": (lambda: SkPCA(n_components=3), lambda: transformers.PCA(n_components=3)),
    "feature-union": (lambda: SkUnion([("mm", SkMinMax()), ("pca", SkPCA(n_components=2))]),
                      lambda: compose.FeatureUnion([("mm", transformers.MinMaxScaler()),
                                                    ("pca", transformers.PCA(n_components=2))])),
}


@pytest.mark.parametrize("case", sorted(NON_AFFINE))
def test_non_affine_detectors_fall_back_and_score_in_model_space(case, bank_rows, monkeypatch, tmp_path):
    """tests/test_bank.py's PCA case: the bank leaves the detector out with
    the JAX bank's reason; its anomaly() scores the transformed columns as
    the JAX detector's model-space pieces do, and survives dump/load."""
    sk_step, port_step = NON_AFFINE[case]
    jax_det, det = _detectors(bank_rows, sk_step(), port_step(), monkeypatch)
    want_reason = jax_extract_entry("m", jax_det)[1]
    assert want_reason == "non-affine preprocessing step 'scale'"
    assert port_bank._extract_entry("m", det) == (None, want_reason)
    assert ModelBank.from_models({"m": det}, device="cpu").coverage()["fallback"] == {"m": want_reason}
    got, want = det.anomaly(bank_rows[:41]), _model_space_want(jax_det, bank_rows[:41])
    for group in want:
        np.testing.assert_allclose(got[group], want[group], err_msg=group, **BAND)
    assert det.output_tags == (["pca0", "pca1", "pca2"] if case == "pca" else
                               [f"mm__feature-{i}" for i in range(4)] + ["pca__pca0", "pca__pca1"])
    serializer.dump(det, str(tmp_path / "det"))
    back = serializer.load(str(tmp_path / "det"), device="cpu")
    for group, values in back.anomaly(bank_rows[:41]).items():
        np.testing.assert_array_equal(values, got[group], err_msg=group)
    assert back.output_tags == det.output_tags and back.total_threshold_ == det.total_threshold_
    with pytest.raises(ValueError, match="not affine"):
        serializer.load_entry(str(tmp_path / "det"))


def test_clipping_min_max_detector_is_served_per_model(bank_rows):
    det = DiffBasedAnomalyDetector(base_estimator=transformers.Pipeline([
        ("clip", transformers.MinMaxScaler(clip=True)), ("model", AutoEncoder(epochs=1, device="cpu"))]))
    det.fit(bank_rows)
    assert port_bank._extract_entry("m", det) == (None, "non-affine preprocessing step 'clip'")
    assert det.anomaly(bank_rows[:5])["model-output"].shape == (5, 4)


_DATA = {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00Z",
         "train_end_date": "2020-01-01T06:00:00Z", "tag_list": ["a", "b", "c", "d"]}


def _det_config(step):
    return {_DET: {"base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
        step, {_AE: {"kind": "feedforward_symmetric", "dims": [2], "epochs": 1, "batch_size": 64}}]}}}}


BUILDS = {
    "robust": (_det_config({"sklearn.preprocessing.RobustScaler": {"unit_variance": True}}), _DATA),
    "maxabs": (_det_config("sklearn.preprocessing.MaxAbsScaler"), _DATA),
    "standard-kwargs": (_det_config({"sklearn.preprocessing.StandardScaler": {"with_mean": False}}), _DATA),
    "pca": (_det_config({"sklearn.decomposition.PCA": {"n_components": 3}}), _DATA),
    "feature-union": (_det_config({"sklearn.pipeline.FeatureUnion": {"transformer_list": [
        ["mm", "sklearn.preprocessing.MinMaxScaler"], ["pca", {"sklearn.decomposition.PCA": {"n_components": 2}}]]}}),
        _DATA),
    "ttr": ({"sklearn.compose.TransformedTargetRegressor": {
        "regressor": {_AE: {"kind": "feedforward_symmetric", "dims": [2], "epochs": 1}},
        "transformer": "sklearn.preprocessing.MinMaxScaler"}}, dict(_DATA, target_tag_list=_DATA["tag_list"])),
}


@pytest.mark.parametrize("case", sorted(BUILDS))
def test_definitions_build_through_build_model_and_build_fleet(case, monkeypatch, tmp_path):
    """A JAX-side definition using each class builds in the port, single
    and through build_fleet; on the JAX model's base parameters its
    predictions and anomaly arrays are the JAX model's within the band, the
    affine detectors banked and the others left to the per-model path."""
    model_config, data = BUILDS[case]
    jax_model, jax_md = jax_build_model("m", model_config, data)
    _adopt(monkeypatch, jax_model)
    model, md = build_model("m", model_config, data, device="cpu")
    report = build_fleet([{"name": "m", "dataset": data, "model": model_config}], str(tmp_path / "fleet"),
                         device="cpu")
    assert not report.failed, report.failed
    loaded = serializer.load(os.path.join(str(tmp_path / "fleet"), "m"), device="cpu")
    assert type(loaded) is type(model)
    assert set(md["model"]) - {"device_memory"} == set(jax_md["model"]) - {"device_memory"}
    from gordo_components_tpu.dataset import get_dataset as jax_get_dataset

    X = jax_get_dataset(dict(data)).get_data()[0].values.astype("float32")
    np.testing.assert_allclose(model.predict(X), jax_model.predict(X), **BAND)
    np.testing.assert_array_equal(loaded.predict(X), model.predict(X))
    if case == "ttr":
        return
    bank = ModelBank.from_models({"m": loaded}, device="cpu")
    affine = case in ("robust", "maxabs", "standard-kwargs")
    assert bank.coverage()["banked"] == int(affine)
    if affine:
        got, want = bank.score("m", X).to_arrays(), jax_model.anomaly(X)
        want = {g: want[g].values.reshape(got[g].shape) for g in got}
    else:
        got, want = loaded.anomaly(X), _model_space_want(jax_model, X)
        assert bank.coverage()["fallback"] == {"m": jax_extract_entry("m", jax_model)[1]}
    for group in want:
        np.testing.assert_allclose(got[group], want[group], err_msg=group, **BAND)


TOOL_MODELS = {
    "robust-pipeline": lambda: SkPipeline([("s", SkRobust(quantile_range=(10.0, 90.0))), ("m", JaxAE(epochs=1))]),
    "maxabs-pipeline": lambda: SkPipeline([("s", SkMaxAbs()), ("m", JaxAE(epochs=1))]),
    "standard-pipeline": lambda: SkPipeline([("s", SkStandard(with_std=False)), ("m", JaxAE(epochs=1))]),
    "pca-pipeline": lambda: SkPipeline([("s", SkPCA(n_components=2, whiten=True)), ("m", JaxAE(epochs=1))]),
    "union-pipeline": lambda: SkPipeline([("s", SkUnion([("mm", SkMinMax()), ("drop", "drop"),
                                                         ("pca", SkPCA(n_components=2))])), ("m", JaxAE(epochs=1))]),
    "ttr": lambda: SkTTR(regressor=JaxAE(epochs=1), transformer=SkMinMax(), check_inverse=False),
    "robust-detector": lambda: JaxDetector(base_estimator=SkPipeline([("s", SkRobust()), ("m", JaxAE(epochs=1))])),
    "pca-detector": lambda: JaxDetector(base_estimator=SkPipeline([("s", SkPCA(n_components=3)),
                                                                   ("m", JaxAE(epochs=1))])),
}


@pytest.mark.parametrize("case", sorted(TOOL_MODELS))
def test_jax_artifacts_of_each_class_convert(case, bank_rows, tmp_path):
    """tools/jax_artifact_to_torch.py carries each class out of a fitted
    JAX model; the port's copy predicts as JAX's and survives dump/load
    bitwise."""
    X = bank_rows
    jax_model = TOOL_MODELS[case]()
    jax_model.fit(X, X) if case == "ttr" else jax_model.fit(X)
    port = TOOL.convert_model(jax_model)
    if case == "robust-detector":
        port = DiffBasedAnomalyDetector.from_entry(port, device="cpu")
    if case.endswith("detector"):
        want = (jax_model.anomaly(X) if case == "robust-detector" else None)
        got = port.anomaly(X)
        want = ({g: want[g].values.reshape(got[g].shape) for g in got} if want is not None
                else _model_space_want(jax_model, X))
        for group in want:
            np.testing.assert_allclose(got[group], want[group], err_msg=group, **BAND)
    else:
        np.testing.assert_allclose(port.predict(X), jax_model.predict(X), **BAND)
    serializer.dump(port, str(tmp_path / "a"))
    back = serializer.load(str(tmp_path / "a"), device="cpu")
    assert type(back) is type(port)
    np.testing.assert_array_equal(back.predict(X), port.predict(X))
