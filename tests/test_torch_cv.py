"""Cross-validation of the port, single and fleet builds, on the CPU.

- ``builder/splits.TimeSeriesSplit`` gives sklearn's fold indices for 0 to
  200 rows and 1 to 10 splits, and raises ``ValueError`` where sklearn does.
- ``summarize_cv_folds``, ``_normalize_evaluation`` and ``_wants_cv`` give
  the JAX package's results; a single build's cross-validation metadata has
  the JAX key set.
- The fleet's fold plan (keys, splits, fold rows, infeasible machines)
  equals the JAX package's, and from the same initial parameters the fold
  members' scores equal the JAX package's (``_plan_cv_folds`` ->
  ``FleetTrainer.fit(initial_params=...)`` -> ``_score_cv_folds`` in each
  package), within the training band of test_torch_fleet.py (rtol=1e-4,
  atol=1e-5): one batch an epoch, so the shuffle cannot matter.
- The cases of tests/test_fleet_cv.py's ``TestGangCV``, with its datasets
  and epoch counts: the gang against the single build within 0.1 a fold
  (its band), a full build still trained, no evaluation no metadata,
  ``cross_val_only`` on the single path, untrained, unregistered and not
  served, the cache, the LSTM gang, the infeasible fallback; and
  ``n_splits: 1``, which asks for folds that cannot be cut.
"""

import importlib
import os

import numpy as np
import pytest
from sklearn.model_selection import TimeSeriesSplit as SkTimeSeriesSplit

from gordo_components_torch import serializer
from gordo_components_torch.builder import build_fleet, build_model, provide_saved_model
from gordo_components_torch.builder import fleet_build as port_fb
from gordo_components_torch.builder.splits import TimeSeriesSplit
from gordo_components_torch.convert import feedforward_to_flax, lstm_to_flax
from gordo_components_torch.models import lookup_factory, train_core
from gordo_components_torch.parallel import FleetTrainer
from gordo_components_torch.server import scan_artifacts
from gordo_components_torch.workflow import Machine
from gordo_components_tpu.builder import fleet_build as jax_fb
from gordo_components_tpu.builder.fleet_build import build_fleet as jax_build_fleet
from gordo_components_tpu.parallel import FleetTrainer as JaxFleetTrainer
from gordo_components_tpu.workflow.config import Machine as JaxMachine

# the modules, which each builder package's build_model function shadows
port_bm = importlib.import_module("gordo_components_torch.builder.build_model")
jax_bm = importlib.import_module("gordo_components_tpu.builder.build_model")
BAND = dict(rtol=1e-4, atol=1e-5)
METRICS = ("explained-variance", "r2-score", "mean-squared-error", "mean-absolute-error")

# tests/test_fleet_cv.py's dataset and evaluation: 72 rows, 18-row folds
DATASET = {
    "type": "RandomDataset",
    "train_start_date": "2020-01-01T00:00:00Z",
    "train_end_date": "2020-01-01T12:00:00Z",
    "tag_list": ["a", "b", "c"],
}
EVALUATION = {"cross_validation": True, "n_splits": 3}


def _fleetable(epochs=300, batch_size=8, pkg="gordo_components_torch"):
    return {f"{pkg}.models.DiffBasedAnomalyDetector": {"base_estimator": {"sklearn.pipeline.Pipeline": {
        "steps": ["sklearn.preprocessing.MinMaxScaler",
                  {f"{pkg}.models.AutoEncoder": {"kind": "feedforward_symmetric", "dims": [8],
                                                 "epochs": epochs, "batch_size": batch_size}}]}}}}


def _lstm(lookback, epochs, batch_size=None, pkg="gordo_components_torch"):
    kw = {"lookback_window": lookback, "epochs": epochs}
    if batch_size:
        kw["batch_size"] = batch_size
    return {f"{pkg}.models.DiffBasedAnomalyDetector": {"base_estimator": {"sklearn.pipeline.Pipeline": {
        "steps": ["sklearn.preprocessing.MinMaxScaler", {f"{pkg}.models.LSTMAutoEncoder": kw}]}}}}


def _cv(path):
    return serializer.load_metadata(path)["model"]["cross-validation"]


# ------------------------------------------------------------------ #
# folds, summaries, evaluation blocks
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("n_splits", range(1, 11))
def test_time_series_split_matches_sklearn(n_splits):
    for n in range(0, 201):
        X = np.zeros((n, 2))
        try:
            want = [(a.tolist(), b.tolist()) for a, b in SkTimeSeriesSplit(n_splits=n_splits).split(X)]
        except ValueError:
            want = ValueError
        try:
            got = [(a.tolist(), b.tolist()) for a, b in TimeSeriesSplit(n_splits=n_splits).split(X)]
        except ValueError:
            got = ValueError
        assert got == want, (n, n_splits)


def test_time_series_split_refuses_what_sklearn_refuses():
    for bad in (0.5, "3", None):
        with pytest.raises(ValueError):
            SkTimeSeriesSplit(n_splits=bad)
        with pytest.raises(ValueError):
            TimeSeriesSplit(n_splits=bad)
    assert len(list(TimeSeriesSplit(4).split(np.zeros((10, 1))))) == 4


@pytest.mark.parametrize("folds", [
    [],
    [{"explained-variance": 0.5}],
    [{m: float(i + j) for j, m in enumerate(METRICS)} for i in range(3)],
    [{"explained-variance": np.float32(0.25), "r2-score": -1}, {"explained-variance": 1, "r2-score": 0.5}],
])
def test_summarize_cv_folds_matches_jax(folds):
    assert port_bm.summarize_cv_folds(folds) == jax_bm.summarize_cv_folds(folds)


EVALUATIONS = [None, {}, {"cross_validation": True}, {"cross_validation": True, "n_splits": 5},
               {"cv_mode": "cross_val_only"}, {"cv_mode": "cross_val_only", "n_splits": 0},
               {"cross_validation": True, "n_splits": 1}, {"cross_validation": False, "n_splits": 3},
               {"cv_mode": "full_build", "cross_validation": 1}]


@pytest.mark.parametrize("evaluation", EVALUATIONS, ids=str)
def test_evaluation_blocks_read_as_jax_reads_them(evaluation):
    got = port_bm._normalize_evaluation(evaluation)
    assert got == jax_bm._normalize_evaluation(evaluation)
    assert port_bm._wants_cv(got) == jax_bm._wants_cv(got)


def test_build_model_cv_metadata_has_the_jax_key_set():
    ev = {"cross_validation": True, "n_splits": 2}
    _, got = build_model("m", _fleetable(epochs=1), dict(DATASET), evaluation_config=ev, device="cpu")
    _, want = jax_bm.build_model("m", _fleetable(epochs=1, pkg="gordo_components_tpu"), dict(DATASET),
                                 evaluation_config=ev)
    got_cv, want_cv = got["model"]["cross-validation"], want["model"]["cross-validation"]
    assert set(got_cv) == set(want_cv) == {"cv_duration_sec", *METRICS}
    for m in METRICS:
        assert set(got_cv[m]) == set(want_cv[m]) == {"mean", "std", "per-fold"}
        assert len(got_cv[m]["per-fold"]) == 2 and np.isfinite(got_cv[m]["per-fold"]).all()
    assert got["model"]["trained"] and want["model"]["trained"]


# ------------------------------------------------------------------ #
# the fleet's folds against the JAX package's
# ------------------------------------------------------------------ #


def _members(rows, features=3, seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for i, r in enumerate(rows):
        t = np.arange(r)[:, None]
        X = np.sin(0.05 * (i + 1) * t * np.arange(1, features + 1)) + 0.05 * rng.randn(r, features)
        out[f"m{i}"] = X.astype("f4")
    return out


FAMILIES = {
    "dense": dict(arch=dict(kind="feedforward_symmetric", dims=(3,)), to_flax=feedforward_to_flax,
                  rows=[60, 57, 54, 51]),
    # m3's 11-row folds are shorter than lookback 12: infeasible
    "lstm": dict(arch=dict(kind="lstm_symmetric", dims=(4,), lookback_window=12,
                           model_type="LSTMAutoEncoder"), to_flax=lstm_to_flax, rows=[60, 57, 54, 44]),
}


def _initial(names, arch, features=3):
    module = lookup_factory(arch.get("model_type", "AutoEncoder"), arch["kind"])(features, dims=arch["dims"])
    if "lookback_window" in arch:
        stack = train_core.StackedLSTM(module, arch["lookback_window"])
    else:
        stack = train_core.StackedDense(module)
    states = stack.state_dicts(stack.init([train_core.member_generator(11, i) for i in range(len(names))]))
    return dict(zip(names, states))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fleet_folds_match_jax_from_the_same_initial_params(family):
    spec = FAMILIES[family]
    members = _members(spec["rows"])
    evaluation = [EVALUATION, {"cross_validation": True, "n_splits": 2}, None, EVALUATION]
    port_machines = [Machine(name=n, dataset={}, evaluation=dict(e or {}))
                     for n, e in zip(members, evaluation)]
    jax_machines = [JaxMachine(name=n, dataset={}, evaluation=dict(e or {}))
                    for n, e in zip(members, evaluation)]
    ae_kwargs = dict(spec["arch"])
    plan, fold_data, infeasible = port_fb._plan_cv_folds(port_machines, members, ae_kwargs)
    jplan, jfold_data, jinfeasible = jax_fb._plan_cv_folds(jax_machines, members, ae_kwargs)
    assert [m.name for m in infeasible] == [m.name for m in jinfeasible]
    assert [m.name for m in infeasible] == (["m3"] if family == "lstm" else [])
    assert list(plan) == list(jplan) and list(fold_data) == list(jfold_data)
    for name in plan:
        (splits, Xv), (jsplits, jXv) = plan[name], jplan[name]
        assert [(a.tolist(), b.tolist()) for a, b in splits] == [(a.tolist(), b.tolist()) for a, b in jsplits]
        np.testing.assert_array_equal(Xv, jXv)
    for key in fold_data:
        assert "\x00" in key and key == jax_fb._cv_key(key.split("\x00")[-1], int(key.split("\x00")[2]))
        np.testing.assert_array_equal(fold_data[key], jfold_data[key])

    fit_members = {**{n: members[n] for n in members if n not in {m.name for m in infeasible}}, **fold_data}
    initial = _initial(list(fit_members), spec["arch"])
    common = dict(epochs=3, batch_size=64, learning_rate=1e-2, **spec["arch"])
    out = FleetTrainer(device="cpu", **common).fit(fit_members, initial_params=initial)
    jout = JaxFleetTrainer(**common).fit(
        fit_members, initial_params={n: spec["to_flax"](sd) for n, sd in initial.items()})
    got, want = port_fb._score_cv_folds(plan, out), jax_fb._score_cv_folds(jplan, jout)
    assert list(got) == list(want) == (["m0", "m1"] if family == "lstm" else ["m0", "m1", "m3"])
    for name in got:
        assert set(got[name]) == set(want[name]) and got[name]["fleet_cv"] is True
        for m in METRICS:
            np.testing.assert_allclose(got[name][m]["per-fold"], want[name][m]["per-fold"],
                                       err_msg=f"{name} {m}", **BAND)


# ------------------------------------------------------------------ #
# tests/test_fleet_cv.py's TestGangCV, on the port
# ------------------------------------------------------------------ #


def test_gang_cv_metadata_and_single_build_parity(tmp_path):
    machines = [Machine(name=f"m-{i}", dataset=dict(DATASET), model=_fleetable(), evaluation=dict(EVALUATION))
                for i in range(2)]
    results = build_fleet(machines, str(tmp_path / "out"), device="cpu")
    assert sorted(results) == ["m-0", "m-1"] and not results.failed
    for path in results.values():
        cv = _cv(path)
        ev = cv["explained-variance"]
        assert len(ev["per-fold"]) == 3 and cv["fleet_cv"] is True
        assert np.isfinite(ev["per-fold"]).all()
        assert ev["mean"] == pytest.approx(np.mean(ev["per-fold"]))
        for metric in METRICS[1:]:
            assert len(cv[metric]["per-fold"]) == 3 and np.isfinite(cv[metric]["per-fold"]).all()
        assert serializer.load_metadata(path)["model"]["fleet_stats"]["cv_fold_members"] == 6
    # the JAX suite's band: 300 epochs wash out the initialization
    single = provide_saved_model("m-0", _fleetable(), dict(DATASET), output_dir=str(tmp_path / "single"),
                                 evaluation_config=dict(EVALUATION), device="cpu")
    sev = _cv(single)["explained-variance"]["per-fold"]
    fev = _cv(results["m-0"])["explained-variance"]["per-fold"]
    assert "fleet_cv" not in _cv(single)
    np.testing.assert_allclose(sev, fev, rtol=0, atol=0.1)


def test_full_build_still_trained(tmp_path):
    machines = [Machine(name="m-0", dataset=dict(DATASET), model=_fleetable(epochs=2),
                        evaluation=dict(EVALUATION))]
    results = build_fleet(machines, str(tmp_path / "out"), device="cpu")
    md = serializer.load_metadata(results["m-0"])
    assert md["model"]["trained"] and md["model"]["fleet_trained"]
    out = serializer.load(results["m-0"], device="cpu").anomaly(np.random.rand(20, 3).astype("float32"))
    assert out["total-anomaly-scaled"].shape == (20,)


def test_no_evaluation_no_cv_metadata(tmp_path):
    results = build_fleet([Machine(name="m-0", dataset=dict(DATASET), model=_fleetable(epochs=2))],
                          str(tmp_path / "out"), device="cpu")
    md = serializer.load_metadata(results["m-0"])["model"]
    assert "cross-validation" not in md and "cv_fold_members" not in md["fleet_stats"]


def test_cross_val_only_takes_single_path_untrained_unregistered_unserved(tmp_path, monkeypatch):
    def no_fleet(*a, **k):
        raise AssertionError("cross_val_only must not reach the fleet trainer")

    monkeypatch.setattr(FleetTrainer, "fit", no_fleet)
    out, reg = str(tmp_path / "out"), str(tmp_path / "reg")
    machines = [Machine(name="m-0", dataset=dict(DATASET), model=_fleetable(epochs=2),
                        evaluation={"cv_mode": "cross_val_only", "n_splits": 3})]
    results = build_fleet(machines, out, model_register_dir=reg, device="cpu")
    md = serializer.load_metadata(results["m-0"])
    assert not md["model"]["trained"] and "fleet_trained" not in md["model"]
    assert len(md["model"]["cross-validation"]["explained-variance"]["per-fold"]) == 3
    assert results["m-0"] == os.path.join(out, "m-0")
    assert not os.path.exists(reg) or not os.listdir(reg)  # never registered
    assert not serializer.is_artifact_dir(results["m-0"]) and scan_artifacts(out) == {}
    # a rerun never takes the cache: it cross-validates again
    assert build_fleet(machines, out, model_register_dir=reg, device="cpu") == results


def test_cross_val_only_replaces_an_earlier_artifact(tmp_path):
    out = str(tmp_path / "out")
    provide_saved_model("m", _fleetable(epochs=1), dict(DATASET), output_dir=out, device="cpu")
    assert serializer.is_artifact_dir(out)
    provide_saved_model("m", _fleetable(epochs=1), dict(DATASET), output_dir=out, device="cpu",
                        evaluation_config={"cv_mode": "cross_val_only", "n_splits": 2})
    assert not serializer.is_artifact_dir(out) and not serializer.load_metadata(out)["model"]["trained"]


def test_cv_cache_semantics(tmp_path):
    """A build without folds does not satisfy a rerun that asks for them;
    that rerun writes the folds, and then satisfies the same request."""
    kwargs = dict(output_dir=str(tmp_path / "out"), model_register_dir=str(tmp_path / "reg"), device="cpu")
    r1 = build_fleet([Machine(name="m-0", dataset=dict(DATASET), model=_fleetable(epochs=2))], **kwargs)
    assert "cross-validation" not in serializer.load_metadata(r1["m-0"])["model"]
    with_cv = [Machine(name="m-0", dataset=dict(DATASET), model=_fleetable(epochs=2),
                       evaluation=dict(EVALUATION))]
    r2 = build_fleet(with_cv, **kwargs)
    assert r2["m-0"] == r1["m-0"]  # the same register entry, rewritten
    assert len(_cv(r2["m-0"])["explained-variance"]["per-fold"]) == 3
    mtime = os.path.getmtime(os.path.join(r2["m-0"], "params.npz"))
    r3 = build_fleet(with_cv, **kwargs)
    assert os.path.getmtime(os.path.join(r3["m-0"], "params.npz")) == mtime
    # another fold count misses the cache, in the single path alike
    five = dict(EVALUATION, n_splits=5)
    path = provide_saved_model("m-0", _fleetable(epochs=2), dict(DATASET), evaluation_config=five, **kwargs)
    assert len(_cv(path)["explained-variance"]["per-fold"]) == 5


def test_sequence_family_cv_in_gang(tmp_path):
    # 72 rows -> 18-row folds; lookback 8 fits every fold
    machines = [Machine(name="seq-0", dataset=dict(DATASET), model=_lstm(8, 2, 16),
                        evaluation=dict(EVALUATION))]
    results = build_fleet(machines, str(tmp_path / "out"), device="cpu")
    md = serializer.load_metadata(results["seq-0"])["model"]
    assert md["fleet_trained"] and md["fleet_stats"]["cv_fold_members"] == 3
    ev = md["cross-validation"]["explained-variance"]
    assert len(ev["per-fold"]) == 3 and np.isfinite(ev["per-fold"]).all()


def test_infeasible_folds_fall_back_to_single_path(tmp_path, monkeypatch):
    calls = []

    def fake_provide(name, model, data, meta=None, **kw):
        calls.append((name, kw.get("evaluation_config")))
        out = os.path.join(str(tmp_path), "stub", name)
        os.makedirs(out, exist_ok=True)
        return out

    monkeypatch.setattr(port_fb, "provide_saved_model", fake_provide)
    # 18-row folds, shorter than the 24-row warm-up
    machines = [Machine(name="short", dataset=dict(DATASET), model=_lstm(24, 1), evaluation=dict(EVALUATION))]
    results = build_fleet(machines, str(tmp_path / "out"), device="cpu")
    assert [c[0] for c in calls] == ["short"] and calls[0][1] == dict(EVALUATION)
    assert results["short"].endswith(os.path.join("stub", "short"))


def test_one_split_fails_as_in_jax(tmp_path):
    """``n_splits: 1`` asks for folds (``_wants_cv``) that cannot be cut: the
    single build raises ValueError; in a gang the machine is infeasible, its
    single build raises, and its group fails with it."""
    one = {"cross_validation": True, "n_splits": 1}
    with pytest.raises(ValueError):
        build_model("m", _fleetable(epochs=1), dict(DATASET), evaluation_config=one, device="cpu")
    results = build_fleet([Machine(name="m", dataset=dict(DATASET), model=_fleetable(epochs=1),
                                   evaluation=one)], str(tmp_path / "port"), group_retries=0, device="cpu")
    jax_model = _fleetable(epochs=1, pkg="gordo_components_tpu")
    jax = jax_build_fleet([JaxMachine(name="m", dataset=dict(DATASET), model=jax_model, evaluation=one)],
                          str(tmp_path / "jax"), group_retries=0)
    assert dict(results) == {} and dict(jax) == {}
    assert sorted(results.failed) == sorted(jax.failed) == ["m"]
    assert results.failed["m"].startswith("ValueError") and jax.failed["m"].startswith("ValueError")
