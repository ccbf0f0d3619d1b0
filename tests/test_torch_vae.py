"""The port's variational autoencoder (``BASELINE.json`` config 4) against
the JAX package's, on the CPU.

JAX samples the latent inside ``elbo_terms`` from ``make_rng("sample")``,
which folds the key it is given: the noise JAX used is
``jax.random.normal(key, mu.shape)`` with ``key`` the module's own
``make_rng("sample")`` under that rng (:func:`jax_noise`). The tests recover
it, check the recovery first (decoding ``mu + exp(0.5 * logvar) * noise`` in
numpy gives JAX's reconstruction), then inject it into the port.

Bands: the forward and the ELBO terms within rtol=1e-5, atol=1e-6; an epoch
and a validation loss from JAX's parameters, permutation and noise within
rtol=1e-5, atol=1e-6; the detector's error scaler and thresholds over JAX's
fitted parameters, the bank and ``anomaly()`` against the JAX package's
within rtol=1e-4, atol=1e-5. Within the port, a gang member's draws (its
shuffles and its noise) do not depend on the gang's width or on its item
padding: held bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.pipeline import Pipeline as SkPipeline
from sklearn.preprocessing import MinMaxScaler as SkMinMax

from gordo_components_torch import serializer
from gordo_components_torch.builder import build_fleet
from gordo_components_torch.convert import (
    entry_from_numpy,
    params_from_flax,
    params_to_flax,
    vae_from_flax,
    vae_to_flax,
)
from gordo_components_torch.models import AutoEncoder, DiffBasedAnomalyDetector, lookup_factory, train_core
from gordo_components_torch.models.factories.variational import VariationalAutoEncoder
from gordo_components_torch.models.transformers import MinMaxScaler, Pipeline
from gordo_components_torch.parallel import FleetTrainer
from gordo_components_torch.server import ModelBank
from gordo_components_tpu.models import AutoEncoder as JaxAE
from gordo_components_tpu.models import DiffBasedAnomalyDetector as JaxDetector
from gordo_components_tpu.models import train_core as ref
from gordo_components_tpu.models.factories.variational import feedforward_variational as jax_vae
from gordo_components_tpu.server.bank import ModelBank as JaxBank
from gordo_components_tpu.server.bank import _extract_entry

TIGHT = dict(rtol=1e-5, atol=1e-6)
BAND = dict(rtol=1e-4, atol=1e-5)
F = 4
CPU = torch.device("cpu")
ARCH = dict(kind="feedforward_variational", dims=(8,), latent_dim=3)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _jax_params(module, seed=0):
    return jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(seed), jnp.zeros((1, module.n_features))))


def _port(params, dims, latent, f=F) -> VariationalAutoEncoder:
    module = lookup_factory("AutoEncoder", "feedforward_variational")(f, dims=dims, latent_dim=latent)
    module.load_state_dict({k: t(v) for k, v in vae_from_flax(params).items()})
    return module


def jax_noise(module, params, rng, shape) -> np.ndarray:
    """The noise JAX's ``elbo_terms`` draws under ``rngs={"sample": rng}``."""
    key = module.apply(params, method=lambda m: m.make_rng("sample"), rngs={"sample": rng})
    return np.asarray(jax.random.normal(key, shape))


def _numpy_elbo(params, x, noise, dims):
    """The ELBO terms in numpy (tanh layers), for the recovery check."""
    p = params["params"]

    def dense(name, h):
        return h @ p[name]["kernel"] + p[name]["bias"]

    h = x
    for i in range(len(dims)):
        h = np.tanh(dense(f"enc_{i}", h))
    mu, logvar = dense("mu", h), dense("logvar", h)
    h = mu + np.exp(0.5 * logvar) * noise
    for j in range(len(dims)):
        h = np.tanh(dense(f"dec_{j}", h))
    kl = -0.5 * np.sum(1 + logvar - mu**2 - np.exp(logvar), axis=-1)
    return dense("out", h), kl


@pytest.mark.parametrize("dims, latent", [((8,), 3), ((16, 8), 4), ((), 2)], ids=["1", "2", "0"])
def test_forward_and_elbo_terms_match_jax(dims, latent):
    jm = jax_vae(F, dims=dims, latent_dim=latent)
    params = _jax_params(jm, seed=len(dims))
    x = np.random.RandomState(1).randn(9, F).astype("f4")
    pm = _port(params, dims, latent)
    with torch.no_grad():
        np.testing.assert_allclose(pm(t(x)).numpy(), np.asarray(jm.apply(params, jnp.asarray(x))), **TIGHT)
    rng = jax.random.PRNGKey(7)
    jrecon, jkl = (np.asarray(a) for a in jm.apply(params, jnp.asarray(x), method="elbo_terms",
                                                   rngs={"sample": rng}))
    noise = jax_noise(jm, params, rng, (9, latent))
    # the recovery: this noise is what JAX sampled (and jax.random.normal
    # of the rng itself is not)
    recon, kl = _numpy_elbo(params, x, noise, dims)
    np.testing.assert_allclose(recon, jrecon, **TIGHT)
    np.testing.assert_allclose(kl, jkl, rtol=1e-5, atol=1e-5)
    assert np.abs(np.asarray(jax.random.normal(rng, (9, latent))) - noise).max() > 0.1
    with torch.no_grad():
        precon, pkl = pm.elbo_terms(t(x), t(noise))
    np.testing.assert_allclose(precon.numpy(), jrecon, **TIGHT)
    np.testing.assert_allclose(pkl.numpy(), jkl, rtol=1e-5, atol=1e-5)
    # the stack's ELBO terms and mean decode over members
    stack = train_core.StackedVAE(pm)
    sd = vae_from_flax(params)
    flat = stack.from_state_dicts([{k: 0.5 * v for k, v in sd.items()}, sd])
    with torch.no_grad():
        srecon, skl = stack.elbo_terms(flat, t(np.stack([x, x])), t(np.stack([noise, noise])))
        np.testing.assert_allclose(stack.forward(flat, t(np.stack([x, x])))[1].numpy(),
                                   pm(t(x)).numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(srecon[1].numpy(), precon.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(skl[1].numpy(), pkl.numpy(), rtol=0, atol=1e-5)


def test_registration_defaults_and_converters():
    module = lookup_factory("AutoEncoder", "feedforward_variational")(10)
    assert (module.dims, module.latent_dim, module.func) == ((128, 64), 16, "tanh")
    assert sum(p.numel() for p in module.parameters()) == 22442
    jparams = _jax_params(jax_vae(10))
    assert sum(a.size for a in jax.tree.leaves(jparams)) == 22442
    sd = vae_from_flax(jparams)
    assert {k: v.shape for k, v in sd.items()} == {k: tuple(v.shape) for k, v in module.state_dict().items()}
    back = vae_to_flax(sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jparams)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    # the dispatch reads the tree's names, not the registry type: an
    # AutoEncoder's tree may be a dense or a variational model
    assert params_from_flax(jparams).keys() == sd.keys()
    assert params_to_flax(sd)["params"].keys() == jparams["params"].keys()
    # a module's stack is chosen by the module, not the estimator class
    est = AutoEncoder(device="cpu", **ARCH)
    assert isinstance(est._stack(est._build_module(F)), train_core.StackedVAE)
    with pytest.raises(NotImplementedError, match="'float32' or 'bfloat16'"):
        lookup_factory("AutoEncoder", "feedforward_variational")(F, compute_dtype="float16")


def _jax_perm(perm_rng, mask):
    keys = jax.random.uniform(perm_rng, (mask.shape[-1],))
    return np.asarray(jnp.argsort(jnp.where(jnp.asarray(mask) > 0, keys, 2.0)))


def test_epoch_matches_jax_with_its_permutation_and_noise():
    """One epoch of make_train_fns (5 batches of 8, the last one partly
    padding, kl_weight 0.5) from JAX's initial parameters, with JAX's
    permutation and the noise JAX drew for each batch."""
    bs, n_pad, n, latent, kl_weight = 8, 40, 37, 3, 0.5
    X = np.zeros((n_pad, F), np.float32)
    X[:n] = np.random.RandomState(2).rand(n, F)
    mask = (np.arange(n_pad) < n).astype(np.float32)
    jm = jax_vae(F, dims=(8,), latent_dim=latent)
    opt = ref.make_optimizer("adam", 1e-3)
    init_fn, epoch_fn = ref.make_train_fns(jm, opt, bs, loss="vae", kl_weight=kl_weight)
    state = init_fn(jax.random.PRNGKey(3), jnp.zeros((F,)))
    _, perm_rng, batch_base = jax.random.split(state.rng, 3)
    perm = _jax_perm(perm_rng, mask)
    noise = np.stack([jax_noise(jm, state.params, jax.random.fold_in(batch_base, i), (bs, latent))
                      for i in range(n_pad // bs)])
    jstate, jloss = jax.jit(epoch_fn)(state, jnp.asarray(X), jnp.asarray(X), jnp.asarray(mask))

    stack = train_core.StackedVAE(_port(state.params, (8,), latent))
    flat = stack.from_state_dicts([vae_from_flax(jax.tree.map(np.asarray, state.params))])
    p_init, p_epoch = train_core.make_train_fns(stack, train_core.make_optimizer("adam", 1e-3), bs,
                                                loss="vae", kl_weight=kl_weight)
    pstate = p_init([train_core.member_generator(0, 0)], CPU, params=flat)
    pstate, ploss = p_epoch(pstate, t(X[None]), t(X[None]), t(mask[None]), torch.full((1,), 1e-3),
                            perm=torch.from_numpy(perm[None].astype(np.int64)), noise=t(noise[None]))
    np.testing.assert_allclose(float(ploss[0]), float(jloss), **TIGHT)
    want = vae_from_flax(jax.tree.map(np.asarray, jstate.params))
    for k, v in stack.state_dicts(pstate.params)[0].items():
        np.testing.assert_allclose(v, want[k], err_msg=k, **TIGHT)


def test_validation_loss_matches_jax_with_its_noise():
    bs, n_pad, n, latent = 8, 24, 21, 3
    X = np.zeros((n_pad, F), np.float32)
    X[:n] = np.random.RandomState(3).rand(n, F)
    mask = (np.arange(n_pad) < n).astype(np.float32)
    jm = jax_vae(F, dims=(8,), latent_dim=latent)
    params = _jax_params(jm, seed=4)
    state = ref.TrainState(params, None, None)
    want = float(ref.make_eval_fn(jm, bs, loss="vae", kl_weight=2.0)(state, jnp.asarray(X), jnp.asarray(X),
                                                                      jnp.asarray(mask)))
    # JAX validates every batch with one fixed key: one noise block
    noise = jax_noise(jm, params, jax.random.PRNGKey(0), (bs, latent))
    stack = train_core.StackedVAE(_port(params, (8,), latent))
    flat = stack.from_state_dicts([vae_from_flax(params)])
    eval_fn = train_core.make_eval_fn(stack, bs, loss="vae", kl_weight=2.0)
    got = eval_fn(flat, t(X[None]), t(X[None]), t(mask[None]), noise=t(noise))
    np.testing.assert_allclose(float(got[0]), want, **TIGHT)
    # the port's own fixed block (a generator seeded 0) is what it uses
    # when none is given: deterministic, another stream than JAX's
    own = eval_fn(flat, t(X[None]), t(X[None]), t(mask[None]))
    np.testing.assert_array_equal(
        own.numpy(), eval_fn(flat, t(X[None]), t(X[None]), t(mask[None]),
                             noise=train_core.validation_noise(bs, latent)).numpy())


def test_single_fit_trains_the_elbo():
    X = np.random.RandomState(5).rand(120, F).astype("f4")
    kw = dict(epochs=2, batch_size=32, device="cpu", **ARCH)
    auto = AutoEncoder(validation_split=0.25, **kw).fit(X)
    vae = AutoEncoder(loss="vae", validation_split=0.25, **kw).fit(X)
    mse = AutoEncoder(loss="mse", validation_split=0.25, **kw).fit(X)
    assert auto.history == vae.history
    for k in auto.params_:
        np.testing.assert_array_equal(auto.params_[k], vae.params_[k])
    # ELBO = reconstruction + KL: above the plain MSE of the same draws
    assert auto.history["loss"][0] > mse.history["loss"][0]
    assert auto.get_params()["loss"] == "auto"
    assert auto.predict(X).shape == X.shape


# ------------------------------------------------------------------ #
# the fleet
# ------------------------------------------------------------------ #


def _members(n, rows, seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for i in range(n):
        r = rows[i] if isinstance(rows, list) else rows
        tt = np.arange(r)[:, None]
        X = np.sin(0.05 * (i + 1) * tt * np.arange(1, F + 1)) + 0.05 * rng.randn(r, F)
        out[f"m{i}"] = X.astype("f4")
    return out


def _fit(members, **kw):
    cfg = dict(epochs=2, batch_size=16, device="cpu", **ARCH)
    cfg.update(kw)
    return FleetTrainer(**cfg).fit(members)


def _same(a, b):
    for name in a:
        for k in a[name].params:
            np.testing.assert_array_equal(a[name].params[k], b[name].params[k])
        assert a[name].history == b[name].history


def test_fleet_auto_loss_trains_the_elbo():
    """``loss="auto"`` resolves per module to the ELBO, never plain MSE
    (the JAX suite's test_vae_kind_trains_with_elbo); the configured loss
    rides into the unstacked estimator."""
    members = _members(2, 96)
    auto = _fit(members)
    _same(auto, _fit(members, loss="vae"))
    mse = _fit(members, loss="mse")
    for name in members:
        assert np.isfinite(auto[name].history["loss"]).all()
        assert auto[name].history["loss"][0] > mse[name].history["loss"][0]
    assert mse["m0"].to_estimator().base_estimator.steps[-1][1].loss == "mse"
    assert auto["m0"].to_estimator().base_estimator.steps[-1][1].loss == "auto"
    assert auto["m0"].threshold_method == "exact"


def test_fleet_draws_do_not_depend_on_width_or_item_padding():
    """Member draws (initialization, shuffles, noise) depend on the seed,
    the member's position, the epoch, its real items and the batch size:
    a narrower gang, and items not rounded up the ladder, train the same
    members bitwise."""
    # 80 rows: 5 batches of 16 exact, 6 on the ladder; one bucket either way
    members = _members(5, 80, seed=1)
    wide = _fit(members, validation_split=0.2)
    _same({n: wide[n] for n in ("m0", "m1")}, _fit({n: members[n] for n in ("m0", "m1")}, validation_split=0.2))
    _same(wide, _fit(members, validation_split=0.2, quantize_rows=False))


def test_fleet_member_zero_is_its_single_fit():
    members = _members(3, [100, 80, 60], seed=2)
    fleet = _fit(members, validation_split=0.2, epochs=3)
    m0 = fleet["m0"]
    scaled = (members["m0"] - m0.scaler.shift) * m0.scaler.scale
    single = AutoEncoder(epochs=3, batch_size=16, validation_split=0.2, device="cpu", **ARCH).fit(scaled)
    for k, v in single.params_.items():
        np.testing.assert_allclose(m0.params[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(m0.history[key], single.history[key], rtol=1e-5, atol=1e-6)


def test_fleet_members_serve_as_bank_entries():
    members = _members(3, 60, seed=3)
    out = _fit(members, threshold_quantile=0.9)
    bank = ModelBank.from_entries([m.to_entry() for m in out.values()], device="cpu")
    for name, X in members.items():
        det = out[name].to_estimator()
        want = det.anomaly(X[:25])
        got = bank.score(name, X[:25]).to_arrays()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
        # exact quantile thresholds of the dense family
        scaled = det.anomaly(X)["total-anomaly-scaled"]
        np.testing.assert_allclose(out[name].total_threshold, np.quantile(scaled, 0.9), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ #
# detectors and the bank against the JAX package on the same weights
# ------------------------------------------------------------------ #


@pytest.fixture(scope="module")
def jax_detectors():
    rng = np.random.RandomState(0)
    out = {}
    for name, scaled in {"v": False, "vs": True}.items():
        est = JaxAE(epochs=1, batch_size=32, **ARCH)
        if scaled:
            est = SkPipeline([("scale", SkMinMax()), ("model", est)])
        det = JaxDetector(base_estimator=est)
        X = (rng.rand(64, F) * (2.0 if scaled else 1.0)).astype("f4")
        det.fit(pd.DataFrame(X, columns=[f"{name}-{i}" for i in range(F)]))
        out[name] = (det, X)
    return out


def test_bank_and_anomaly_match_jax(jax_detectors, tmp_path):
    models = {n: d for n, (d, _X) in jax_detectors.items()}
    data = {n: X for n, (_d, X) in jax_detectors.items()}
    entries = []
    for name, det in models.items():
        e, reason = _extract_entry(name, det)
        assert e is not None, reason
        entries.append(entry_from_numpy(name, e.registry_type, e.kind, e.factory_kwargs, e.n_features,
                                        e.params, e.in_shift, e.in_scale, e.err_shift, e.err_scale,
                                        tags=det.tags_))
    requests = [("v", data["v"][:30], None), ("vs", data["vs"][:1], None),
                ("vs", data["vs"][3:50], data["vs"][3:50] + 0.1)]
    want = JaxBank.from_models(models, registry=False, bank_kernel="interpret").score_many(requests)
    got = ModelBank.from_entries(entries, device="cpu").score_many(requests)
    for (name, _X, _y), g, w in zip(requests, got, want):
        for k, a in g.to_arrays().items():
            np.testing.assert_allclose(a, np.asarray(w.to_arrays()[k]), err_msg=f"{name} {k}", **BAND)
    for entry in entries:
        serializer.dump(entry, str(tmp_path / entry.name))
        assert set(np.load(str(tmp_path / entry.name / "params.npz")).files) == {
            f"params/{layer}/{leaf}" for layer in ("enc_0", "mu", "logvar", "dec_0", "out")
            for leaf in ("kernel", "bias")}
        det = serializer.load(str(tmp_path / entry.name), device="cpu")
        X = data[entry.name]
        ours = det.anomaly(X)
        theirs = models[entry.name].anomaly(pd.DataFrame(X, columns=models[entry.name].tags_))
        np.testing.assert_allclose(ours["total-anomaly-scaled"],
                                   theirs[("total-anomaly-scaled", "")].values, **BAND)
        np.testing.assert_allclose(ours["model-output"], theirs["model-output"].values, **BAND)


def test_detector_fit_matches_jax_given_the_same_base_params(jax_detectors):
    jax_det, X = jax_detectors["vs"]
    jax_est = jax_det.base_estimator.steps[-1][1]
    frame = pd.DataFrame(X, columns=jax_det.tags_)
    est = AutoEncoder(device="cpu", **ARCH)
    est.params_ = vae_from_flax(jax.tree.map(np.asarray, jax_est.params_))
    est.n_features_ = F
    est.fit = lambda X, y=None: est
    det = DiffBasedAnomalyDetector(base_estimator=Pipeline([("s", MinMaxScaler()), ("m", est)])).fit(frame)
    for got, want in zip(det.error_scaler_, jax_det.error_scaler_):
        np.testing.assert_allclose(got, want, **BAND)
    np.testing.assert_allclose(det.feature_thresholds_, jax_det.feature_thresholds_, **BAND)
    np.testing.assert_allclose(det.total_threshold_, jax_det.total_threshold_, **BAND)
    Xs = SkMinMax().fit_transform(X).astype("f4")
    np.testing.assert_allclose(est.predict(Xs), jax_est.predict(Xs), **TIGHT)


def test_build_fleet_with_variational_machines(tmp_path):
    dataset = {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00Z",
               "train_end_date": "2020-01-01T12:00:00Z", "tag_list": ["a", "b", "c", "d"]}
    model = {"gordo_components_tpu.models.DiffBasedAnomalyDetector": {"base_estimator": {
        "sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler",
            {"gordo_components_tpu.models.AutoEncoder": {
                "kind": "feedforward_variational", "dims": [8], "latent_dim": 3,
                "epochs": 2, "batch_size": 16}}]}}}}
    machines = [{"name": f"vae-{i}", "dataset": dataset, "model": model} for i in range(2)]
    machines.append({"name": "dense", "dataset": dataset})
    report = build_fleet(machines, str(tmp_path / "out"), device="cpu")
    assert sorted(report) == ["dense", "vae-0", "vae-1"] and not report.failed
    entries = [serializer.load_entry(report[n], name=n) for n in report]
    bank = ModelBank.from_entries(entries, device="cpu")
    assert bank.n_buckets == 2  # the variational kind is its own dense bucket
    meta = serializer.load_metadata(report["vae-0"])
    assert meta["model"]["fleet_trained"] is True
    X = np.random.RandomState(0).rand(30, F).astype("f4")
    for n in report:
        want = serializer.load(report[n], device="cpu").anomaly(X)
        got = bank.score(n, X).to_arrays()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


def test_single_and_gang_builds_cross_validate_variational_models(tmp_path):
    """The single build's cross-validation of a bare variational detector
    (no scaler step: the single-build path) and the gang's, 3 folds of 72
    rows each."""
    from gordo_components_torch.builder import build_model

    dataset = {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00Z",
               "train_end_date": "2020-01-01T12:00:00Z", "tag_list": ["a", "b", "c", "d"]}
    evaluation = {"cross_validation": True, "n_splits": 3}
    arch = {"kind": "feedforward_variational", "dims": [8], "latent_dim": 3, "epochs": 2, "batch_size": 8}
    bare = {"gordo_components_torch.models.DiffBasedAnomalyDetector": {"base_estimator": {
        "gordo_components_torch.models.AutoEncoder": arch}}}
    _model, meta = build_model("single", bare, dict(dataset), evaluation_config=evaluation, device="cpu")
    scaled = {"gordo_components_torch.models.DiffBasedAnomalyDetector": {"base_estimator": {
        "sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler", {"gordo_components_torch.models.AutoEncoder": arch}]}}}}
    report = build_fleet([{"name": "gang", "dataset": dataset, "model": scaled, "evaluation": evaluation}],
                         str(tmp_path / "out"), device="cpu")
    gang = serializer.load_metadata(report["gang"])["model"]
    assert gang["fleet_trained"] and gang["fleet_stats"]["cv_fold_members"] == 3
    for cv in (meta["model"]["cross-validation"], gang["cross-validation"]):
        ev = cv["explained-variance"]["per-fold"]
        assert len(ev) == 3 and np.isfinite(ev).all()
