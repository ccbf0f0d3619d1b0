"""The port's conv autoencoder (``BASELINE.json`` config 4) against the JAX
package's, on the CPU.

Bands: the forward within atol=1e-5, the JAX suite's own band between its
two conv formulations (tests/test_conv_impl.py), against both of them; an
epoch from JAX's initial parameters and permutation holds the loss and the
parameters within rtol=1e-5, atol=1e-6; the fleet from the same initial
parameters within rtol=1e-4, atol=1e-5 (parameters, losses, input and error
scalers, q = 1 thresholds), its q < 1 thresholds from 8192-bin histograms
within two bins (as tests/test_torch_seq_fleet.py); the detector, the
bank and ``anomaly()`` against the JAX package's on the same weights within
rtol=1e-4, atol=1e-5. The converters round-trip bitwise.
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
    conv_from_flax,
    conv_to_flax,
    entry_from_numpy,
    params_from_flax,
    params_to_flax,
)
from gordo_components_torch.models import (
    ConvAutoEncoder,
    DiffBasedAnomalyDetector,
    LSTMAutoEncoder,
    lookup_factory,
    train_core,
)
from gordo_components_torch.models.factories import conv as pconv
from gordo_components_torch.models.transformers import MinMaxScaler, Pipeline
from gordo_components_torch.parallel import FleetTrainer
from gordo_components_torch.server import ModelBank
from gordo_components_torch.server import bank as port_bank
from gordo_components_tpu.models import ConvAutoEncoder as JaxConvAE
from gordo_components_tpu.models import DiffBasedAnomalyDetector as JaxDetector
from gordo_components_tpu.models import train_core as ref
from gordo_components_tpu.models.factories.conv import conv1d_autoencoder as jax_conv
from gordo_components_tpu.parallel import FleetTrainer as JaxFleetTrainer
from gordo_components_tpu.parallel import fleet as jax_fleet
from gordo_components_tpu.server.bank import ModelBank as JaxBank
from gordo_components_tpu.server.bank import _extract_entry

FORWARD_ATOL = 1e-5
EPOCH = dict(rtol=1e-5, atol=1e-6)
BAND = dict(rtol=1e-4, atol=1e-5)
BINS = 8192
F = 3
CPU = torch.device("cpu")


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _jax_params(module, lookback, seed=0):
    x = jnp.zeros((1, lookback, module.n_features))
    return jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(seed), x))


def _port_module(channels, K, f=F, **kw):
    return lookup_factory("ConvAutoEncoder", "conv1d_autoencoder")(f, channels=channels, kernel_size=K, **kw)


@pytest.mark.parametrize("impl", ["matmul", "lax"])
@pytest.mark.parametrize("K", [2, 3, 5])
@pytest.mark.parametrize("channels", [(4, 2), (8, 4)], ids=["c4-2", "c8-4"])
@pytest.mark.parametrize("lookback", [8, 10, 16])
def test_forward_matches_jax(lookback, channels, K, impl):
    """Lookback 10 is not a multiple of 2 ** len(channels): the decoder's
    length is 12, and the last step is taken on both sides."""
    jm = jax_conv(F, channels=channels, kernel_size=K, conv_impl=impl)
    params = _jax_params(jm, lookback, seed=K)
    x = np.random.RandomState(lookback).randn(5, lookback, F).astype("f4")
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    pm = _port_module(channels, K, conv_impl=impl)
    pm.load_state_dict({k: t(v) for k, v in conv_from_flax(params).items()})
    with torch.no_grad():
        got = pm(t(x)).numpy()
    assert got.shape == want.shape == (5, F)
    np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_ATOL)
    # the stack's forward runs members at once: member 1 is this module
    stack = train_core.StackedConv(pm, lookback)
    flat = stack.from_state_dicts([{k: 0.5 * v for k, v in conv_from_flax(params).items()},
                                   conv_from_flax(params)])
    with torch.no_grad():
        both = stack.forward(flat, t(np.stack([x, x])))
    np.testing.assert_allclose(both[1].numpy(), got, rtol=0, atol=1e-6)


def test_registration_defaults_and_refusals(monkeypatch):
    """Registered under ConvAutoEncoder and LSTMAutoEncoder; the defaults'
    parameter count; conv_impl from GORDO_CONV_IMPL; a bad conv_impl and a
    transposed stride other than 2 raise with JAX's messages."""
    for registry_type in ("ConvAutoEncoder", "LSTMAutoEncoder"):
        module = lookup_factory(registry_type, "conv1d_autoencoder")(10)
        assert isinstance(module, pconv.Conv1DAutoEncoder) and module.channels == (32, 16)
    module = lookup_factory("ConvAutoEncoder", "conv1d_autoencoder")(10)
    assert (module.kernel_size, module.func) == (3, "relu")
    assert sum(p.numel() for p in module.parameters()) == 5866
    jparams = _jax_params(jax_conv(10), 16)
    assert sum(a.size for a in jax.tree.leaves(jparams)) == 5866
    assert list(module.state_dict()) == [
        "Conv_0.kernel", "Conv_0.bias", "Conv_1.kernel", "Conv_1.bias",
        "ConvTranspose_0.kernel", "ConvTranspose_0.bias", "ConvTranspose_1.kernel",
        "ConvTranspose_1.bias", "Conv_2.kernel", "Conv_2.bias"]
    for k, v in conv_from_flax(jparams).items():
        assert tuple(module.state_dict()[k].shape) == v.shape, k
    with pytest.raises(ValueError, match="conv_impl must be 'lax' or 'matmul', got 'fast'"):
        _port_module((4,), 3, conv_impl="fast")
    with pytest.raises(ValueError, match="conv_impl must be 'lax' or 'matmul', got 'fast'"):
        jax_conv(F, conv_impl="fast").init(jax.random.PRNGKey(0), jnp.zeros((1, 8, F)))
    monkeypatch.setenv("GORDO_CONV_IMPL", "Bogus")
    with pytest.raises(ValueError, match="'bogus'"):
        _port_module((4,), 3)
    monkeypatch.setenv("GORDO_CONV_IMPL", "lax")
    _port_module((4,), 3)
    x = torch.rand(1, 2, 4, 3)
    with pytest.raises(NotImplementedError, match="stride 2"):
        pconv.conv_transpose1d(x, torch.rand(1, 3, 3, 2), torch.zeros(1, 2), stride=3)
    with pytest.raises(NotImplementedError, match="'float32' or 'bfloat16'"):
        _port_module((4,), 3, compute_dtype="float16")
    # the estimator pins conv_impl, as the JAX one does
    est = ConvAutoEncoder(device="cpu")
    assert est.get_params()["conv_impl"] == JaxConvAE().get_params()["conv_impl"] == "matmul"
    assert est.lookback_window == 16 and est.kind == "conv1d_autoencoder"


def test_init_draws_flax_conv_fan_in():
    """Flax's lecun_normal takes a conv kernel's fan-in over its receptive
    field (K * F_in): Conv_0 at K = 3, F = 10 has a standard deviation of
    about 0.18, where a fan-in of F alone would give about 0.30."""
    module = _port_module((8, 4), 3, f=10)
    stack = train_core.StackedConv(module, 16)
    flat = stack.init([train_core.member_generator(0, i) for i in range(64)])
    pieces = stack.pieces(flat)
    jm = jax_conv(10, channels=(8, 4), kernel_size=3)
    jax_trees = [conv_from_flax(_jax_params(jm, 16, seed=s)) for s in range(64)]
    for name in stack.layer_names:
        got = pieces[f"{name}.kernel"]
        want = np.stack([tr[f"{name}.kernel"] for tr in jax_trees])
        K, f_in, _ = got.shape[1:]
        np.testing.assert_allclose(float(got.std()), float(want.std()), rtol=0.08, err_msg=name)
        # truncated at two standard deviations of the untruncated normal
        assert float(got.abs().max()) <= 2 * (1 / (K * f_in)) ** 0.5 / train_core._TRUNC_STD + 1e-6
        assert torch.all(pieces[f"{name}.bias"] == 0)
    assert abs(float(pieces["Conv_0.kernel"].std()) - (1 / 30) ** 0.5) < 0.01
    # a member's draws do not depend on the gang's width; the dense draw is
    # unchanged by the receptive-field argument
    assert torch.equal(stack.init([train_core.member_generator(0, i) for i in range(2)]), flat[:2])
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    assert torch.equal(train_core.lecun_normal((7, 4), g1), train_core.lecun_normal((7, 4), g2, 1))


def _jax_perm(rng_key, mask):
    _, perm_rng, _ = jax.random.split(rng_key, 3)
    keys = jax.random.uniform(perm_rng, (mask.shape[-1],))
    return np.asarray(jnp.argsort(jnp.where(jnp.asarray(mask) > 0, keys, 2.0)))


@pytest.mark.parametrize("lookback", [8, 10])
def test_epoch_matches_jax_from_its_parameters_and_permutation(lookback):
    """One epoch of the windowed train fns (5 batches of 8, the last one
    partly padding) from JAX's initial parameters with JAX's permutation."""
    channels, K, bs, n_pad = (4, 2), 3, 8, 40
    rows = n_pad - 3 + lookback - 1
    X = np.zeros((n_pad + lookback - 1, F), np.float32)
    X[:rows] = np.random.RandomState(lookback).rand(rows, F)
    mask = (np.arange(n_pad) < rows - lookback + 1).astype(np.float32)
    jm = jax_conv(F, channels=channels, kernel_size=K)
    opt = ref.make_optimizer("adam", 1e-3)
    init_fn, epoch_fn = ref.make_seq_train_fns(jm, opt, bs, lookback)
    state = init_fn(jax.random.PRNGKey(3), jnp.zeros((lookback, F)))
    perm = _jax_perm(state.rng, mask)
    jstate, jloss = jax.jit(epoch_fn)(state, jnp.asarray(X), None, jnp.asarray(mask))

    stack = train_core.StackedConv(_port_module(channels, K), lookback)
    flat = stack.from_state_dicts([conv_from_flax(jax.tree.map(np.asarray, state.params))])
    p_init, p_epoch = train_core.make_train_fns(stack, train_core.make_optimizer("adam", 1e-3), bs)
    pstate = p_init([train_core.member_generator(0, 0)], CPU, params=flat)
    pstate, ploss = p_epoch(pstate, t(X[None]), t(X[None]), t(mask[None]), torch.full((1,), 1e-3),
                            perm=torch.from_numpy(perm[None].astype(np.int64)))
    np.testing.assert_allclose(float(ploss[0]), float(jloss), **EPOCH)
    want = conv_from_flax(jax.tree.map(np.asarray, jstate.params))
    for k, v in stack.state_dicts(pstate.params)[0].items():
        np.testing.assert_allclose(v, want[k], err_msg=k, **EPOCH)
    assert int(pstate.opt_state.count[0]) == 5


# ------------------------------------------------------------------ #
# the fleet
# ------------------------------------------------------------------ #

ARCH = dict(channels=(4, 2), kernel_size=3, lookback_window=8)
PARITY_BATCH = 64  # at least every member's items: one batch an epoch


def _members(n, rows, features=F, seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for i in range(n):
        r = rows[i] if isinstance(rows, list) else rows
        tt = np.arange(r)[:, None]
        X = np.sin(0.05 * (i + 1) * tt * np.arange(1, features + 1)) + 0.05 * rng.randn(r, features)
        out[f"m{i}"] = X.astype("f4")
    return out


def _initial(members):
    module = _port_module(ARCH["channels"], ARCH["kernel_size"])
    stack = train_core.StackedConv(module, ARCH["lookback_window"])
    states = stack.state_dicts(stack.init([train_core.member_generator(11, i) for i in range(len(members))]))
    return dict(zip(members, states))


@pytest.fixture(scope="module")
def jax_conv_fleet():
    members = _members(5, [60 - 3 * i for i in range(5)])
    initial = _initial(members)
    out = JaxFleetTrainer(model_type="ConvAutoEncoder", epochs=3, batch_size=PARITY_BATCH,
                          learning_rate=1e-2, **ARCH).fit(
        members, initial_params={n: conv_to_flax(sd) for n, sd in initial.items()})
    return members, initial, out


def _jax_error_pass(members, jax_out, q):
    module = jax_conv(F, channels=ARCH["channels"], kernel_size=ARCH["kernel_size"])
    lookback = ARCH["lookback_window"]
    X = np.zeros((len(members), PARITY_BATCH + lookback - 1, F), np.float32)
    mask = np.zeros((len(members), PARITY_BATCH), np.float32)
    for i, (name, rows) in enumerate(members.items()):
        scaler = jax_fleet.ScalerParams(*jax_out[name].scaler)
        X[i, :len(rows)] = jax_fleet.scaler_transform(scaler, jnp.asarray(rows))
        mask[i, :len(rows) - lookback + 1] = 1.0
    params = jax.tree.map(lambda *a: jnp.stack(a), *(jax_out[n].params for n in members))
    run = jax_fleet._BucketPrograms._make_seq_error_scalers(module, PARITY_BATCH, lookback, 0, q=q)
    return jax.tree.map(np.asarray, run(params, jnp.asarray(X), jnp.asarray(mask)))


@pytest.mark.parametrize("q", [1.0, 0.99])
def test_fleet_matches_jax_from_the_same_initial_params(q, jax_conv_fleet):
    members, initial, jax_out = jax_conv_fleet
    out = FleetTrainer(model_type="ConvAutoEncoder", epochs=3, batch_size=PARITY_BATCH, learning_rate=1e-2,
                       threshold_quantile=q, device="cpu", **ARCH).fit(members, initial_params=initial)
    es, feat, tot = _jax_error_pass(members, jax_out, q)
    for i, (name, want) in enumerate(jax_out.items()):
        got = out[name]
        jparams = conv_from_flax(want.params)
        for k in jparams:
            np.testing.assert_allclose(got.params[k], jparams[k], err_msg=k, **BAND)
        np.testing.assert_allclose(got.history["loss"], want.history["loss"], **BAND)
        for g, w in (*zip(got.scaler, want.scaler), *zip(got.error_scaler, (es.shift[i], es.scale[i]))):
            np.testing.assert_allclose(g, np.asarray(w), **BAND)
        if q >= 1.0:
            np.testing.assert_allclose(got.feature_thresholds, want.feature_thresholds, **BAND)
            np.testing.assert_allclose(got.total_threshold, want.total_threshold, **BAND)
            assert got.threshold_method == want.threshold_method
        else:
            np.testing.assert_allclose(got.feature_thresholds, feat[i], rtol=0, atol=2 / BINS)
            np.testing.assert_allclose(got.total_threshold, tot[i], rtol=0, atol=2 * np.sqrt(F) / BINS)
        # the label JAX's _BucketPrograms.threshold_method gives at q
        assert got.threshold_method == ("exact" if q >= 1.0 else f"histogram-{BINS}")
        assert got.lookback_window == want.lookback_window == 8


def test_fleet_members_predict_serve_and_match_their_single_fit():
    members = _members(3, 70, seed=2)
    kw = dict(epochs=2, batch_size=16, device="cpu", **ARCH)
    out = FleetTrainer(model_type="ConvAutoEncoder", validation_split=0.2, **kw).fit(members)
    assert len(out["m0"].history["val_loss"]) == 2
    bank = ModelBank.from_entries([m.to_entry() for m in out.values()], device="cpu")
    for name, X in members.items():
        det = out[name].to_estimator()
        entry = out[name].to_entry()
        assert (entry.registry_type, entry.lookback, entry.target_offset) == ("ConvAutoEncoder", 8, 0)
        want = det.anomaly(X[:30])
        got = bank.score(name, X[:30]).to_arrays()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
        assert det.anomaly(X)["total-anomaly-scaled"].max() <= out[name].total_threshold + 1e-6
    # member 0 of the gang is its single fit over the fleet's scaled rows
    fleet0 = FleetTrainer(model_type="ConvAutoEncoder", **kw).fit(members)["m0"]
    scaled = (members["m0"] - fleet0.scaler.shift) * fleet0.scaler.scale
    single = ConvAutoEncoder(**kw).fit(scaled)
    for k, v in single.params_.items():
        np.testing.assert_allclose(fleet0.params[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(fleet0.history["loss"], single.history["loss"], rtol=1e-5, atol=1e-6)


def test_lstm_autoencoder_of_the_conv_kind_fits_and_serves(tmp_path):
    """``LSTMAutoEncoder(kind="conv1d_autoencoder")`` trains the conv stack
    (chosen by the module), scores windows in ``anomaly()``, writes and
    reads its artifact through the conv converter and serves from a conv
    bucket: the same model as ``ConvAutoEncoder`` with the same seed."""
    frame = pd.DataFrame(_members(1, 80)["m0"], columns=["a", "b", "c"])
    kw = dict(lookback_window=8, channels=(4, 2), epochs=2, batch_size=16, device="cpu")
    lstm = LSTMAutoEncoder(kind="conv1d_autoencoder", **kw)
    assert isinstance(lstm._stack(lstm._build_module(F)), train_core.StackedConv)
    conv = ConvAutoEncoder(**kw)
    dets = [DiffBasedAnomalyDetector(base_estimator=Pipeline([("s", MinMaxScaler()), ("m", est)])).fit(frame)
            for est in (lstm, conv)]
    for k, v in conv.params_.items():
        np.testing.assert_array_equal(lstm.params_[k], v)
    want = dets[1].anomaly(frame)
    got = dets[0].anomaly(frame)
    assert got["model-output"].shape == (80 - 7, F)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    serializer.dump(dets[0], str(tmp_path / "lstm-conv"))
    loaded = serializer.load(str(tmp_path / "lstm-conv"), device="cpu")
    entry = serializer.load_entry(str(tmp_path / "lstm-conv"))
    assert entry.registry_type == "LSTMAutoEncoder" and set(entry.params) == set(conv.params_)
    bank = ModelBank.from_entries([entry], device="cpu")
    assert isinstance(next(iter(bank._buckets.values())), port_bank._ConvBucket)
    for k, v in loaded.anomaly(frame).items():
        np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-6)
        np.testing.assert_allclose(bank.score("lstm-conv", frame.values).to_arrays()[k], want[k],
                                   rtol=0, atol=1e-5)


def test_converters_round_trip_and_dispatch_on_the_tree():
    jparams = _jax_params(jax_conv(F, channels=(4, 2)), 8)
    sd = conv_from_flax(jparams)
    back = conv_to_flax(sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jparams)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    # the dispatch reads the tree's names: a conv tree is a conv state dict
    # whichever registry type holds it
    assert params_from_flax(jparams).keys() == sd.keys()
    assert params_to_flax(sd)["params"].keys() == jparams["params"].keys()
    with pytest.raises(ValueError, match="no ported model family"):
        params_from_flax({"params": {"Bogus_0": {"kernel": np.zeros(1)}}})
    with pytest.raises(ValueError, match="Conv1DAutoEncoder"):
        conv_from_flax({"params": {"Conv_0": {"kernel": np.zeros(1), "bias": np.zeros(1)},
                                   "Dense_0": {"kernel": np.zeros(1), "bias": np.zeros(1)}}})


# ------------------------------------------------------------------ #
# detectors and the bank against the JAX package on the same weights
# ------------------------------------------------------------------ #


@pytest.fixture(scope="module")
def jax_detectors():
    rng = np.random.RandomState(0)
    out = {}
    for name, (lookback, scaled) in {"c16": (16, False), "c10s": (10, True)}.items():
        est = JaxConvAE(lookback_window=lookback, channels=(4, 2), epochs=1, batch_size=64)
        if scaled:
            est = SkPipeline([("scale", SkMinMax()), ("model", est)])
        det = JaxDetector(base_estimator=est)
        X = (rng.rand(80, F) * (2.0 if scaled else 1.0)).astype("f4")
        det.fit(pd.DataFrame(X, columns=[f"{name}-{i}" for i in range(F)]))
        out[name] = (det, X)
    return out


def _port_entry(name, det):
    e, reason = _extract_entry(name, det)
    assert e is not None, reason
    return entry_from_numpy(name, e.registry_type, e.kind, e.factory_kwargs, e.n_features, e.params,
                            e.in_shift, e.in_scale, e.err_shift, e.err_scale, tags=det.tags_,
                            lookback=e.lookback, target_offset=e.target_offset)


def test_bank_and_anomaly_match_jax(jax_detectors, tmp_path):
    models = {n: d for n, (d, _X) in jax_detectors.items()}
    data = {n: X for n, (_d, X) in jax_detectors.items()}
    entries = [_port_entry(n, d) for n, d in models.items()]
    requests = [("c16", data["c16"][:40], None), ("c10s", data["c10s"][:10], None),
                ("c10s", data["c10s"][5:70], data["c10s"][5:70] + 0.1)]
    want = JaxBank.from_models(models, registry=False, bank_kernel="interpret").score_many(requests)
    bank = ModelBank.from_entries(entries, device="cpu")
    assert sorted(b.label for b in bank._buckets.values()) == [
        "ConvAutoEncoder:conv1d_autoencoder:f3:l10", "ConvAutoEncoder:conv1d_autoencoder:f3:l16"]
    got = bank.score_many(requests)
    for (name, X, _y), g, w in zip(requests, got, want):
        assert g.offset == w.offset
        for k, a in g.to_arrays().items():
            np.testing.assert_allclose(a, np.asarray(w.to_arrays()[k]), err_msg=f"{name} {k}", **BAND)
    for entry in entries:
        serializer.dump(entry, str(tmp_path / entry.name))
        det = serializer.load(str(tmp_path / entry.name), device="cpu")
        X = data[entry.name]
        ours = det.anomaly(X)
        theirs = models[entry.name].anomaly(pd.DataFrame(X, columns=models[entry.name].tags_))
        np.testing.assert_allclose(ours["total-anomaly-scaled"],
                                   theirs[("total-anomaly-scaled", "")].values, **BAND)
        np.testing.assert_allclose(ours["model-output"], theirs["model-output"].values, **BAND)


def test_detector_fit_matches_jax_given_the_same_base_params(jax_detectors):
    """Error scaler and thresholds of a port detector over the JAX
    estimator's fitted parameters."""
    jax_det, X = jax_detectors["c10s"]
    jax_est = jax_det.base_estimator.steps[-1][1]
    frame = pd.DataFrame(X, columns=jax_det.tags_)
    est = ConvAutoEncoder(lookback_window=10, channels=(4, 2), device="cpu")
    est.params_ = conv_from_flax(jax.tree.map(np.asarray, jax_est.params_))
    est.n_features_ = F
    est.fit = lambda X, y=None: est
    det = DiffBasedAnomalyDetector(base_estimator=Pipeline([("s", MinMaxScaler()), ("m", est)])).fit(frame)
    for got, want in zip(det.error_scaler_, jax_det.error_scaler_):
        np.testing.assert_allclose(got, want, **BAND)
    np.testing.assert_allclose(det.feature_thresholds_, jax_det.feature_thresholds_, **BAND)
    np.testing.assert_allclose(det.total_threshold_, jax_det.total_threshold_, **BAND)
    assert det.offset == 9


def test_build_fleet_with_conv_machines(tmp_path):
    dataset = {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00Z",
               "train_end_date": "2020-01-01T12:00:00Z", "tag_list": ["a", "b", "c"]}
    model = {"gordo_components_tpu.models.DiffBasedAnomalyDetector": {"base_estimator": {
        "sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler",
            {"gordo_components_tpu.models.ConvAutoEncoder": {
                "lookback_window": 8, "channels": [4, 2], "epochs": 2, "batch_size": 16}}]}}}}
    machines = [{"name": f"conv-{i}", "dataset": dataset, "model": model} for i in range(2)]
    report = build_fleet(machines, str(tmp_path / "out"), device="cpu")
    assert sorted(report) == ["conv-0", "conv-1"] and not report.failed
    entries = [serializer.load_entry(report[n], name=n) for n in report]
    assert {(e.registry_type, e.lookback) for e in entries} == {("ConvAutoEncoder", 8)}
    bank = ModelBank.from_entries(entries, device="cpu")
    meta = serializer.load_metadata(report["conv-0"])
    assert meta["model"]["fleet_trained"] is True
    X = np.random.RandomState(0).rand(30, F).astype("f4")
    for n in report:
        want = serializer.load(report[n], device="cpu").anomaly(X)
        got = bank.score(n, X).to_arrays()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


def test_single_and_gang_builds_cross_validate_conv_models(tmp_path):
    """The single build's cross-validation (a bare ConvAutoEncoder detector,
    no scaler step: the single-build path) and the gang's (fold members of a
    conv gang) over 72 rows: 18-row folds, lookback 8 fits every one."""
    from gordo_components_torch.builder import build_model

    dataset = {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00Z",
               "train_end_date": "2020-01-01T12:00:00Z", "tag_list": ["a", "b", "c"]}
    evaluation = {"cross_validation": True, "n_splits": 3}
    arch = {"lookback_window": 8, "channels": [4, 2], "epochs": 2, "batch_size": 8}
    bare = {"gordo_components_torch.models.DiffBasedAnomalyDetector": {"base_estimator": {
        "gordo_components_torch.models.ConvAutoEncoder": arch}}}
    model, meta = build_model("single", bare, dict(dataset), evaluation_config=evaluation, device="cpu")
    assert meta["model"]["trained"] and model.offset == 7
    scaled = {"gordo_components_torch.models.DiffBasedAnomalyDetector": {"base_estimator": {
        "sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler", {"gordo_components_torch.models.ConvAutoEncoder": arch}]}}}}
    report = build_fleet([{"name": "gang", "dataset": dataset, "model": scaled, "evaluation": evaluation}],
                         str(tmp_path / "out"), device="cpu")
    gang = serializer.load_metadata(report["gang"])["model"]
    assert gang["fleet_trained"] and gang["fleet_stats"]["cv_fold_members"] == 3
    for cv in (meta["model"]["cross-validation"], gang["cross-validation"]):
        ev = cv["explained-variance"]["per-fold"]
        assert len(ev) == 3 and np.isfinite(ev).all()


def test_bank_refuses_a_module_it_does_not_serve(monkeypatch):
    from gordo_components_torch.models import register

    class Other(torch.nn.Module):
        pass

    monkeypatch.setitem(register.FACTORY_REGISTRY.setdefault("AutoEncoder", {}), "other",
                        lambda n_features, **kw: Other())
    entry = port_bank._BankEntry("x", "AutoEncoder", "other", {}, F, {}, *[np.ones(F, "f4")] * 4)
    with pytest.raises(TypeError, match="no bank bucket for a Other"):
        ModelBank.from_entries([entry], device="cpu")
    with pytest.raises(TypeError, match="no training stack for a Other"):
        train_core.make_stack(Other())


def test_every_registered_module_names_a_family_of_every_table():
    """The per-family tables (stacks, bank buckets, converters) hold the
    same families, and every factory builds a module of one of them."""
    from gordo_components_torch import convert
    from gordo_components_torch.models import register

    assert set(train_core._STACKS) == set(port_bank._BUCKETS) == set(convert._CONVERTERS)
    for registry_type, kinds in register.FACTORY_REGISTRY.items():
        for kind, factory in kinds.items():
            assert factory(3).family in train_core._STACKS, (registry_type, kind)
