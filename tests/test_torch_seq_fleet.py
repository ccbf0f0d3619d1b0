"""The port's sequence FleetTrainer against the JAX package's, and its own
invariants, on the CPU.

Parity is held from the same initial parameters with a batch at least as
long as every member's items, so each epoch is one step over all real
windows and the shuffle cannot matter (the method of test_torch_fleet.py).
The JAX FleetTrainer fits once a model type; its thresholds at the other
quantile come from the JAX package's own sequence error pass over the
members it trained.
Band after 3 Adam steps: rtol=1e-4, atol=1e-5 for parameters, losses,
input and error scalers and q = 1 thresholds. Thresholds below q = 1 come
from 8192-bin histograms on both sides: within 2/8192 per feature and
2*sqrt(F)/8192 for the total (the JAX suite's band against the exact
quantile, tests/test_fleet_seq.py:407-414). ``_hist_quantile`` on the same
int32 histograms within rtol=1e-6; chunked error passes bitwise equal to
unchunked ones; row and member quantization bitwise no-ops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_components_torch.convert import lstm_from_flax, lstm_to_flax
from gordo_components_torch.models import lookup_factory, train_core
from gordo_components_torch.parallel import FleetTrainer
from gordo_components_torch.parallel import fleet as port_fleet
from gordo_components_torch.server import ModelBank
from gordo_components_tpu.models.register import lookup_factory as jax_lookup_factory
from gordo_components_tpu.parallel import FleetTrainer as JaxFleetTrainer
from gordo_components_tpu.parallel import fleet as jax_fleet

BAND = dict(rtol=1e-4, atol=1e-5)
BINS = 8192
ARCH = dict(kind="lstm_symmetric", dims=(4,), lookback_window=5)


def _members(n, rows, features=3, seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for i in range(n):
        r = rows[i] if isinstance(rows, list) else rows
        t = np.arange(r)[:, None]
        X = np.sin(0.05 * (i + 1) * t * np.arange(1, features + 1)) + 0.05 * rng.randn(r, features)
        out[f"m{i}"] = X.astype("f4")
    return out


def _initial(members, model_type, features=3):
    module = lookup_factory(model_type, ARCH["kind"])(features, dims=ARCH["dims"])
    stack = train_core.StackedLSTM(module, ARCH["lookback_window"])
    states = stack.state_dicts(stack.init([train_core.member_generator(11, i) for i in range(len(members))]))
    return dict(zip(members, states))


def test_hist_quantile_matches_jax():
    rng = np.random.RandomState(0)
    hist = rng.randint(0, 50, size=(4, 257)).astype(np.int32)
    hist[1, :200] = 0  # mass at the top only
    hist[2] = 0
    hist[2, 17] = 9  # one bin
    n = hist.sum(-1).astype(np.float32)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        want = [float(jax_fleet._hist_quantile(jnp.asarray(h), 1.0 / 257, q, jnp.float32(k)))
                for h, k in zip(hist, n)]
        got = port_fleet._hist_quantile(torch.from_numpy(hist), 1.0 / 257, q, torch.from_numpy(n))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, err_msg=f"q={q}")


PARITY_BATCH = 64  # at least every member's items: one batch an epoch


def _parity_config(model_type):
    return dict(model_type=model_type, epochs=3, batch_size=PARITY_BATCH, learning_rate=1e-2, **ARCH)


@pytest.fixture(scope="module")
def jax_fleet_fit():
    """model_type -> (members, initial params, JAX FleetTrainer's members at
    q = 1): one JAX fit a model type, shared by both quantiles, since the
    training does not depend on q."""
    fits = {}

    def fit(model_type):
        if model_type not in fits:
            members = _members(6, [56 - 3 * i for i in range(6)])
            initial = _initial(members, model_type)
            out = JaxFleetTrainer(**_parity_config(model_type)).fit(
                members, initial_params={n: lstm_to_flax(sd) for n, sd in initial.items()})
            fits[model_type] = members, initial, out
        return fits[model_type]

    return fit


def _jax_error_pass(model_type, members, jax_out, q):
    """The JAX package's sequence error pass (``_make_seq_error_scalers``,
    which its FleetTrainer runs at ``threshold_quantile=q``) over the
    JAX-trained members and their fitted input scalers: (error scalers,
    feature thresholds, total thresholds), stacked over members."""
    module = jax_lookup_factory(model_type, ARCH["kind"])(3, dims=ARCH["dims"])
    lookback, offset = ARCH["lookback_window"], jax_fleet._target_offset_for(model_type)
    warmup = lookback - 1 + offset
    X = np.zeros((len(members), PARITY_BATCH + warmup, 3), np.float32)
    mask = np.zeros((len(members), PARITY_BATCH), np.float32)
    for i, (name, rows) in enumerate(members.items()):
        scaler = jax_fleet.ScalerParams(*jax_out[name].scaler)
        X[i, :len(rows)] = jax_fleet.scaler_transform(scaler, jnp.asarray(rows))
        mask[i, :len(rows) - warmup] = 1.0
    params = jax.tree.map(lambda *a: jnp.stack(a), *(jax_out[n].params for n in members))
    run = jax_fleet._BucketPrograms._make_seq_error_scalers(module, PARITY_BATCH, lookback, offset, q=q)
    return jax.tree.map(np.asarray, run(params, jnp.asarray(X), jnp.asarray(mask)))


@pytest.mark.parametrize("q", [1.0, 0.9])
@pytest.mark.parametrize("model_type", ["LSTMAutoEncoder", "LSTMForecast"])
def test_fleet_matches_jax_from_the_same_initial_params(model_type, q, jax_fleet_fit):
    members, initial, jax_out = jax_fleet_fit(model_type)
    out = FleetTrainer(device="cpu", threshold_quantile=q, **_parity_config(model_type)).fit(
        members, initial_params=initial)
    # JAX's error pass at q over its own trained members; at q = 1 it gives
    # what its FleetTrainer returned (the same program on the same inputs,
    # compiled apart)
    es, feat, tot = _jax_error_pass(model_type, members, jax_out, q)
    if q >= 1.0:
        for i, want in enumerate(jax_out.values()):
            np.testing.assert_allclose(feat[i], want.feature_thresholds, rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(tot[i], want.total_threshold, rtol=1e-6, atol=1e-7)
            for a, b in zip((es.shift[i], es.scale[i]), want.error_scaler):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
    f = 3
    for i, (name, want) in enumerate(jax_out.items()):
        got = out[name]
        jparams = lstm_from_flax(want.params)
        for k in jparams:
            np.testing.assert_allclose(got.params[k], jparams[k], err_msg=k, **BAND)
        np.testing.assert_allclose(got.history["loss"], want.history["loss"], **BAND)
        for g, w in (*zip(got.scaler, want.scaler), *zip(got.error_scaler, (es.shift[i], es.scale[i]))):
            np.testing.assert_allclose(g, np.asarray(w), **BAND)
        if q >= 1.0:
            np.testing.assert_allclose(got.feature_thresholds, feat[i], **BAND)
            np.testing.assert_allclose(got.total_threshold, tot[i], **BAND)
            assert got.threshold_method == want.threshold_method
        else:
            np.testing.assert_allclose(got.feature_thresholds, feat[i], rtol=0, atol=2 / BINS)
            np.testing.assert_allclose(got.total_threshold, tot[i], rtol=0, atol=2 * np.sqrt(f) / BINS)
            # the label JAX's _BucketPrograms.threshold_method gives below q = 1
            assert got.threshold_method == f"histogram-{jax_fleet._QUANTILE_BINS}"
        assert got.lookback_window == want.lookback_window == ARCH["lookback_window"]
    assert out["m0"].threshold_method == ("exact" if q >= 1.0 else "histogram-8192")


def _fit(members, **kw):
    cfg = dict(model_type="LSTMAutoEncoder", epochs=2, batch_size=16, device="cpu", **ARCH)
    cfg.update(kw)
    trainer = FleetTrainer(**cfg)
    return trainer, trainer.fit(members)


def _same(a, b):
    for name in a:
        for k in a[name].params:
            np.testing.assert_array_equal(a[name].params[k], b[name].params[k])
        assert a[name].history == b[name].history
        np.testing.assert_array_equal(a[name].feature_thresholds, b[name].feature_thresholds)


def test_item_and_member_quantization_are_noops():
    # 60 rows, lookback 5: 56 items, 4 batches of 16 exact and on the ladder
    # at 16; at batch 12 5 batches exact, 6 on the ladder; 5 members: 5
    members = _members(5, 60, seed=3)
    exact_tr, exact = _fit(members, batch_size=12, quantize_rows=False)
    tr, quant = _fit(members, batch_size=12)
    assert exact_tr.last_stats["buckets"][0]["padded_items"] == 60
    assert tr.last_stats["buckets"][0]["padded_items"] == 72
    assert tr.last_stats["buckets"][0]["padded_rows"] == 76
    _same(exact, quant)
    first = {n: members[n] for n in ("m0", "m1")}
    _, alone = _fit(first, batch_size=12)
    _same(alone, quant)


def test_chunked_error_pass_matches_unchunked(monkeypatch):
    members = _members(5, 48, seed=4)
    _, whole = _fit(members, threshold_quantile=0.9)
    # two members a chunk
    monkeypatch.setattr(port_fleet, "_QUANTILE_CHUNK_BYTES", 2 * (3 + 1) * BINS * 4)
    _, chunked = _fit(members, threshold_quantile=0.9)
    for name in members:
        np.testing.assert_array_equal(whole[name].feature_thresholds, chunked[name].feature_thresholds)
        assert whole[name].total_threshold == chunked[name].total_threshold
        for a, b in zip(whole[name].error_scaler, chunked[name].error_scaler):
            np.testing.assert_array_equal(a, b)


def test_validation_split_early_stopping_and_warm_start():
    members = _members(3, [64, 64, 8], seed=6)
    tr, out = _fit(members, epochs=4, validation_split=0.2, host_sync_every=2)
    assert len(out["m0"].history["val_loss"]) == 4
    assert "val_loss" not in out["m2"].history  # int(4 * 0.2) == 0 held-out items
    # no epoch beats the first by min_delta: every member stops after epoch
    # 2 with patience 0, on epoch 1's parameters
    _, es = _fit(members, epochs=10, early_stopping_patience=0, early_stopping_min_delta=10.0)
    _, one = _fit(members, epochs=1)
    assert [len(es[n].history["loss"]) for n in members] == [2, 2, 2]
    for n in members:
        assert es[n].history["loss"][:1] == one[n].history["loss"]
        for k in one[n].params:
            np.testing.assert_array_equal(es[n].params[k], one[n].params[k])
    initial = _initial(members, "LSTMAutoEncoder")
    warm = FleetTrainer(model_type="LSTMAutoEncoder", epochs=1, batch_size=16, device="cpu",
                        **ARCH).fit(members, member_hparams={"m0": {"learning_rate": 0.0}},
                                    initial_params=initial)
    for k, v in initial["m0"].items():
        np.testing.assert_array_equal(warm["m0"].params[k], v)  # lr 0: the warm start
    with pytest.raises(ValueError, match="m1"):
        FleetTrainer(model_type="LSTMAutoEncoder", device="cpu", **ARCH).fit(
            members, initial_params={"m1": {**initial["m1"], "layers.0.Wh": np.zeros((2, 2), "f4")}})


def test_members_predict_and_serve_as_bank_entries():
    members = _members(3, 50, seed=7)
    _, out = _fit(members, model_type="LSTMForecast")
    bank = ModelBank.from_entries([m.to_entry() for m in out.values()], device="cpu")
    for name, X in members.items():
        m = out[name]
        det = m.to_estimator()
        entry = m.to_entry()
        assert (entry.registry_type, entry.lookback, entry.target_offset) == ("LSTMForecast", 5, 1)
        want = det.anomaly(X[:30])
        got = bank.score(name, X[:30]).to_arrays()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
        # the member's own predict: the detector's output, in input space
        pred = m.predict(X[:30])
        scale, shift = m.scaler.scale, m.scaler.shift
        np.testing.assert_allclose(pred, want["model-output"] / scale + shift, rtol=1e-5, atol=1e-5)
        assert pred.shape == (30 - 5, 3)
        # q = 1: no scaled training error above its threshold
        assert det.anomaly(X)["total-anomaly-scaled"].max() <= m.total_threshold + 1e-6


def test_family_defaults_and_short_members():
    tr = FleetTrainer(model_type="LSTMForecast", device="cpu")
    assert (tr.kind, tr.lookback_window) == ("lstm_hourglass", 10)
    assert (FleetTrainer(device="cpu").kind, FleetTrainer(device="cpu").lookback_window) == (
        "feedforward_hourglass", 1)
    with pytest.raises(ValueError, match="lookback_window\\+offset=6"):
        FleetTrainer(model_type="LSTMForecast", lookback_window=5, device="cpu").fit(
            {"short": np.zeros((5, 3), "f4")})
