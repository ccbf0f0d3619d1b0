"""The port's FleetTrainer against the JAX package's, and its own
invariants, on the CPU.

Parity is held from the same initial parameters with a batch at least as
long as every member's rows, so each epoch is one step over all real rows
and the shuffle cannot matter. Band after 3 Adam steps: rtol=1e-4,
atol=1e-5 for parameters, losses, input and error scalers and thresholds
(matrix products, tanh and the loss reduction round differently in the
last bits; chip_smoke.py holds the card to the CPU with the same band).
Within the port, quantization, per-member learning rates and the early-
stopping freeze are held bitwise.
"""

import numpy as np
import pytest
import torch

from gordo_components_torch.convert import feedforward_from_flax, feedforward_to_flax
from gordo_components_torch.models import lookup_factory, train_core
from gordo_components_torch.parallel import FleetTrainer, quantize_batch_count, quantize_member_count
from gordo_components_torch.server import ModelBank
from gordo_components_tpu.parallel import FleetTrainer as JaxFleetTrainer
from gordo_components_tpu.parallel.fleet import quantize_batch_count as jax_qb
from gordo_components_tpu.parallel.fleet import quantize_member_count as jax_qm

BAND = dict(rtol=1e-4, atol=1e-5)
ARCH = dict(kind="feedforward_symmetric", dims=(3,))


def _members(n, rows, features=4, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(max(rows) if isinstance(rows, list) else rows)[:, None]
    out = {}
    for i in range(n):
        r = rows[i] if isinstance(rows, list) else rows
        X = np.sin(0.02 * (i + 1) * t[:r] * np.arange(1, features + 1)) + 0.05 * rng.randn(r, features)
        out[f"m{i}"] = X.astype("f4")
    return out


def _initial(members, features=4):
    stack = train_core.StackedDense(lookup_factory("AutoEncoder", ARCH["kind"])(features, dims=ARCH["dims"]))
    states = stack.state_dicts(stack.init([train_core.member_generator(11, i) for i in range(len(members))]))
    return dict(zip(members, states))


def test_ladders_match_jax():
    for n in range(1, 20001):
        assert quantize_batch_count(n) == jax_qb(n), n
        assert quantize_member_count(n) == jax_qm(n), n


@pytest.mark.parametrize("q, scaler", [(1.0, "minmax"), (0.8, "standard")])
def test_fleet_matches_jax_from_the_same_initial_params(q, scaler):
    members = _members(8, [120 - 3 * i for i in range(8)])
    initial = _initial(members)
    common = dict(epochs=3, batch_size=128, learning_rate=1e-2, input_scaler=scaler,
                  threshold_quantile=q, **ARCH)
    jax_out = JaxFleetTrainer(**common).fit(
        members, initial_params={n: feedforward_to_flax(sd) for n, sd in initial.items()})
    out = FleetTrainer(device="cpu", **common).fit(members, initial_params=initial)
    for name, want in jax_out.items():
        got = out[name]
        jparams = feedforward_from_flax(want.params)
        for k in jparams:
            np.testing.assert_allclose(got.params[k], jparams[k], **BAND)
        np.testing.assert_allclose(got.history["loss"], want.history["loss"], **BAND)
        for g, w in (*zip(got.scaler, want.scaler), *zip(got.error_scaler, want.error_scaler)):
            np.testing.assert_allclose(g, np.asarray(w), **BAND)
        np.testing.assert_allclose(got.feature_thresholds, want.feature_thresholds, **BAND)
        np.testing.assert_allclose(got.total_threshold, want.total_threshold, **BAND)
        assert got.threshold_method == want.threshold_method == "exact"


def _fit(members, **kw):
    cfg = dict(epochs=3, batch_size=64, device="cpu", **ARCH)
    cfg.update(kw)
    trainer = FleetTrainer(**cfg)
    return trainer, trainer.fit(members)


def _same(a, b):
    for name in a:
        for k in a[name].params:
            np.testing.assert_array_equal(a[name].params[k], b[name].params[k])
        assert a[name].history == b[name].history
        np.testing.assert_array_equal(a[name].feature_thresholds, b[name].feature_thresholds)


def test_row_and_member_quantization_are_noops():
    # 300 rows at batch 64: 5 batches exact, 6 on the ladder; 9 members: 10
    # on the ladder, while a gang of at most 4 is never padded
    members = _members(9, 300, seed=3)
    exact_tr, exact = _fit(members, quantize_rows=False)
    tr, quant = _fit(members)
    assert exact_tr.last_stats["buckets"][0]["padded_rows"] == 320
    assert tr.last_stats["buckets"][0]["padded_rows"] == 384
    assert tr.last_stats["buckets"][0]["padded_members"] == 10
    _same(exact, quant)
    first = {n: members[n] for n in ("m0", "m1", "m2", "m3")}
    alone_tr, alone = _fit(first)
    assert alone_tr.last_stats["buckets"][0]["padded_members"] == 4
    _same(alone, quant)


def test_per_member_learning_rate_and_warm_start():
    members = _members(3, 200, seed=4)
    initial = _initial(members)
    hp = {"m0": {"learning_rate": 0.0}, "m1": {"learning_rate": 1e-2}}
    out = FleetTrainer(epochs=2, batch_size=64, device="cpu", **ARCH).fit(
        members, member_hparams=hp, initial_params=initial)
    for k, v in initial["m0"].items():
        np.testing.assert_array_equal(out["m0"].params[k], v)  # lr 0: the warm start, unchanged
    uniform = FleetTrainer(epochs=2, batch_size=64, learning_rate=1e-2, device="cpu", **ARCH).fit(
        members, initial_params=initial)
    for k in uniform["m1"].params:
        np.testing.assert_array_equal(out["m1"].params[k], uniform["m1"].params[k])
    assert not np.array_equal(out["m2"].params["layers.0.weight"], uniform["m2"].params["layers.0.weight"])
    with pytest.raises(ValueError, match="m0"):
        FleetTrainer(device="cpu", **ARCH).fit(
            members, initial_params={"m0": {**initial["m0"], "layers.0.weight": np.zeros((2, 2), "f4")}})
    with pytest.raises(ValueError, match="unknown member"):
        FleetTrainer(device="cpu", **ARCH).fit(members, member_hparams={"ghost": {}})


def test_early_stopping_freezes_members_on_their_best_epoch():
    members = _members(3, 200, seed=5)
    # no epoch beats the first by min_delta: every member stops after
    # epoch 2 with patience 0 and keeps epoch 1's parameters; m0's own
    # patience of 2 keeps it one epoch longer (2 -> 1 -> 0)
    tr, out = _fit(members, epochs=10, early_stopping_patience=0, early_stopping_min_delta=10.0)
    assert [len(out[n].history["loss"]) for n in members] == [2, 2, 2]
    _, one = _fit(members, epochs=1)
    for n in members:
        for k in one[n].params:
            np.testing.assert_array_equal(out[n].params[k], one[n].params[k])
    out = FleetTrainer(epochs=10, batch_size=64, device="cpu", early_stopping_patience=0,
                       early_stopping_min_delta=10.0, **ARCH).fit(
        members, member_hparams={"m0": {"early_stopping_patience": 2}})
    assert [len(out[n].history["loss"]) for n in members] == [3, 2, 2]
    with pytest.raises(ValueError, match="ES disabled"):
        FleetTrainer(device="cpu", **ARCH).fit(members, member_hparams={"m0": {"early_stopping_patience": 1}})


def test_validation_split_and_host_sync():
    members = _members(3, [200, 200, 4], seed=6)
    tr = FleetTrainer(epochs=5, batch_size=64, validation_split=0.2, host_sync_every=2,
                      device="cpu", **ARCH)
    out = tr.fit(members)
    assert len(out["m0"].history["val_loss"]) == 5
    assert "val_loss" not in out["m2"].history  # int(4 * 0.2) == 0 held-out rows
    # the host reads epochs {0, 1}, {2, 3} and {4}, per bucket (the 4-row
    # member pads to another): a read's epochs share its wall time
    for bucket in tr.last_stats["buckets"]:
        t = bucket["epoch_seconds"]
        assert len(t) == 5 and t[0] == t[1] and t[2] == t[3]
    _, every = _fit(members, epochs=5, validation_split=0.2)
    _same(every, out)


def test_members_serve_as_bank_entries():
    members = _members(3, 150, seed=7)
    _, out = _fit(members, epochs=2)
    bank = ModelBank.from_entries([m.to_entry() for m in out.values()], device="cpu")
    for name, X in members.items():
        got = bank.score(name, X[:40]).to_arrays()
        want = out[name].to_estimator().anomaly(X[:40])
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
        # q = 1: no scaled training error above its threshold
        scored = out[name].to_estimator().anomaly(X)
        assert scored["total-anomaly-scaled"].max() <= out[name].total_threshold + 1e-6


def test_unported_fleet_features_raise(monkeypatch):
    # the conv family trains; float16 and loss names outside mse/vae do not
    with pytest.raises(NotImplementedError, match="'float32' or 'bfloat16'"):
        FleetTrainer(model_type="ConvAutoEncoder", compute_dtype="float16", device="cpu").fit(_members(1, 20))
    with pytest.raises(ValueError, match="known: mse, vae"):
        FleetTrainer(model_type="ConvAutoEncoder", loss="huber", device="cpu").fit(_members(1, 20))
    with pytest.raises(NotImplementedError, match="mesh"):
        FleetTrainer(mesh=object())
    with pytest.raises(NotImplementedError, match="'float32' or 'bfloat16'"):
        FleetTrainer(compute_dtype="float16", device="cpu", **ARCH).fit(_members(1, 10))
    # the member-width cap: five members at a cap of 2 train as 2 + 2 + 1
    monkeypatch.setenv("GORDO_FLEET_WIDTH", "2")
    trainer = FleetTrainer(epochs=1, batch_size=16, device="cpu", **ARCH)
    out = trainer.fit(_members(5, 20))
    assert sorted(out) == [f"m{i}" for i in range(5)] and trainer.last_stats["width_cap"] == 2
    assert [b["n_members"] for b in trainer.last_stats["buckets"]] == [2, 2, 1]
    monkeypatch.setenv("GORDO_FLEET_WIDTH", "0")
    with pytest.raises(ValueError, match="GORDO_FLEET_WIDTH must be >= 1"):
        FleetTrainer(device="cpu", **ARCH).fit(_members(1, 10))
    assert torch.get_default_dtype() == torch.float32
