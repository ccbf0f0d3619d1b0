"""The port's sequence training core and estimators against the JAX
package's, on the CPU.

Bands, as the JAX suite states them for its own time-major gang epoch
against the per-member epoch (tests/test_seq_fastpath.py:251-263): an epoch
from the same parameters and JAX's own permutation holds the loss within
rtol=1e-5, atol=1e-7 and the parameters within rtol=1e-4, atol=1e-6. A
forward holds rtol=1e-5, atol=1e-6 against ``lstm_time_major_forward(...,
kernel="jnp")`` and ``vmap(module.apply)``; never bitwise (the [dims1]
caveat in ROADMAP.md C: products accumulate in another order). The window
gather, the parameter round trips and an all-padding batch are held
bitwise. The detector fitted over JAX's base parameters holds its error
scaler and thresholds within rtol=1e-4, atol=1e-5, the band chip_smoke.py
holds LSTM scores to between the card and the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.pipeline import Pipeline as SkPipeline
from sklearn.preprocessing import MinMaxScaler as SkMinMax

from gordo_components_torch.convert import lstm_from_flax, lstm_to_flax
from gordo_components_torch.models import (
    DiffBasedAnomalyDetector,
    LSTMAutoEncoder,
    LSTMForecast,
    lookup_factory,
    train_core,
)
from gordo_components_torch.models.transformers import MinMaxScaler, Pipeline
from gordo_components_torch.ops import seq_scan
from gordo_components_tpu.models import LSTMAutoEncoder as JaxLSTMAE
from gordo_components_tpu.models import LSTMForecast as JaxLSTMForecast
from gordo_components_tpu.models import DiffBasedAnomalyDetector as JaxDetector
from gordo_components_tpu.models import train_core as ref
from gordo_components_tpu.models.factories import lstm_model, lstm_symmetric
from gordo_components_tpu.ops.seq_scan import lstm_time_major_forward as jax_time_major

FORWARD = dict(rtol=1e-5, atol=1e-6)
LOSS = dict(rtol=1e-5, atol=1e-7)
PARAMS = dict(rtol=1e-4, atol=1e-6)
DETECTOR = dict(rtol=1e-4, atol=1e-5)
F, LB, BS = 3, 6, 8
CPU = torch.device("cpu")


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _port_stack(dims, lookback=LB, offset=0, f=F):
    module = lookup_factory("LSTMAutoEncoder", "lstm_model")(f, dims=dims)
    return train_core.StackedLSTM(module, lookback, offset)


def _members_of(params, M):
    """Per-member ``LSTMStack`` state dicts of a member-stacked Flax tree."""
    sd = lstm_from_flax(jax.tree.map(np.asarray, params))
    return [{k: v[m] for k, v in sd.items()} for m in range(M)]


def _flax_params(stack, M, seed=3):
    """M members drawn by the port's init, as a member-stacked Flax tree
    (quicker than compiling Flax's init; the same tree)."""
    flat = stack.init([train_core.member_generator(seed, i) for i in range(M)])
    return lstm_to_flax({k: v.numpy() for k, v in stack.pieces(flat).items()})


def _jax_states(module, opt, stack, M):
    """A member-stacked JAX ``TrainState`` over :func:`_flax_params`."""
    params = jax.tree.map(jnp.asarray, _flax_params(stack, M))
    return ref.TrainState(params, jax.vmap(opt.init)(params),
                          jax.random.split(jax.random.PRNGKey(11), M))


def _ragged_block(M, n_pad, lookback, offset, seed=0):
    """Rows (M, n_pad + warm-up, F) and item masks (M, n_pad) of M members
    with different real lengths, zero padding."""
    rng = np.random.RandomState(seed)
    rows_pad = n_pad + lookback - 1 + offset
    X = np.zeros((M, rows_pad, F), np.float32)
    mask = np.zeros((M, n_pad), np.float32)
    for m in range(M):
        r = rows_pad - 3 - 5 * m
        X[m, :r] = rng.rand(r, F)
        mask[m, : r - lookback + 1 - offset] = 1.0
    return X, mask


@pytest.mark.parametrize("offset", [0, 1])
def test_gather_window_batch_matches_jax(offset):
    rng = np.random.RandomState(1)
    X = rng.rand(2, 20, F).astype("f4")
    idx = np.array([[0, 3, 14, 19, 25], [7, 0, 15, 16, 40]])  # past the end: clipped
    xb, yb = train_core.gather_window_batch(t(X), torch.from_numpy(idx), LB, offset)
    for m in range(2):
        jx, jy = ref.gather_window_batch(jnp.asarray(X[m]), jnp.asarray(idx[m]), LB, offset)
        np.testing.assert_array_equal(xb[m].numpy(), np.asarray(jx))
        np.testing.assert_array_equal(yb[m].numpy(), np.asarray(jy))
    Y = rng.rand(2, 20, F).astype("f4")
    _, yb2 = train_core.gather_window_batch(t(X), torch.from_numpy(idx), LB, offset, Y=t(Y))
    np.testing.assert_array_equal(yb2[1].numpy(), np.asarray(ref.gather_window_batch(
        jnp.asarray(Y[1]), jnp.asarray(idx[1]), LB, offset)[1]))


@pytest.mark.parametrize("dims", [(5,), (4, 3)], ids=["1-layer", "2-layer"])
def test_train_forward_matches_jax(dims):
    M = 3
    module = lstm_model(F, dims=dims)
    stack = _port_stack(dims)
    params = _flax_params(stack, M)
    xb = np.random.RandomState(4).randn(M, 4, LB, F).astype("f4")
    flat = stack.from_state_dicts(_members_of(params, M))
    got = seq_scan.lstm_train_forward(stack.split(flat), t(xb), module.funcs, module.out_func).numpy()
    want_jnp = jax_time_major(module, params, jnp.asarray(xb), kernel="jnp")
    want_apply = jax.vmap(module.apply)(params, jnp.asarray(xb))
    for want, name in ((want_jnp, "time-major jnp"), (want_apply, "vmap(module.apply)")):
        np.testing.assert_allclose(got, np.asarray(want), err_msg=name, **FORWARD)
    # the stack's forward: autograd where the parameters want a gradient,
    # the kernel's path (here its plain version) under no_grad
    with torch.no_grad():
        scoring = stack.forward(flat, t(xb)).numpy()
    np.testing.assert_allclose(scoring, got, **FORWARD)
    # the gradient of the summed loss through both packages
    p = flat.clone().requires_grad_()
    y = np.random.RandomState(5).randn(M, 4, F).astype("f4")
    torch_loss = ((stack.forward(p, t(xb)) - t(y)) ** 2).mean(dim=(1, 2)).sum()
    (g,) = torch.autograd.grad(torch_loss, p)
    jg = jax.grad(lambda q: jnp.sum(jnp.mean(
        (jax_time_major(module, q, jnp.asarray(xb), kernel="jnp") - y) ** 2, axis=(1, 2))))(params)
    want = _members_of(jg, M)
    for m, sd in enumerate(stack.state_dicts(g)):
        for k in sd:
            np.testing.assert_allclose(sd[k], want[m][k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_stacked_lstm_round_trips_and_flax_layout():
    module = lstm_symmetric(F, dims=(5, 4))  # four layers
    stack = _port_stack(module.dims)
    flat = stack.init([train_core.member_generator(0, i) for i in range(3)])
    states = stack.state_dicts(flat)
    assert torch.equal(stack.from_state_dicts(states), flat)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, LB, F)))
    tree = lstm_to_flax(states[1])
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(shapes)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(shapes)):
        assert a.shape == b.shape
    back = lstm_from_flax(tree)
    for k, v in states[1].items():
        np.testing.assert_array_equal(back[k], v)
    # split views are the seq_scan weights of the same tree
    layers, (Wd, bd) = stack.split(flat)
    want_layers, (want_d, _) = seq_scan.extract_lstm_weights(lstm_to_flax(states[2]))
    for (Wi, Wh, b), (wWi, wWh, wb) in zip(layers, want_layers):
        assert torch.equal(Wi[2], wWi) and torch.equal(Wh[2], wWh) and torch.equal(b[2], wb)
    assert torch.equal(Wd[2], want_d)
    # the stack's scoring forward is LSTMStack's with the member's state dict
    pmod = lookup_factory("LSTMAutoEncoder", "lstm_model")(F, dims=module.dims)
    pmod.load_state_dict({k: torch.from_numpy(v) for k, v in states[1].items()})
    W = torch.rand(7, LB, F)
    with torch.no_grad():
        np.testing.assert_allclose(stack.forward(flat[1:2], W[None])[0].numpy(), pmod(W).numpy(),
                                   **FORWARD)
    with pytest.raises(ValueError, match="layers.0.Wh"):
        stack.from_state_dicts([{**states[0], "layers.0.Wh": np.zeros((5, 5), "f4")}])


def test_init_draws_flax_defaults_independent_of_gang_width():
    stack = _port_stack((8, 5), f=10)
    wide = stack.init([train_core.member_generator(3, i) for i in range(6)])
    narrow = stack.init([train_core.member_generator(3, i) for i in range(2)])
    assert torch.equal(wide[:2], narrow) and not torch.equal(wide[0], wide[1])
    flat = stack.init([train_core.member_generator(0, i) for i in range(64)])
    layers, (Wd, bd) = stack.split(flat)
    for (Wi, Wh, b), H, fan_in in zip(layers, (8, 5), (10, 8)):
        assert torch.all(b == 0)
        for k in range(4):  # hidden kernels: orthogonal, gate by gate
            q = Wh[:, :, k * H:(k + 1) * H]
            eye = torch.eye(H).expand_as(q)
            assert torch.allclose(q.transpose(1, 2) @ q, eye, atol=1e-5)
        # input kernels: lecun_normal, variance 1 / fan_in, truncated at 2 std
        assert abs(float(Wi.var()) * fan_in - 1.0) < 0.1
        assert float(Wi.abs().max()) <= 2 * (1 / fan_in) ** 0.5 / train_core._TRUNC_STD + 1e-6
    assert abs(float(Wd.var()) * 5 - 1.0) < 0.15 and torch.all(bd == 0)


def _jax_perm(rng_key, mask):
    """The permutation make_seq_train_fns' epoch draws from ``rng_key``
    (train_core.py:249-254, :321-327)."""
    _, perm_rng, _ = jax.random.split(rng_key, 3)
    keys = jax.random.uniform(perm_rng, (mask.shape[-1],))
    return np.asarray(jnp.argsort(jnp.where(jnp.asarray(mask) > 0, keys, 2.0)))


def _port_epoch(stack, params_flat, X, mask, perm, lr=1e-2):
    M = X.shape[0]
    init_fn, epoch_fn = train_core.make_train_fns(stack, train_core.make_optimizer("adam", lr), BS)
    state = init_fn([train_core.member_generator(0, i) for i in range(M)], CPU, params=params_flat)
    return epoch_fn(state, t(X), t(X), t(mask), torch.full((M,), lr),
                    perm=torch.from_numpy(perm.astype(np.int64)))


@pytest.mark.parametrize("offset", [0, 1])
def test_epoch_matches_jax_gang_epoch(offset):
    """M = 3 members of ragged lengths, 5 batches (the last ones partly and
    wholly padding for the shorter members), JAX's own permutations."""
    M, n_pad, dims = 3, 40, (5,)
    X, mask = _ragged_block(M, n_pad, LB, offset)
    module = lstm_model(F, dims=dims)
    opt = ref.make_optimizer("adam", 1e-2)
    stack = _port_stack(dims, offset=offset)
    states = _jax_states(module, opt, stack, M)
    perms = np.stack([_jax_perm(states.rng[m], mask[m]) for m in range(M)])
    gang = ref.make_seq_gang_epoch(module, opt, BS, LB, offset)
    jstates, jloss = jax.jit(gang)(states, jnp.asarray(X), jnp.asarray(mask))

    pstate, ploss = _port_epoch(stack, stack.from_state_dicts(_members_of(states.params, M)), X, mask, perms)
    np.testing.assert_allclose(ploss.numpy(), np.asarray(jloss), **LOSS)
    want = _members_of(jstates.params, M)
    for m, got in enumerate(stack.state_dicts(pstate.params)):
        for k in got:
            np.testing.assert_allclose(got[k], want[m][k], err_msg=f"member {m} {k}", **PARAMS)
    # per-member step counts: the members' real batches only
    assert pstate.opt_state.count.tolist() == [int(-(-mask[m].sum() // BS)) for m in range(M)]


@pytest.mark.parametrize("offset", [0, 1])
def test_epoch_matches_jax_single_member_epoch(offset):
    n_pad, dims = 24, (4, 3)
    X, mask = _ragged_block(1, n_pad, LB, offset, seed=2)
    module = lstm_model(F, dims=dims)
    opt = ref.make_optimizer("adam", 1e-2)
    _, s_epoch = ref.make_seq_train_fns(module, opt, BS, LB, offset)
    stack = _port_stack(dims, offset=offset)
    state = jax.tree.map(lambda a: a[0], _jax_states(module, opt, stack, 1))
    perm = _jax_perm(state.rng, mask[0])[None]
    jstate, jloss = jax.jit(s_epoch)(state, jnp.asarray(X[0]), None, jnp.asarray(mask[0]))

    flat = stack.from_state_dicts([lstm_from_flax(jax.tree.map(np.asarray, state.params))])
    pstate, ploss = _port_epoch(stack, flat, X, mask, perm)
    np.testing.assert_allclose(float(ploss[0]), float(jloss), **LOSS)
    want = lstm_from_flax(jax.tree.map(np.asarray, jstate.params))
    got = stack.state_dicts(pstate.params)[0]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **PARAMS)


def test_all_padding_batch_is_an_exact_noop():
    stack = _port_stack((5,))
    opt = train_core.make_optimizer("adam", 1e-2)
    step = train_core.make_step_fn(stack, opt)
    params = stack.init([train_core.member_generator(0, i) for i in range(2)])
    state = opt.init(params)
    xb, yb = torch.rand(2, 4, LB, F), torch.rand(2, 4, F)
    mb = torch.ones(2, 4)
    params, state, _, _ = step(params, state, xb, yb, mb, torch.full((2,), 1e-2))
    mb[1] = 0.0
    p2, s2, losses, counts = step(params, state, xb, yb, mb, torch.full((2,), 1e-2))
    assert torch.equal(p2[1], params[1])
    assert torch.equal(s2.mu[1], state.mu[1]) and torch.equal(s2.nu[1], state.nu[1])
    assert s2.count.tolist() == [2, 1] and not torch.equal(p2[0], params[0])
    assert counts.tolist() == [4.0, 0.0] and float(losses[1]) == 0.0


@pytest.mark.parametrize("offset", [0, 1])
def test_seq_eval_matches_jax(offset):
    M, n_pad, dims = 2, 24, (5,)
    X, mask = _ragged_block(M, n_pad, LB, offset, seed=3)
    module = lstm_model(F, dims=dims)
    stack = _port_stack(dims, offset=offset)
    params = _flax_params(stack, M)
    want = jax.vmap(ref.make_seq_eval_fn(module, BS, LB, offset))(params, jnp.asarray(X), jnp.asarray(mask))
    flat = stack.from_state_dicts(_members_of(params, M))
    got = train_core.make_eval_fn(stack, BS)(flat, t(X), t(X), t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FORWARD)


@pytest.fixture(scope="module")
def frame():
    rng = np.random.RandomState(0)
    tt = np.arange(64)[:, None]
    X = np.sin(0.07 * tt * np.arange(1, 4)) + 0.05 * rng.randn(64, 3)
    return pd.DataFrame(X.astype("f4"), columns=[f"tag-{i}" for i in range(3)])


_ARCH = dict(kind="lstm_symmetric", dims=(4,), lookback_window=LB)


@pytest.fixture(scope="module")
def jax_estimators(frame):
    """One fitted JAX estimator a class, over the min-max scaled frame."""
    Xs = SkMinMax().fit_transform(frame.values).astype("f4")
    return {jcls: jcls(epochs=1, batch_size=16, **_ARCH).fit(Xs)
            for jcls in (JaxLSTMAE, JaxLSTMForecast)}


@pytest.mark.parametrize("q", [1.0, 0.9])
@pytest.mark.parametrize("cls, jcls", [(LSTMAutoEncoder, JaxLSTMAE), (LSTMForecast, JaxLSTMForecast)],
                         ids=["autoencoder", "forecast"])
def test_detector_fit_matches_jax_given_the_same_base_params(frame, jax_estimators, cls, jcls, q):
    jax_est = jax_estimators[jcls]
    jax_est.fit = lambda X, y=None: jax_est  # both detectors fit over the same base params
    jax_det = JaxDetector(base_estimator=SkPipeline([("s", SkMinMax()), ("m", jax_est)]),
                          threshold_quantile=q).fit(frame)
    est = cls(device="cpu", **_ARCH)
    est.params_ = lstm_from_flax(jax.tree.map(np.asarray, jax_est.params_))
    est.n_features_ = 3
    est.fit = lambda X, y=None: est
    det = DiffBasedAnomalyDetector(base_estimator=Pipeline([("s", MinMaxScaler()), ("m", est)]),
                                   threshold_quantile=q).fit(frame)
    for got, want in zip(det.error_scaler_, jax_det.error_scaler_):
        np.testing.assert_allclose(got, want, **DETECTOR)
    np.testing.assert_allclose(det.feature_thresholds_, jax_det.feature_thresholds_, **DETECTOR)
    np.testing.assert_allclose(det.total_threshold_, jax_det.total_threshold_, **DETECTOR)
    assert det.threshold_method_ == "exact" and det.offset == LB - 1 + cls._target_offset
    ours, theirs = det.anomaly(frame), jax_det.anomaly(frame)
    np.testing.assert_allclose(ours["total-anomaly-scaled"],
                               theirs[("total-anomaly-scaled", "")].values, **DETECTOR)
    # the estimator's own predict and score against JAX's on the same params
    Xs = SkMinMax().fit_transform(frame.values).astype("f4")
    np.testing.assert_allclose(est.predict(Xs), jax_est.predict(Xs), **FORWARD)
    np.testing.assert_allclose(est.score(Xs), jax_est.score(Xs), rtol=1e-4, atol=1e-5)
    entry = det.to_entry("lstm")
    assert (entry.registry_type, entry.lookback, entry.target_offset) == (
        cls.__name__, LB, cls._target_offset)


@pytest.mark.parametrize("cls, jcls", [(LSTMAutoEncoder, JaxLSTMAE), (LSTMForecast, JaxLSTMForecast)],
                         ids=["autoencoder", "forecast"])
def test_estimator_fit_history_early_stopping_and_errors(frame, cls, jcls):
    arch = dict(kind="lstm_hourglass", lookback_window=LB, batch_size=16, device="cpu")
    est = cls(epochs=4, **arch).fit(frame)
    loss = est.history["loss"]
    assert len(loss) == 4 and loss[-1] < loss[0]
    n_items = len(frame) - (LB - 1 + cls._target_offset)
    assert est.predict(frame).shape == (n_items, 3)
    assert est.get_metadata()["parameter_count"] == sum(v.size for v in est.params_.values())
    # validation split and early stopping with a min_delta no epoch beats:
    # stop after the second epoch on the first epoch's parameters
    es = cls(epochs=20, validation_split=0.2, early_stopping_patience=1,
             early_stopping_min_delta=10.0, **arch).fit(frame)
    assert len(es.history["loss"]) == 2 and len(es.history["val_loss"]) == 2
    one = cls(epochs=1, validation_split=0.2, **arch).fit(frame)
    for k in one.params_:
        np.testing.assert_array_equal(es.params_[k], one.params_[k])
    short = frame.values[: LB - 1 + cls._target_offset]
    with pytest.raises(ValueError) as ours:
        cls(**arch).fit(short)
    with pytest.raises(ValueError) as theirs:
        jcls(kind="lstm_hourglass", lookback_window=LB).fit(short)
    assert str(ours.value) == str(theirs.value)
