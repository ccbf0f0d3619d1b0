"""The port's losses, scaler fits and train core against the JAX package's,
on the CPU.

Bands: losses, metrics and scaler fits within rtol=1e-6, atol=1e-7 (float32
reductions in another order); each optimizer's parameters and moments over
3 steps from the same gradients within rtol=1e-6, atol=1e-7 (the same
formulas, elementwise); one 3-batch epoch from the same parameters and
JAX's own permutation within rtol=1e-5, atol=1e-6 (matrix products and tanh
round differently in the last bits). The all-padding batch is held bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gordo_components_torch.convert import feedforward_from_flax
from gordo_components_torch.models import lookup_factory
from gordo_components_torch.models import train_core as port
from gordo_components_torch.ops import losses as plosses
from gordo_components_torch.ops import scaler as pscaler
from gordo_components_tpu.models import train_core as ref
from gordo_components_tpu.models.register import lookup_factory as jax_lookup
from gordo_components_tpu.ops import losses as jlosses
from gordo_components_tpu.ops import scaler as jscaler

TIGHT = dict(rtol=1e-6, atol=1e-7)
EPOCH = dict(rtol=1e-5, atol=1e-6)


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture
def data():
    rng = np.random.RandomState(0)
    return rng.rand(37, 5).astype("f4"), rng.rand(37, 5).astype("f4")


def test_mse_loss_masked_and_stacked(data):
    pred, target = data
    mask = (np.arange(37) < 30).astype("f4")
    np.testing.assert_allclose(
        plosses.mse_loss(t(pred), t(target), t(mask)).numpy(),
        jlosses.mse_loss(pred, target, mask), **TIGHT)
    np.testing.assert_allclose(plosses.mse_loss(t(pred), t(target)).numpy(),
                               jlosses.mse_loss(pred, target), **TIGHT)
    # a member axis: one loss per member, each the single-member loss
    stacked = plosses.mse_loss(t(np.stack([pred, target])), t(np.stack([target, pred])),
                               t(np.stack([mask, np.zeros_like(mask)])))
    np.testing.assert_allclose(stacked[0].numpy(), jlosses.mse_loss(pred, target, mask), **TIGHT)
    assert float(stacked[1]) == 0.0  # no real rows: 0, not NaN


@pytest.mark.parametrize("constant", [False, True])
def test_explained_variance_and_metrics(data, constant):
    y, p = data
    if constant:  # sklearn's 0/0 convention on a constant column
        y[:, 2] = 1.0
        p[:, 2] = 1.0
        p[:, 3] = y[:, 3] = 0.5
        p[0, 3] = 0.4
    np.testing.assert_allclose(float(plosses.explained_variance(t(y), t(p))),
                               float(jlosses.explained_variance(y, p)), **TIGHT)
    got, want = plosses.regression_metrics(t(y), t(p)), jlosses.regression_metrics(y, p)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TIGHT)


@pytest.mark.parametrize("fit", ["minmax", "standard"])
def test_scaler_fits_ignore_nan_rows(data, fit):
    X = data[0].copy()
    X[[3, 17, 30]] = np.nan
    X[:, 4] = 2.0  # a constant feature
    X[[3, 17, 30], 4] = np.nan
    got = getattr(pscaler, f"fit_{fit}")(t(X))
    want = getattr(jscaler, f"fit_{fit}")(jnp.asarray(X))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TIGHT)
    # stacked over a member axis: each member's own fit
    stacked = getattr(pscaler, f"fit_{fit}")(t(np.stack([X, data[1]])))
    np.testing.assert_allclose(stacked.shift[0].numpy(), got.shift.numpy(), **TIGHT)
    Xc = data[1]
    back = pscaler.scaler_inverse_transform(got, pscaler.scaler_transform(got, t(Xc)))
    np.testing.assert_allclose(back.numpy(), np.asarray(jscaler.scaler_inverse_transform(
        want, jscaler.scaler_transform(want, Xc))), **TIGHT)
    ident = pscaler.identity_scaler(5)
    assert torch.equal(pscaler.scaler_transform(ident, t(Xc)), t(Xc))


def test_pad_to_batches_matches(data):
    X, Y = data
    for got, want in zip(port.pad_to_batches(X, Y, 16), ref.pad_to_batches(X, Y, 16)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="empty"):
        port.pad_to_batches(X[:0], Y[:0], 16)


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "rmsprop", "adagrad"])
def test_optimizer_three_steps_match_optax(name):
    rng = np.random.RandomState(1)
    params = rng.randn(2, 9).astype("f4")
    grads = [rng.randn(2, 9).astype("f4") for _ in range(3)]
    lr = 3e-2
    tx = ref.make_optimizer(name, lr)
    jp, js = jnp.asarray(params), tx.init(jnp.asarray(params))
    opt = port.make_optimizer(name, lr)
    pp, ps = t(params), opt.init(t(params))
    for g in grads:
        upd, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        pp, ps = opt.update(t(g), ps, pp, torch.full((2,), lr), torch.ones(2, dtype=torch.bool))
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), **TIGHT)
    moments = {"adam": ("mu", "nu"), "adamw": ("mu", "nu"), "rmsprop": ("nu",),
               "adagrad": ("sum_of_squares",), "sgd": ()}[name]
    jstate = js[0]
    for jname in moments:
        mine = ps.nu if jname in ("nu", "sum_of_squares") else ps.mu
        np.testing.assert_allclose(mine.numpy(), np.asarray(getattr(jstate, jname)), **TIGHT)
    assert ps.count.tolist() == [3, 3]


def test_optimizer_per_member_lr_and_count():
    opt = port.make_optimizer("adam", 1e-3)
    p = torch.zeros(3, 4)
    s = opt.init(p)
    g = torch.ones(3, 4)
    p2, s2 = opt.update(g, s, p, torch.tensor([1e-3, 0.0, 1e-2]), torch.tensor([True, True, False]))
    assert torch.equal(p2[1], p[1])  # learning rate 0
    assert torch.equal(p2[2], p[2]) and torch.equal(s2.mu[2], s.mu[2])  # skipped
    assert s2.count.tolist() == [1, 1, 0]
    assert not torch.equal(p2[0], p[0])
    with pytest.raises(ValueError, match="Unknown optimizer"):
        port.make_optimizer("lion")
    with pytest.raises(TypeError, match="momentum"):
        port.make_optimizer("sgd", momentum=0.9)


def _modules(n_features=5):
    kw = dict(dims=(4, 3))
    return (jax_lookup("AutoEncoder", "feedforward_symmetric")(n_features, **kw),
            lookup_factory("AutoEncoder", "feedforward_symmetric")(n_features, **kw))


def test_stacked_forward_matches_module_and_round_trips():
    _, module = _modules()
    stack = port.StackedDense(module)
    flat = stack.init([port.member_generator(0, i) for i in range(3)])
    states = stack.state_dicts(flat)
    assert torch.equal(stack.from_state_dicts(states), flat)
    x = torch.rand(3, 7, 5)
    out = stack.forward(flat, x)
    for m in range(3):
        module.load_state_dict({k: torch.as_tensor(v) for k, v in states[m].items()})
        np.testing.assert_allclose(out[m].detach().numpy(), module(x[m]).detach().numpy(), **EPOCH)
    assert all(np.all(states[m][f"layers.{i}.bias"] == 0) for m in range(3) for i in range(3))
    with pytest.raises(ValueError, match="layers.0.kernel"):
        stack.from_state_dicts([{**states[0], "layers.0.weight": np.zeros((5, 5), "f4")}])


def test_member_init_independent_of_gang_width():
    _, module = _modules()
    stack = port.StackedDense(module)
    wide = stack.init([port.member_generator(3, i) for i in range(8)])
    narrow = stack.init([port.member_generator(3, i) for i in range(2)])
    assert torch.equal(wide[:2], narrow)
    assert not torch.equal(wide[0], wide[1])
    # lecun_normal: truncated at two standard deviations of sqrt(1 / fan_in)
    W = stack.split(stack.init([port.member_generator(0, i) for i in range(64)]))[0][0]
    assert float(W.abs().max()) <= 2 * (1 / 5) ** 0.5 / port._TRUNC_STD + 1e-6
    assert abs(float(W.std()) - (1 / 5) ** 0.5) < 0.05


def test_epoch_with_jax_permutation_matches():
    """Three batches (the last partly padding) from the same parameters
    and the permutation JAX's own epoch draws."""
    jmod, pmod = _modules()
    rng = np.random.RandomState(2)
    X = rng.rand(40, 5).astype("f4")
    bs = 16
    opt = ref.make_optimizer("adam", 1e-2)
    init_fn, epoch_fn = ref.make_train_fns(jmod, opt, bs)
    Xp, Yp, mask, n_batches = ref.pad_to_batches(X, X, bs)
    state = init_fn(jax.random.PRNGKey(4), jnp.asarray(Xp[0]))
    # the permutation make_train_fns' epoch draws (train_core.py:149-159)
    _, perm_rng, _ = jax.random.split(state.rng, 3)
    keys = jax.random.uniform(perm_rng, (Xp.shape[0],))
    perm = np.asarray(jnp.argsort(jnp.where(jnp.asarray(mask) > 0, keys, 2.0)))
    new_state, jloss = jax.jit(epoch_fn)(state, jnp.asarray(Xp), jnp.asarray(Yp), jnp.asarray(mask))

    stack = port.StackedDense(pmod)
    flat = stack.from_state_dicts([feedforward_from_flax(jax.tree.map(np.asarray, state.params))])
    p_init, p_epoch = port.make_train_fns(stack, port.make_optimizer("adam", 1e-2), bs)
    pstate = p_init([port.member_generator(0, 0)], torch.device("cpu"), params=flat)
    dev = [t(a)[None] for a in (Xp, Yp, mask)]
    pstate, ploss = p_epoch(pstate, *dev, torch.full((1,), 1e-2), perm=torch.from_numpy(perm.astype(np.int64))[None])
    np.testing.assert_allclose(float(ploss[0]), float(jloss), **EPOCH)
    want = feedforward_from_flax(jax.tree.map(np.asarray, new_state.params))
    got = stack.state_dicts(pstate.params)[0]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **EPOCH)
    assert pstate.opt_state.count.tolist() == [n_batches]


def test_all_padding_batch_is_an_exact_noop():
    _, module = _modules()
    stack = port.StackedDense(module)
    opt = port.make_optimizer("adam", 1e-2)
    step = port.make_step_fn(stack, opt)
    params = stack.init([port.member_generator(0, i) for i in range(2)])
    state = opt.init(params)
    x = torch.rand(2, 8, 5)
    mb = torch.ones(2, 8)
    params, state, _, _ = step(params, state, x, x, mb, torch.full((2,), 1e-2))
    mb[1] = 0.0  # member 1's batch is all padding
    p2, s2, losses, counts = step(params, state, x, x, mb, torch.full((2,), 1e-2))
    assert torch.equal(p2[1], params[1])
    assert torch.equal(s2.mu[1], state.mu[1]) and torch.equal(s2.nu[1], state.nu[1])
    assert s2.count.tolist() == [2, 1]
    assert not torch.equal(p2[0], params[0])
    assert counts.tolist() == [8.0, 0.0] and float(losses[1]) == 0.0


def test_shuffle_keeps_padding_last_and_ignores_padding_amount():
    gens = [port.member_generator(0, i) for i in range(2)]
    a = port.shuffle_perm(gens, [5, 3], 8, torch.device("cpu"))
    gens = [port.member_generator(0, i) for i in range(2)]
    b = port.shuffle_perm(gens, [5, 3], 16, torch.device("cpu"))
    assert torch.equal(a, b[:, :8]) and b[:, 8:].tolist() == [list(range(8, 16))] * 2
    assert sorted(a[0, :5].tolist()) == list(range(5)) and a[0, 5:].tolist() == [5, 6, 7]
    assert sorted(a[1, :3].tolist()) == [0, 1, 2]


def test_eval_and_vae_loss():
    _, module = _modules()
    stack = port.StackedDense(module)
    flat = stack.init([port.member_generator(0, 0)])
    X = torch.rand(1, 32, 5)
    mask = (torch.arange(32) < 20).float()[None]
    got = port.make_eval_fn(stack, 8)(flat, X, X, mask)
    want = plosses.mse_loss(stack.forward(flat, X[:, :20]), X[:, :20])
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), **TIGHT)
    # the ELBO needs a variational model; other loss names do not exist
    with pytest.raises(ValueError, match="variational"):
        port.make_loss_fn(stack, "vae")
    with pytest.raises(ValueError, match="known: mse, vae"):
        port.make_loss_fn(stack, "huber")
