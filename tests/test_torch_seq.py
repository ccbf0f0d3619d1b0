"""The port's LSTM path against the JAX package's, on the CPU.

On the CPU the fused-step wrappers run their plain versions, so this holds
the plain math (which the CUDA kernel is held to on the card, in
chip_smoke.py) to the JAX step ``lstm_step_jnp`` and to the Pallas kernel in
interpreter mode, and the whole time-major forward to JAX's time-major
forward (interpret kernel) and to ``vmap(module.apply)``.

Bands, as the JAX suite states them (tests/test_seq_fastpath.py): one step
within rtol=atol=1e-6; a forward of chained steps within rtol=1e-5,
atol=1e-6. Never bitwise: the matrix products accumulate in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_components_torch.convert import lstm_from_flax, lstm_to_flax
from gordo_components_torch.models import lookup_factory
from gordo_components_torch.ops import seq_scan as port
from gordo_components_torch.ops import windows as port_windows
from gordo_components_tpu.models.factories import lstm_hourglass, lstm_model
from gordo_components_tpu.ops import windows as jax_windows
from gordo_components_tpu.ops.seq_scan import (
    fused_lstm_step,
    lstm_step_jnp,
    lstm_time_major_forward,
)

STEP_TOL = dict(rtol=1e-6, atol=1e-6)
FORWARD_TOL = dict(rtol=1e-5, atol=1e-6)
# (B, M, H): lane-aligned H, and ragged H, B and M
STEP_SHAPES = [(8, 2, 128), (3, 2, 5), (4, 1, 37), (1, 7, 8)]


def _step_case(B, M, H, seed=0):
    rng = np.random.RandomState(seed)
    return (
        rng.randn(B, M, 4 * H).astype("float32"),
        rng.randn(B, M, H).astype("float32"),
        rng.randn(B, M, H).astype("float32"),
        (rng.randn(M, H, 4 * H) / np.sqrt(H)).astype("float32"),
        rng.randn(M, 4 * H).astype("float32"),
    )


def _random_params(f, dims, M=None, seed=0):
    """A Flax ``LSTMStack`` param tree of ``lstm_model(f, dims)``'s shapes
    (numpy, with a leading member axis of M when given), drawn from a seed:
    cheaper than ``module.init`` and the same tree."""
    rng = np.random.RandomState(seed)
    lead = () if M is None else (M,)
    sd = {
        k: (rng.randn(*lead, *v.shape) / np.sqrt(v.shape[0])).astype("float32")
        for k, v in lookup_factory("LSTMAutoEncoder", "lstm_model")(f, dims=dims)
        .state_dict().items()
    }
    return lstm_to_flax(sd)


def _stacked_module(M=3, f=3, dims=(5,), B=4, T=6, seed=0):
    """A JAX ``lstm_model`` stack, M members' params stacked on a leading
    axis (numpy), and a member-major (M, B, T, F) batch."""
    module = lstm_model(f, dims=dims)
    xb = np.random.RandomState(seed + 1).randn(M, B, T, f).astype("float32")
    return module, _random_params(f, dims, M, seed), xb


@pytest.mark.parametrize("B,M,H", STEP_SHAPES)
def test_step_plain_matches_jax_step(B, M, H):
    args = _step_case(B, M, H)
    want = lstm_step_jnp(*map(jnp.asarray, args))
    got = port.lstm_step_plain(*map(torch.from_numpy, args))
    for g, w, name in zip(got, want, ("c", "h")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **STEP_TOL)


@pytest.mark.parametrize("B,M,H", STEP_SHAPES)
def test_fused_step_on_cpu_matches_pallas_interpret(B, M, H):
    args = _step_case(B, M, H, seed=1)
    want = fused_lstm_step(*map(jnp.asarray, args), interpret=True)
    got = port.fused_lstm_step(*map(torch.from_numpy, args))
    for g, w, name in zip(got, want, ("c", "h")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **STEP_TOL)


def test_layer_plain_chains_the_step():
    S, B, M, H = 5, 3, 2, 6
    rng = np.random.RandomState(2)
    xz = torch.from_numpy(rng.randn(S, B, M, 4 * H).astype("float32"))
    Wh = torch.from_numpy((rng.randn(M, H, 4 * H) / np.sqrt(H)).astype("float32"))
    b = torch.from_numpy(rng.randn(M, 4 * H).astype("float32"))
    ys = port.lstm_layer(xz, Wh, b)
    h = c = torch.zeros(B, M, H)
    for t in range(S):
        c, h = port.fused_lstm_step(xz[t], h, c, Wh, b)
        torch.testing.assert_close(ys[t], h, rtol=0, atol=0)


def test_wrappers_refuse_other_devices():
    args = [torch.from_numpy(a).to("meta") for a in _step_case(2, 1, 4)]
    with pytest.raises(ValueError, match="unsupported device"):
        port.fused_lstm_step(*args)
    with pytest.raises(ValueError, match="unsupported device"):
        port.lstm_layer(args[0][None], args[3], args[4])


@pytest.mark.parametrize("n,lookback", [(10, 3), (32, 32), (5, 1), (128, 32)])
def test_sliding_windows_match_jax(n, lookback):
    X = np.random.RandomState(n).randn(n, 4).astype("float32")
    want = np.asarray(jax_windows.sliding_windows(jnp.asarray(X), lookback))
    got = port_windows.sliding_windows(torch.from_numpy(X), lookback)
    assert port_windows.num_windows(n, lookback) == jax_windows.num_windows(n, lookback)
    np.testing.assert_array_equal(got.numpy(), want)
    # a batch of series windows each series alike
    batched = port_windows.sliding_windows(torch.from_numpy(np.stack([X, 2 * X])), lookback)
    np.testing.assert_array_equal(batched[1].numpy(), 2 * want)


def test_flax_params_round_trip():
    # the tree Flax's init makes (traced, not run) is the tree the port reads
    module = lstm_model(3, dims=(5, 4))
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 4, 3)))
    params = _random_params(3, (5, 4))
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(shapes)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(shapes)):
        assert a.shape == b.shape
    sd = lstm_from_flax(params)
    assert sorted(sd)[:3] == ["head.bias", "head.kernel", "layers.0.Wh"]
    back = lstm_to_flax(sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_extracted_weights_have_gate_order_shapes():
    _, params, _ = _stacked_module(M=2, f=3, dims=(5, 5))
    layers, (Wd, bd) = port.extract_lstm_weights(params)
    assert len(layers) == 2
    (Wi0, Wh0, b0), (Wi1, Wh1, b1) = layers
    assert Wi0.shape == (2, 3, 20) and Wh0.shape == (2, 5, 20)
    assert Wi1.shape == (2, 5, 20) and Wh1.shape == (2, 5, 20)
    assert b0.shape == b1.shape == (2, 20)
    assert Wd.shape == (2, 5, 3) and bd.shape == (2, 3)
    # gate order i, f, g, o on the last axis: the f block is the hf kernel
    cell = params["params"]["OptimizedLSTMCell_0"]
    np.testing.assert_array_equal(Wh0[:, :, 5:10].numpy(), cell["hf"]["kernel"])
    np.testing.assert_array_equal(b0[:, 15:].numpy(), cell["ho"]["bias"])


@pytest.mark.parametrize("dims", [(5,), (6, 4)], ids=["1-layer", "2-layer"])
def test_time_major_forward_matches_jax(dims):
    module, params, xb = _stacked_module(M=3, dims=dims, B=3)
    got = port.lstm_time_major_forward(
        port.extract_lstm_weights(params), torch.from_numpy(xb), module.funcs, module.out_func
    ).numpy()
    kernel = lstm_time_major_forward(module, params, jnp.asarray(xb), kernel="interpret")
    apply = jax.vmap(lambda p, x: module.apply(p, x))(params, jnp.asarray(xb))
    for want, name in ((kernel, "interpret kernel"), (apply, "vmap(module.apply)")):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, np.asarray(want), err_msg=name, **FORWARD_TOL)


@pytest.mark.parametrize("kind", ["lstm_symmetric", "lstm_model"])
def test_lstm_stack_matches_flax_module(kind):
    """One member through the port's ``LSTMStack`` (registry lookup, state
    dict from the Flax tree) against the Flax module's own apply."""
    F, lookback = 6, 7
    from gordo_components_tpu.models.register import lookup_factory as jax_lookup

    kw = {"lstm_model": {"dims": (5, 3)}, "lstm_symmetric": {"dims": (4,)}}[kind]
    jmod = jax_lookup("LSTMForecast", kind)(F, **kw)
    params = _random_params(F, jmod.dims, seed=3)
    pmod = lookup_factory("LSTMForecast", kind)(F, **kw)
    assert (pmod.dims, pmod.funcs, pmod.out_func) == (jmod.dims, jmod.funcs, jmod.out_func)
    pmod.load_state_dict({k: torch.from_numpy(v) for k, v in lstm_from_flax(params).items()})
    W = np.random.RandomState(4).rand(9, lookback, F).astype("float32")
    with torch.no_grad():
        got = pmod(torch.from_numpy(W)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply(params, jnp.asarray(W))), **FORWARD_TOL)


def test_hourglass_geometry_and_size():
    """The reference's default sequence model at 10 tags: layers
    (8, 7, 5, 5, 7, 8) and 2,502 parameters per member."""
    jmod = lstm_hourglass(10)
    pmod = lookup_factory("LSTMAutoEncoder", "lstm_hourglass")(10)
    assert pmod.dims == jmod.dims == (8, 7, 5, 5, 7, 8)
    assert sum(p.numel() for p in pmod.parameters()) == 2502
    assert not any(p.requires_grad for p in pmod.parameters())
    assert not any(isinstance(m, torch.nn.LSTM) for m in pmod.modules())
