"""The port's bfloat16 ``compute_dtype`` against the JAX package's, on the CPU.

The reference is Flax's ``dtype=bfloat16`` with float32 parameters. Its
jaxpr fixes where the values round to bfloat16; XLA's default
``xla_allow_excess_precision`` lets a fused computation skip some of those
roundings, so the JAX module is compiled twice here:

- with ``xla_allow_excess_precision=False`` (the jaxpr's rounding points),
  which the port follows. Bands, the tightest the runs show: the dense,
  variational, sigmoid and softplus chains and the conv autoencoder against
  ``conv_impl="lax"`` bitwise up to 2e-8 (one float32 rounding of the output
  cast); the LSTM stack within one bfloat16 rounding of its output
  (``2**-7 * max|out|``): float32 ``tanh`` differs by an ulp between the two
  libraries, and that once in a while moves a value across a bfloat16
  rounding boundary;
- as it runs by default, within the JAX suite's own bfloat16 band
  ``atol = 2e-2 * max(1, max|out|)`` (``tests/test_conv_impl.py:38-57``),
  the ceiling of every band here. The conv autoencoder against the JAX
  package's default ``"matmul"`` formulation (which rounds after every tap)
  is held to that band too.

The plain bfloat16 LSTM step and layer (the fused-step kernel's yardstick on
the card) are held to Flax's ``OptimizedLSTMCell(dtype=bfloat16)``, applied
step by step from the same carries, within rtol=1e-6, atol=3e-7 (float32
``tanh`` of ``c'``). The JAX package's Pallas step raises for bfloat16
inputs, so the contract is the cell; a test records that.

Training: one epoch from the same parameters and JAX's own permutation (and
noise) against the JAX epoch compiled at the rounding points: the loss
within rtol=1e-3, and 98% of the parameters within atol=1e-4 after four
Adam steps of 1e-3. The others are parameters whose small bfloat16 gradient
rounded to another value in the two backward passes (their rounding points
differ: autograd's tanh and sigmoid backward round once, XLA's rule rounds
each of its operations); Adam's step is about its learning rate whatever
the gradient's size, so each such parameter is held within 2 * lr a step,
inside the 2e-2 ceiling. A fleet member and its
single fit, and the bank's scores and ``anomaly()``, run the same port code
and are held within rtol=1e-4, atol=1e-5, as their float32 counterparts.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from gordo_components_torch import serializer
from gordo_components_torch.builder import build_fleet
from gordo_components_torch.convert import (
    conv_from_flax,
    feedforward_from_flax,
    lstm_from_flax,
    vae_from_flax,
)
from gordo_components_torch.device import full_precision_products, resolve_compute_dtype
from gordo_components_torch.models import (
    AutoEncoder,
    ConvAutoEncoder,
    LSTMAutoEncoder,
    lookup_factory,
    train_core,
)
from gordo_components_torch.ops import seq_scan as port_seq
from gordo_components_torch.parallel import FleetTrainer
from gordo_components_torch.server import ModelBank
from gordo_components_tpu.models import train_core as ref
from gordo_components_tpu.models.factories import feedforward_hourglass, lstm_hourglass, lstm_model
from gordo_components_tpu.models.factories.conv import conv1d_autoencoder
from gordo_components_tpu.models.factories.variational import feedforward_variational
from gordo_components_tpu.ops.seq_scan import fused_lstm_step

BF16 = "bfloat16"
CEILING = 2e-2  # the JAX suite's bfloat16 band, times max(1, max|out|)
CELL = dict(rtol=1e-6, atol=3e-7)
EPOCH_LOSS = dict(rtol=1e-3, atol=1e-6)
EPOCH_PARAMS = dict(rtol=0, atol=1e-4)
EPOCH_SHARE = 0.98  # of the parameters within EPOCH_PARAMS
LR = 1e-3
BAND = dict(rtol=1e-4, atol=1e-5)
EXACT = {"xla_allow_excess_precision": False}
F = 10
CPU = torch.device("cpu")


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


# (registry type, kind, JAX factory, kwargs, converter, input shape)
FAMILIES = {
    "dense": ("AutoEncoder", "feedforward_hourglass", feedforward_hourglass, {}, feedforward_from_flax, (64, F)),
    "dense_sigmoid": ("AutoEncoder", "feedforward_hourglass", feedforward_hourglass, {"func": "sigmoid"},
                      feedforward_from_flax, (64, F)),
    "dense_softplus": ("AutoEncoder", "feedforward_hourglass", feedforward_hourglass, {"func": "softplus"},
                       feedforward_from_flax, (64, F)),
    "lstm": ("LSTMAutoEncoder", "lstm_hourglass", lstm_hourglass, {}, lstm_from_flax, (48, 12, F)),
    "conv": ("ConvAutoEncoder", "conv1d_autoencoder", conv1d_autoencoder, {"channels": (8, 4)},
             conv_from_flax, (48, 16, F)),
    "vae": ("AutoEncoder", "feedforward_variational", feedforward_variational,
            {"dims": (8,), "latent_dim": 3}, vae_from_flax, (64, F)),
}
# the tightest band each family holds against the JAX module compiled at
# its jaxpr's rounding points, as a multiple of max|out|
ROUNDING_BAND = {"dense": 0.0, "dense_sigmoid": 0.0, "dense_softplus": 0.0, "lstm": 2.0**-7,
                 "conv": 0.0, "vae": 0.0}


def _pair(family, seed=1, **extra):
    """(JAX bf16 module, its params, the port's bf16 module on them, input)."""
    rt, kind, jf, kw, conv, shape = FAMILIES[family]
    kw = {**kw, **extra}
    jm = jf(F, compute_dtype=BF16, **kw)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), jnp.zeros((1,) + shape[1:])))
    pm = lookup_factory(rt, kind)(F, compute_dtype=BF16, **kw)
    pm.load_state_dict({k: t(v) for k, v in conv(params).items()})
    x = np.random.RandomState(seed).rand(*shape).astype("f4")
    return jm, params, pm.eval(), x


def _port_out(pm, x):
    with torch.no_grad():
        out = pm(t(x))
    assert out.dtype == torch.float32
    return out.numpy()


# --------------------------------------------------------------------- #
# device and dtype resolution
# --------------------------------------------------------------------- #


def test_full_precision_products_sets_the_three_flags():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
        full_precision_products()
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction) = saved


def test_resolve_compute_dtype_names_the_two_dtypes():
    assert resolve_compute_dtype("float32") is torch.float32
    assert resolve_compute_dtype(BF16) is torch.bfloat16
    for bad in ("float16", "bf16", None, torch.bfloat16):
        with pytest.raises(NotImplementedError, match="'float32' or 'bfloat16'"):
            resolve_compute_dtype(bad)


@pytest.mark.parametrize("dtype", ["float16", "float64"])
@pytest.mark.parametrize("family", ["dense", "lstm", "conv", "vae"])
def test_every_factory_refuses_other_dtypes(family, dtype):
    rt, kind, _jf, kw, _conv, _shape = FAMILIES[family]
    with pytest.raises(NotImplementedError, match="'float32' or 'bfloat16'"):
        lookup_factory(rt, kind)(F, compute_dtype=dtype, **kw)


# --------------------------------------------------------------------- #
# modules against Flax
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("family", list(FAMILIES))
def test_module_matches_jax_at_its_rounding_points(family):
    extra = {"conv_impl": "lax"} if family == "conv" else {}
    jm, params, pm, x = _pair(family, **extra)
    want = np.asarray(jax.jit(jm.apply).lower(params, jnp.asarray(x)).compile(EXACT)(params, jnp.asarray(x)))
    got = _port_out(pm, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-8 + ROUNDING_BAND[family] * np.abs(want).max())


@pytest.mark.parametrize("family", ["dense", "lstm", "conv", "vae"])
def test_module_within_the_jax_bf16_band(family):
    """Against the JAX module as it runs (default compile, the conv
    family's default "matmul" formulation), and the port really computes in
    bfloat16: its float32 twin on the same parameters differs."""
    jm, params, pm, x = _pair(family, seed=2)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    got = _port_out(pm, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=CEILING * max(1.0, np.abs(want).max()))
    rt, kind, _jf, kw, conv, _shape = FAMILIES[family]
    f32 = lookup_factory(rt, kind)(F, **kw)
    f32.load_state_dict({k: t(v) for k, v in conv(params).items()})
    assert np.abs(_port_out(f32.eval(), x) - got).max() > 0


def _flax_cell_params(Wi, Wh, b, m, H):
    p = {}
    for k, gate in enumerate("ifgo"):
        sl = slice(k * H, (k + 1) * H)
        if Wi is not None:
            p[f"i{gate}"] = {"kernel": jnp.asarray(Wi[m][:, sl])}
        p[f"h{gate}"] = {"kernel": jnp.asarray(Wh[m][:, sl]), "bias": jnp.asarray(b[m][sl])}
    return {"params": p}


def _cell_case(H, B, M, F_in=3, seed=0):
    rng = np.random.RandomState(1000 * H + 10 * B + M + seed)
    Wi = (rng.randn(M, F_in, 4 * H) / np.sqrt(F_in)).astype("f4")
    Wh = (rng.randn(M, H, 4 * H) / np.sqrt(H)).astype("f4")
    b = (0.1 * rng.randn(M, 4 * H)).astype("f4")
    return rng, Wi, Wh, b


def _bf(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("H,B,M", [(1, 3, 2), (5, 97, 1), (7, 97, 1), (8, 4, 3), (32, 3, 2), (33, 5, 3)])
def test_plain_step_matches_flax_cell(H, B, M):
    """One step from random carries: the cell's input half is xz = r(x @
    Wi), computed outside the step as the port computes it."""
    rng, Wi, Wh, b = _cell_case(H, B, M)
    x = rng.randn(B, M, 3).astype("f4")
    h, c = (rng.randn(B, M, H).astype("f4") for _ in range(2))
    xz = torch.einsum("bmf,mfg->bmg", _bf(x), _bf(Wi))
    c2, h2 = port_seq.fused_lstm_step(xz, t(h), t(c), _bf(Wh), _bf(b))
    assert c2.dtype == h2.dtype == torch.float32
    cell = nn.OptimizedLSTMCell(features=H, dtype=jnp.bfloat16)
    for m in range(M):
        (jc, jh), _ = cell.apply(_flax_cell_params(Wi, Wh, b, m, H), (jnp.asarray(c[:, m]), jnp.asarray(h[:, m])),
                                 jnp.asarray(x[:, m]))
        np.testing.assert_allclose(c2[:, m].numpy(), np.asarray(jc), err_msg=f"c member {m}", **CELL)
        np.testing.assert_allclose(h2[:, m].numpy(), np.asarray(jh), err_msg=f"h member {m}", **CELL)


@pytest.mark.parametrize("H,S,B,M", [(1, 6, 3, 2), (5, 4, 97, 1), (7, 4, 97, 1), (8, 5, 3, 3), (32, 3, 2, 3),
                                     (33, 3, 3, 1), (5, 5, 3, 3), (7, 3, 1, 5)])
def test_plain_layer_matches_chained_flax_cell(H, S, B, M):
    """S steps from zero carries, at odd B*M*H among them (the steps whose
    bfloat16 slices start 8 bytes off a 16-byte line)."""
    rng, Wi, Wh, b = _cell_case(H, B, M, seed=1)
    x = rng.randn(S, B, M, 3).astype("f4")
    xz = torch.einsum("sbmf,mfg->sbmg", _bf(x), _bf(Wi))
    got = port_seq.lstm_layer(xz, _bf(Wh), _bf(b)).numpy()
    assert got.dtype == np.float32 and got.shape == (S, B, M, H)
    cell = nn.OptimizedLSTMCell(features=H, dtype=jnp.bfloat16)
    for m in range(M):
        p = _flax_cell_params(Wi, Wh, b, m, H)
        c = h = jnp.zeros((B, H), jnp.float32)
        for s in range(S):
            (c, h), y = cell.apply(p, (c, h), jnp.asarray(x[s, :, m]))
            np.testing.assert_allclose(got[s, :, m], np.asarray(y), err_msg=f"step {s} member {m}", **CELL)


def test_jax_pallas_step_raises_for_bf16():
    """The reference caveat: the JAX package's fused step stores its float32
    c' and h' into refs typed by xz, so bfloat16 inputs fail to trace; the
    port's contract is the Flax cell (above), not the Pallas kernel."""
    B, M, H = 2, 1, 4
    z = jnp.zeros
    with pytest.raises(ValueError, match="dtype"):
        fused_lstm_step(z((B, M, 4 * H), jnp.bfloat16), z((B, M, H)), z((B, M, H)),
                        z((M, H, 4 * H), jnp.bfloat16), z((M, 4 * H), jnp.bfloat16), interpret=True)


def test_time_major_forward_matches_vmapped_flax_apply():
    """The member-stacked forward (the bank's and the scoring path's) against
    Flax's LSTM stack applied member by member at its rounding points."""
    M, dims = 3, (5, 3)
    jm = lstm_model(F, dims=dims, compute_dtype=BF16)
    trees = [jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(s), jnp.zeros((1, 8, F)))) for s in range(M)]
    x = np.random.RandomState(3).rand(M, 7, 8, F).astype("f4")
    apply = jax.jit(jm.apply).lower(trees[0], jnp.asarray(x[0])).compile(EXACT)
    want = np.stack([np.asarray(apply(p, jnp.asarray(x[m]))) for m, p in enumerate(trees)])
    sds = [lstm_from_flax(p) for p in trees]
    sd = {k: t(np.stack([d[k] for d in sds])) for k in sds[0]}
    weights = ([tuple(sd[f"layers.{i}.{p}"] for p in ("Wi", "Wh", "b")) for i in range(len(dims))],
               (sd["head.kernel"], sd["head.bias"]))
    got = port_seq.lstm_time_major_forward(weights, t(x), ("tanh",) * 2, dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-7 * np.abs(want).max())


# --------------------------------------------------------------------- #
# training against JAX
# --------------------------------------------------------------------- #


def _jax_perm(rng_key, mask):
    _, perm_rng, _ = jax.random.split(rng_key, 3)
    keys = jax.random.uniform(perm_rng, (mask.shape[-1],))
    return np.asarray(jnp.argsort(jnp.where(jnp.asarray(mask) > 0, keys, 2.0)))


def _bf16_noise(module, params, rng, shape):
    """The bfloat16 noise JAX's ``elbo_terms`` draws in ``mu.dtype`` under
    ``rngs={"sample": rng}``, as float32 values."""
    key = module.apply(params, method=lambda m: m.make_rng("sample"), rngs={"sample": rng})
    return np.asarray(jax.random.normal(key, shape, jnp.bfloat16).astype(jnp.float32))


def _compare_epoch(stack, conv, state, jstate, jloss, X, mask, perm, bs, noise=None, **fns):
    flat = stack.from_state_dicts([conv(jax.tree.map(np.asarray, state.params))])
    p_init, p_epoch = train_core.make_train_fns(stack, train_core.make_optimizer("adam", LR), bs, **fns)
    pstate = p_init([train_core.member_generator(0, 0)], CPU, params=flat)
    pstate, ploss = p_epoch(pstate, t(X[None]), t(X[None]), t(mask[None]), torch.full((1,), LR),
                            perm=torch.from_numpy(perm[None].astype(np.int64)),
                            noise=None if noise is None else t(noise[None]))
    assert pstate.params.dtype == ploss.dtype == torch.float32
    assert all(s.dtype == torch.float32 for s in (pstate.opt_state.mu, pstate.opt_state.nu))
    np.testing.assert_allclose(float(ploss[0]), float(jloss), **EPOCH_LOSS)
    want = conv(jax.tree.map(np.asarray, jstate.params))
    start = conv(jax.tree.map(np.asarray, state.params))
    got = stack.state_dicts(pstate.params)[0]
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    moved = np.concatenate([np.abs(want[k] - start[k]).ravel() for k in want])
    steps = int(pstate.opt_state.count[0])
    assert steps == len(X) // bs
    assert np.mean(diff <= EPOCH_PARAMS["atol"]) >= EPOCH_SHARE, np.sort(diff)[-10:]
    assert diff.max() <= 2 * LR * steps
    assert np.median(moved) > 10 * EPOCH_PARAMS["atol"]  # the epoch moved the parameters well past the band


@pytest.mark.parametrize("family", ["dense", "vae"])
def test_row_epoch_matches_jax(family):
    rt, kind, jf, kw, conv, _shape = FAMILIES[family]
    bs, n = 16, 56
    X, Y, mask, _ = ref.pad_to_batches(np.random.RandomState(4).rand(n, F).astype("f4"),
                                       np.zeros((n, F), np.float32), bs)
    jm = jf(F, compute_dtype=BF16, **kw)
    loss = "vae" if family == "vae" else "mse"
    opt = ref.make_optimizer("adam", LR)
    init_fn, epoch_fn = ref.make_train_fns(jm, opt, bs, loss=loss)
    state = init_fn(jax.random.PRNGKey(5), jnp.asarray(X[0]))
    perm = _jax_perm(state.rng, mask)
    noise = None
    if family == "vae":
        _, _, batch_base = jax.random.split(state.rng, 3)
        noise = np.stack([_bf16_noise(jm, state.params, jax.random.fold_in(batch_base, i), (bs, kw["latent_dim"]))
                          for i in range(len(X) // bs)])
    args = (state, jnp.asarray(X), jnp.asarray(X), jnp.asarray(mask))
    jstate, jloss = jax.jit(epoch_fn).lower(*args).compile(EXACT)(*args)
    stack = train_core.make_stack(lookup_factory(rt, kind)(F, compute_dtype=BF16, **kw))
    _compare_epoch(stack, conv, state, jstate, jloss, X, mask, perm, bs, noise, loss=loss)


@pytest.mark.parametrize("family", ["lstm", "conv"])
def test_window_epoch_matches_jax(family):
    rt, kind, jf, kw, conv, _shape = FAMILIES[family]
    lb, bs, n = 8, 8, 29
    # the conv family against the formulation that rounds as the port does
    kw = dict(kw, encoding_layers=2) if family == "lstm" else dict(kw, conv_impl="lax")
    jm = jf(F, compute_dtype=BF16, **kw)
    opt = ref.make_optimizer("adam", LR)
    rows = np.random.RandomState(6).rand(n + lb - 1, F).astype("f4")
    n_pad = -(-n // bs) * bs
    X = np.zeros((n_pad + lb - 1, F), np.float32)
    X[: len(rows)] = rows
    mask = (np.arange(n_pad) < n).astype(np.float32)
    init_fn, s_epoch = ref.make_seq_train_fns(jm, opt, bs, lb, 0)
    state = init_fn(jax.random.PRNGKey(7), jnp.zeros((lb, F)))
    perm = _jax_perm(state.rng, mask)
    args = (state, jnp.asarray(X), None, jnp.asarray(mask))
    jstate, jloss = jax.jit(s_epoch).lower(*args).compile(EXACT)(*args)
    stack = train_core.make_stack(lookup_factory(rt, kind)(F, compute_dtype=BF16, **kw), lb, 0)
    _compare_epoch(stack, conv, state, jstate, jloss, X, mask, perm, bs)


# --------------------------------------------------------------------- #
# the port's entry points in bfloat16
# --------------------------------------------------------------------- #


def _rows(n, f=4, seed=0):
    tt = np.arange(n)[:, None]
    rng = np.random.RandomState(seed)
    return (np.sin(0.05 * tt * np.arange(1, f + 1)) + 0.05 * rng.randn(n, f)).astype("f4")


ESTIMATORS = {
    "dense": (AutoEncoder, dict(kind="feedforward_symmetric", dims=(3,))),
    "vae": (AutoEncoder, dict(kind="feedforward_variational", dims=(4,), latent_dim=2)),
    "lstm": (LSTMAutoEncoder, dict(kind="lstm_symmetric", dims=(3,), lookback_window=6)),
    "conv": (ConvAutoEncoder, dict(channels=(4,), lookback_window=8)),
}


@pytest.mark.parametrize("family", list(ESTIMATORS))
def test_estimator_fits_in_bf16_with_float32_parameters(family):
    cls, kw = ESTIMATORS[family]
    X = _rows(120)
    est = cls(compute_dtype=BF16, epochs=4, batch_size=16, learning_rate=1e-2, device="cpu", **kw).fit(X)
    assert est.module.compute_dtype is torch.bfloat16
    assert all(np.asarray(v).dtype == np.float32 for v in est.params_.values())
    assert est.history["loss"][-1] < est.history["loss"][0]
    pred = est.predict(X)
    assert pred.dtype == np.float32 and np.isfinite(pred).all()
    f32 = cls(epochs=4, batch_size=16, learning_rate=1e-2, device="cpu", **kw)
    f32.params_, f32.n_features_ = est.params_, est.n_features_
    assert np.abs(f32.predict(X) - pred).max() > 0  # the bf16 model computed in bf16


def _gang(family, members, dtype=BF16, **extra):
    cls, kw = ESTIMATORS[family]
    kw = dict(kw)
    model_type = cls.__name__
    lookback = kw.pop("lookback_window", 10)
    return FleetTrainer(model_type=model_type, lookback_window=lookback, compute_dtype=dtype, epochs=2,
                        batch_size=16, device="cpu", **kw, **extra).fit(members)


@pytest.mark.parametrize("family", list(ESTIMATORS))
def test_gang_member_is_its_single_fit(family):
    """A bfloat16 gang of three ragged members: member 0 against its single
    fit on the same scaled rows (the same generator and code path)."""
    members = {f"m{i}": _rows(r, seed=i) for i, r in enumerate([90, 70, 50])}
    gang = _gang(family, members)
    m0 = gang["m0"]
    assert m0.factory_kwargs["compute_dtype"] == BF16
    cls, kw = ESTIMATORS[family]
    scaled = (members["m0"] - m0.scaler.shift) * m0.scaler.scale
    single = cls(compute_dtype=BF16, epochs=2, batch_size=16, device="cpu", **kw).fit(scaled)
    for k, v in single.params_.items():
        np.testing.assert_allclose(m0.params[k], v, err_msg=k, **BAND)
    np.testing.assert_allclose(m0.history["loss"], single.history["loss"], **BAND)


def _detectors(family):
    """A bfloat16 and a float32 fleet member of the same kwargs and weights."""
    members = {"a": _rows(80, seed=1), "b": _rows(60, seed=2)}
    bf = _gang(family, members)
    f32 = _gang(family, members, dtype="float32")
    return bf, f32


@pytest.mark.parametrize("family", list(ESTIMATORS))
def test_bank_buckets_by_dtype_and_scores_as_anomaly(family, tmp_path):
    bf, f32 = _detectors(family)
    entries = [m.to_entry() for m in bf.values()]
    assert {e.compute_dtype for e in entries} == {BF16}
    f32_entries = [dataclasses.replace(m.to_entry(), name="f32-" + n) for n, m in f32.items()]
    # equal kwargs, other dtype: two buckets, and the bf16 one labelled apart
    bank = ModelBank.from_entries(entries + f32_entries, device="cpu")
    assert bank.n_buckets == 2
    labels = sorted(b.label for b in bank._buckets.values())
    assert labels[0] != labels[1] and labels[0] in labels[1]
    bucket = bank._buckets[entries[0].bucket_key()]
    weights = list(bucket.weights.values())
    assert weights and all(w.dtype == torch.bfloat16 for w in weights)
    X = _rows(40, seed=5)
    for name, member in bf.items():
        want = member.to_estimator().anomaly(X)
        got = bank.score(name, X).to_arrays()
        for k, a in got.items():
            np.testing.assert_allclose(a, want[k], err_msg=f"{name} {k}", **BAND)
        # the float32 twin of this member scores otherwise
        f32_scores = bank.score("f32-" + name, X).to_arrays()["model-output"]
        assert np.abs(f32_scores - got["model-output"]).max() > 0
    # an artifact keeps the dtype, and scores as the member did
    serializer.dump(bf["a"].to_entry(), str(tmp_path / "a"))
    meta = json.loads((tmp_path / "a" / "detector.json").read_text())
    assert meta["compute_dtype"] == BF16
    loaded = serializer.load(str(tmp_path / "a"), device="cpu")
    assert loaded.to_entry().compute_dtype == BF16
    again = loaded.anomaly(X)
    for k, a in bf["a"].to_estimator().anomaly(X).items():
        np.testing.assert_allclose(again[k], a, err_msg=k, **BAND)


def test_artifact_without_dtype_reads_as_float32(tmp_path):
    members = {"a": _rows(60)}
    entry = _gang("dense", members, dtype="float32")["a"].to_entry()
    serializer.dump(entry, str(tmp_path / "a"))
    path = tmp_path / "a" / "detector.json"
    meta = json.loads(path.read_text())
    assert meta.pop("compute_dtype") == "float32"
    path.write_text(json.dumps(meta))
    assert serializer.load_entry(str(tmp_path / "a")).compute_dtype == "float32"


def test_build_fleet_splits_gangs_by_dtype(tmp_path):
    """Two machines of one architecture, one of them bfloat16: two gangs,
    the artifacts record their dtypes, a bank serves them in two buckets."""
    def machine(name, dtype):
        est = {"gordo_components_torch.models.AutoEncoder": {
            "kind": "feedforward_symmetric", "dims": [3], "epochs": 2, "batch_size": 16, "compute_dtype": dtype}}
        return {"name": name, "dataset": {
            "type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00Z",
            "train_end_date": "2020-01-01T12:00:00Z", "tag_list": [f"{name}-{j}" for j in range(3)]},
            "model": {"gordo_components_torch.models.DiffBasedAnomalyDetector": {"base_estimator": {
                "sklearn.pipeline.Pipeline": {"steps": ["sklearn.preprocessing.MinMaxScaler", est]}}}}}

    report = build_fleet([machine("m-bf16", BF16), machine("m-f32", "float32")], str(tmp_path / "out"),
                         model_register_dir=str(tmp_path / "reg"), device="cpu")
    assert not report.failed
    entries = [serializer.load_entry(str(tmp_path / "out" / n)) for n in ("m-bf16", "m-f32")]
    assert [e.compute_dtype for e in entries] == [BF16, "float32"]
    assert ModelBank.from_entries(entries, device="cpu").n_buckets == 2
