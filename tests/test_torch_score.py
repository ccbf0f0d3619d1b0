"""The port's anomaly-score epilogue against the JAX package's.

On the CPU the port's wrappers run their plain versions, so this holds the
plain math (which the CUDA kernel is held to on the card, in chip_smoke.py)
to the JAX reference ``_jnp_banked_score``/``_jnp_score`` and to the Pallas
kernels in interpreter mode, at the shapes of tests/test_banked_kernel.py.

Contract, as the JAX package states it (pallas_score.py): ``diff`` and
``scaled`` are elementwise IEEE operations and must be bitwise equal; the
two row norms reduce in another order and stay within rtol=1e-6, atol=1e-6.
"""

import numpy as np
import pytest
import torch

from gordo_components_torch.ops import score as port
from gordo_components_tpu.ops.pallas_score import (
    ROW_TILE,
    _jnp_banked_score,
    _jnp_score,
    banked_anomaly_score,
    fused_anomaly_score,
)

NORM_RTOL = 1e-6
NORM_ATOL = 1e-6
SHAPES = [
    (4, 33, 10, 7),
    (1, 7, 3, 1),
    (2, ROW_TILE, 128, 3),
    (3, ROW_TILE + 5, 130, 5),
    (8, 16, 257, 16),
]


def _case(B, T, F, M, seed=0):
    rng = np.random.RandomState(seed)
    target = rng.randn(B, T, F).astype("float32")
    output = (target + 0.1 * rng.randn(B, T, F)).astype("float32")
    shift_bank = (rng.randn(M, F) * 0.01).astype("float32")
    scale_bank = (1.0 + rng.rand(M, F)).astype("float32")
    idx = rng.randint(0, M, size=B).astype("int32")
    return target, output, shift_bank, scale_bank, idx


def _assert_parity(got, want):
    for g, w, name in zip(got[:2], want[:2], ["diff", "scaled"]):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for g, w, name in zip(got[2:], want[2:], ["tot_u", "tot_s"]):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=NORM_RTOL, atol=NORM_ATOL, err_msg=name)


@pytest.mark.parametrize("B,T,F,M", SHAPES)
def test_banked_score_matches_jax_reference(B, T, F, M):
    args = _case(B, T, F, M)
    got = port.banked_anomaly_score(*(torch.from_numpy(a) for a in args))
    _assert_parity(got, _jnp_banked_score(*args))
    _assert_parity(got, banked_anomaly_score(*args, mode="interpret"))


@pytest.mark.parametrize("B,T,F,M", SHAPES)
def test_fused_score_matches_jax_reference(B, T, F, M):
    target, output, shift_bank, scale_bank, idx = _case(B, T, F, M, seed=1)
    t, o = target[0], output[0]
    sh, sc = shift_bank[idx[0]], scale_bank[idx[0]]
    got = port.fused_anomaly_score(*(torch.from_numpy(a) for a in (t, o, sh, sc)))
    _assert_parity(got, _jnp_score(t, o, sh, sc))
    _assert_parity(got, fused_anomaly_score(t, o, sh, sc, force="interpret"))


def test_banked_gather_selects_the_right_member():
    B, T, F, M = 6, 9, 4, 6
    rng = np.random.RandomState(42)
    target = rng.randn(B, T, F).astype("float32")
    output = (target + rng.randn(B, T, F)).astype("float32")
    scale_bank = np.stack([np.full(F, 10.0**m, np.float32) for m in range(M)])
    shift_bank = np.zeros((M, F), np.float32)
    idx = np.asarray([5, 0, 3, 1, 4, 2], np.int32)
    args = (target, output, shift_bank, scale_bank, idx)
    got = port.banked_anomaly_score(*(torch.from_numpy(a) for a in args))
    _assert_parity(got, _jnp_banked_score(*args))
    diff = np.abs(target - output)
    for b in range(B):
        np.testing.assert_allclose(got[1][b].numpy(), diff[b] * 10.0 ** idx[b], rtol=1e-5)


@pytest.mark.parametrize("B,T,F,M", SHAPES)
def test_packed_banked_layout_matches_plain_and_jax(B, T, F, M):
    """One (B, 3*T*F + 2*T) buffer: each slot's row holds the output copy,
    diff, scaled and the two norms back to back; its views are the plain
    epilogue's outputs bitwise and the JAX reference's within its band."""
    args = _case(B, T, F, M, seed=2)
    targs = [torch.from_numpy(a) for a in args]
    buf = port.banked_anomaly_score_packed(*targs)
    assert buf.shape == (B, 3 * T * F + 2 * T) and buf.dtype == torch.float32
    views = port.unpack_banked(buf, T, F)
    for got, want in zip(views, (targs[1], *port.banked_score_plain(*targs))):
        assert got.shape == want.shape
        assert torch.equal(got, want)
    storage = buf.untyped_storage().data_ptr()
    assert all(v.untyped_storage().data_ptr() == storage for v in views)  # views, not copies
    _assert_parity(views[1:], _jnp_banked_score(*args))
    _assert_parity(views[1:], banked_anomaly_score(*args, mode="interpret"))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    port.reset_launch_counts()
    args = [torch.from_numpy(a) for a in _case(2, 5, 3, 2)]
    port.banked_anomaly_score(*args)
    port.banked_anomaly_score_packed(*args)
    port.fused_anomaly_score(args[0][0], args[1][0], args[2][0], args[3][0])
    assert port.launch_counts == {"fused_anomaly_score": 0, "banked_anomaly_score": 0}


def test_other_devices_raise():
    args = [torch.empty(0, device="meta") for _ in range(5)]
    with pytest.raises(ValueError, match="unsupported device"):
        port.banked_anomaly_score(*args)
    with pytest.raises(ValueError, match="unsupported device"):
        port.banked_anomaly_score_packed(*args)
    with pytest.raises(ValueError, match="unsupported device"):
        port.fused_anomaly_score(*args[:4])


@pytest.mark.parametrize(
    "change, err",
    [
        (lambda a: {**a, "target": a["target"].double()}, TypeError),
        (lambda a: {**a, "idx": a["idx"].long()}, TypeError),
        (lambda a: {**a, "output": a["output"][:, :-1]}, ValueError),
        (lambda a: {**a, "scale_bank": a["scale_bank"][:, :-1]}, ValueError),
        (lambda a: {**a, "idx": a["idx"][:-1]}, ValueError),
        (lambda a: {**a, "output": a["output"].transpose(0, 1).contiguous().transpose(0, 1)},
         ValueError),
        (lambda a: {**a, "target": a["target"][0]}, ValueError),
    ],
    ids=["f64", "idx-int64", "rows", "bank-width", "idx-len", "strided", "rank"],
)
def test_kernel_launch_validates_its_inputs(change, err):
    """The wrapper refuses what the kernel cannot take before any launch,
    so these checks run (and fail) the same way on the CPU."""
    names = ("target", "output", "shift_bank", "scale_bank", "idx")
    args = change(dict(zip(names, (torch.from_numpy(a) for a in _case(3, 4, 5, 2)))))
    with pytest.raises(err):
        port._launch_banked(*(args[n] for n in names))


def _nonfinite_case(where: str, value: float, seed: int):
    """A banked case with ``value`` (NaN, +inf or -inf) placed in some
    elements of ``output`` or ``target``, or in the whole scale row of the
    member the first slot reads; every other element finite."""
    target, output, shift_bank, scale_bank, idx = _case(4, 33, 10, 7, seed=seed)
    rng = np.random.RandomState(seed)
    if where == "scale":
        scale_bank[idx[0]] = value
    else:
        arr = target if where == "target" else output
        flat = arr.reshape(-1)
        flat[rng.choice(flat.size, 40, replace=False)] = value
    return target, output, shift_bank, scale_bank, idx


def _assert_same_nonfinite(got, want):
    """diff and scaled equal with NaN equal to NaN and infinities by sign
    (``assert_array_equal``: finite elements exactly); the norms within the
    band where finite, and NaN and +-inf in the same places."""
    for g, w, name in zip(got[:2], want[:2], ["diff", "scaled"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    for g, w, name in zip(got[2:], want[2:], ["tot_u", "tot_s"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=NORM_RTOL, atol=NORM_ATOL,
                                   equal_nan=True, err_msg=name)


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf], ids=["nan", "+inf", "-inf"])
@pytest.mark.parametrize("where", ["output", "target", "scale"])
def test_plain_versions_propagate_non_finite_values_as_jax(where, value):
    """The breaker reads the totals the epilogue computes: the plain
    versions (the kernels' references on the card) carry NaN and +-inf
    through as the JAX reference and the Pallas kernels in interpreter mode
    do, in the banked and the per-model entry points."""
    args = _nonfinite_case(where, value, seed=3)
    got = port.banked_anomaly_score(*(torch.from_numpy(a) for a in args))
    assert not np.isfinite(got[3].numpy()).all()  # the non-finite value reached a total
    _assert_same_nonfinite(got, _jnp_banked_score(*args))
    _assert_same_nonfinite(got, banked_anomaly_score(*args, mode="interpret"))
    target, output, shift_bank, scale_bank, idx = args
    single = (target[0], output[0], shift_bank[idx[0]], scale_bank[idx[0]])
    got = port.fused_anomaly_score(*(torch.from_numpy(np.ascontiguousarray(a)) for a in single))
    _assert_same_nonfinite(got, _jnp_score(*single))
    _assert_same_nonfinite(got, fused_anomaly_score(*single, force="interpret"))
