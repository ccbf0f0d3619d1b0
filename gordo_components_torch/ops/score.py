"""Fused anomaly-scoring epilogue: the CUDA kernel's wrappers and plain versions.

Counterpart of ``gordo_components_tpu/ops/pallas_score.py``. Two entry points
of one kernel (``csrc/anomaly_score.cu``):

- :func:`fused_anomaly_score` — the per-model epilogue over one ``(rows, F)``
  reconstruction (``DiffBasedAnomalyDetector.anomaly``), with
  :func:`fused_anomaly_score_packed` giving its four outputs as one buffer;
- :func:`banked_anomaly_score_packed` — the banked epilogue over a
  coalesced ``(B, T, F)`` batch, with each slot's error-scaler rows gathered
  from ``(M, F)`` banks by ``idx``, written with the output it was given into
  one ``(B, 3*T*F + 2*T)`` buffer: the packed result every bucket of
  ``server/bank.py`` copies to the host; :func:`banked_anomaly_score` gives
  views of it with the JAX package's signature.

Dispatch is by where the tensors lie: on the card the wrapper launches the
kernel or raises; on the CPU it runs the plain version (:func:`score_plain`,
:func:`banked_score_plain`), which is also the reference the kernel is held
to. There is no probe and no fallback from a failed kernel.

Contract (as in the JAX package): ``diff`` and ``scaled`` are bitwise equal
to the plain version; the two row norms sum in another order and agree
within ``rtol=1e-6, atol=1e-6``.

``launch_counts`` counts kernel launches per wrapper, so a run can show that
its main path went through the kernel.
"""

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from gordo_components_torch.ops._cuda import LaunchCounts, check_tensor

Scores = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

launch_counts = LaunchCounts("fused_anomaly_score", "banked_anomaly_score")
reset_launch_counts = launch_counts.reset
_banked_fn = None
_one_fn = None
THREADS = 256  # a block of the kernel: 8 warps


class LaunchPlan(NamedTuple):
    """How ``csrc/anomaly_score.cu`` covers T rows of F features a slot."""

    group: int  # lanes a row: next_pow2(F), at most 32
    tile: int  # rows a block
    grid_x: int  # row blocks a slot (the grid is (grid_x, B))


@functools.lru_cache(maxsize=1024)
def _launch_plan(T: int, F: int) -> LaunchPlan:
    """The kernel's launch plan for T rows of F features a slot (both
    entry points; the kernel checks it): a group of next_pow2(F) lanes, at
    most a warp, owns a row, and a block of 8 warps ``THREADS // group``
    rows."""
    group = min(32, 1 << max(0, F - 1).bit_length())
    tile = THREADS // group
    return LaunchPlan(group, tile, -(-T // tile))


def score_plain(target, output, shift, scale) -> Scores:
    """Plain PyTorch per-model epilogue (the math of ``_jnp_score``)."""
    diff = torch.abs(target - output)
    scaled = (diff - shift) * scale
    tot_u = torch.sqrt(torch.sum(diff * diff, dim=-1))
    tot_s = torch.sqrt(torch.sum(scaled * scaled, dim=-1))
    return diff, scaled, tot_u, tot_s


def banked_score_plain(target, output, shift_bank, scale_bank, idx) -> Scores:
    """Plain PyTorch banked epilogue (the math of ``_jnp_banked_score``):
    target/output (B, T, F); shift/scale banks (M, F); idx (B,)."""
    shift = shift_bank.index_select(0, idx)[:, None, :]
    scale = scale_bank.index_select(0, idx)[:, None, :]
    return score_plain(target, output, shift, scale)


def _banked():
    global _banked_fn
    if _banked_fn is None:
        from gordo_components_torch.ops import _cuda

        fn = _cuda.load("anomaly_score").gordo_anomaly_score_banked
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
        _banked_fn = fn
    return _banked_fn


def _one():
    global _one_fn
    if _one_fn is None:
        from gordo_components_torch.ops import _cuda

        fn = _cuda.load("anomaly_score").gordo_anomaly_score_one
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
        _one_fn = fn
    return _one_fn


def _launch_banked(target, output, shift_bank, scale_bank, idx) -> torch.Tensor:
    """Validate and launch the banked kernel on the current stream; returns
    the packed (B, 3*T*F + 2*T) result."""
    shape = target.shape
    if len(shape) != 3:
        raise ValueError(f"target must be (B, T, F), got {tuple(shape)}")
    B, T, F = shape
    if not 1 <= B <= 65535:
        raise ValueError(f"batch B={B} outside the kernel's grid (1..65535)")
    M = shift_bank.shape[0] if shift_bank.dim() else 0
    dev, f32 = target.device, torch.float32
    for name, t, dtype, want in (
        ("target", target, f32, shape), ("output", output, f32, shape),
        ("shift_bank", shift_bank, f32, (M, F)), ("scale_bank", scale_bank, f32, (M, F)),
        ("idx", idx, torch.int32, (B,)),
    ):
        if t.shape != want or t.dtype != dtype or t.device != dev or not t.is_contiguous():
            check_tensor(name, t, dtype, want, dev)  # raises, naming the fault
    out = torch.empty((B, 3 * T * F + 2 * T), dtype=f32, device=dev)
    err = _banked()(
        target.data_ptr(), output.data_ptr(), shift_bank.data_ptr(), scale_bank.data_ptr(),
        idx.data_ptr(), B, T, F, *_launch_plan(T, F), out.data_ptr(),
        torch.cuda.current_stream(target.get_device()).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"anomaly_score kernel launch failed: cudaError {err}")
    launch_counts.add("banked_anomaly_score")
    return out


def banked_anomaly_score_packed(target, output, shift_bank, scale_bank, idx) -> torch.Tensor:
    """The banked epilogue of (B, T, F) reconstructions against (M, F)
    error-scaler banks selected by ``idx`` (B,) int32, as one float32 buffer
    of shape ``(B, 3*T*F + 2*T)``: each slot's row holds output (as given),
    diff, scaled (T*F each), total_unscaled and total_scaled (T each) back
    to back (:func:`unpack_banked` views them). The CUDA kernel for tensors
    on the card, the plain version for tensors on the CPU."""
    if target.device.type == "cpu":
        B = target.shape[0]
        plain = banked_score_plain(target, output, shift_bank, scale_bank, idx)
        return torch.cat([a.reshape(B, -1) for a in (output, *plain)], dim=1)
    if target.device.type != "cuda":
        raise ValueError(f"unsupported device {target.device}")
    return _launch_banked(target, output, shift_bank, scale_bank, idx)


def unpack_banked(buf: torch.Tensor, T: int, F: int) -> Tuple[torch.Tensor, ...]:
    """Views of ``(output, diff, scaled, total_unscaled, total_scaled)`` in
    a buffer of :func:`banked_anomaly_score_packed`'s layout."""
    B, n = buf.shape[0], T * F
    out, diff, scaled, tot_u, tot_s = buf.split((n, n, n, T, T), dim=1)
    return out.view(B, T, F), diff.view(B, T, F), scaled.view(B, T, F), tot_u, tot_s


def banked_anomaly_score(target, output, shift_bank, scale_bank, idx) -> Scores:
    """``(diff, scaled, total_unscaled, total_scaled)`` for (B, T, F)
    reconstructions against (M, F) error-scaler banks selected by ``idx``
    (B,) int32: views of :func:`banked_anomaly_score_packed`'s buffer on the
    card, the plain version on the CPU."""
    if target.device.type == "cpu":
        return banked_score_plain(target, output, shift_bank, scale_bank, idx)
    buf = banked_anomaly_score_packed(target, output, shift_bank, scale_bank, idx)
    return unpack_banked(buf, *target.shape[1:])[1:]


def unpack_scores(buf: torch.Tensor, rows: int, F: int) -> Scores:
    """Views of ``(diff, scaled, total_unscaled, total_scaled)`` in a buffer
    of :func:`fused_anomaly_score_packed`'s layout."""
    n = rows * F
    diff, scaled, tot_u, tot_s = buf.split((n, n, rows, rows))
    return diff.view(rows, F), scaled.view(rows, F), tot_u, tot_s


def fused_anomaly_score_packed(target, output, shift, scale) -> torch.Tensor:
    """The per-model epilogue of one (rows, F) reconstruction as one flat
    float32 buffer of ``2 * rows * (F + 1)`` values: diff (rows, F), scaled
    (rows, F), total_unscaled (rows,), total_scaled (rows,) back to back
    (:func:`unpack_scores` views them). The CUDA kernel's per-model entry
    point for tensors on the card, the plain version for tensors on the CPU."""
    if target.device.type == "cpu":
        return torch.cat([t.reshape(-1) for t in score_plain(target, output, shift, scale)])
    if target.device.type != "cuda":
        raise ValueError(f"unsupported device {target.device}")
    return _launch_one(target, output, shift, scale)


def _launch_one(target, output, shift, scale) -> torch.Tensor:
    """Validate and launch the per-model kernel on the current stream;
    returns the flat ``2 * rows * (F + 1)`` result."""
    shape = target.shape
    if len(shape) != 2:
        raise ValueError(f"target must be (rows, F), got {tuple(shape)}")
    rows, F = shape
    dev, f32 = target.device, torch.float32
    for name, t, want in (("target", target, shape), ("output", output, shape),
                          ("shift", shift, (F,)), ("scale", scale, (F,))):
        if t.shape != want or t.dtype != f32 or t.device != dev or not t.is_contiguous():
            check_tensor(name, t, f32, want, dev)  # raises, naming the fault
    out = torch.empty(2 * rows * (F + 1), dtype=f32, device=dev)
    err = _one()(
        target.data_ptr(), output.data_ptr(), shift.data_ptr(), scale.data_ptr(),
        rows, F, *_launch_plan(rows, F), out.data_ptr(),
        torch.cuda.current_stream(target.get_device()).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"anomaly_score kernel launch failed: cudaError {err}")
    launch_counts.add("fused_anomaly_score")
    return out


def fused_anomaly_score(target, output, shift, scale) -> Scores:
    """``(diff, scaled, total_unscaled, total_scaled)`` for one (rows, F)
    reconstruction: views of :func:`fused_anomaly_score_packed`'s buffer on
    the card, the plain version on the CPU."""
    if target.device.type == "cpu":
        return score_plain(target, output, shift, scale)
    return unpack_scores(fused_anomaly_score_packed(target, output, shift, scale),
                         *target.shape)
