"""Fused anomaly-scoring epilogue: the CUDA kernel's wrappers and plain versions.

Counterpart of ``gordo_components_tpu/ops/pallas_score.py``. Two entry points
of one kernel (``csrc/anomaly_score.cu``):

- :func:`fused_anomaly_score` — the per-model epilogue over one ``(rows, F)``
  reconstruction (``DiffBasedAnomalyDetector.anomaly``), with
  :func:`fused_anomaly_score_packed` giving its four outputs as one buffer;
- :func:`banked_anomaly_score` — the banked epilogue over a coalesced
  ``(B, T, F)`` batch, with each slot's error-scaler rows gathered from
  ``(M, F)`` banks by ``idx`` (every bucket of ``server/bank.py``).

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
from typing import Tuple

import torch

from gordo_components_torch.ops._cuda import LaunchCounts, check_tensor

Scores = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

launch_counts = LaunchCounts("fused_anomaly_score", "banked_anomaly_score")
reset_launch_counts = launch_counts.reset
_kernel_fn = None
_one_fn = None


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


def _kernel():
    global _kernel_fn
    if _kernel_fn is None:
        from gordo_components_torch.ops import _cuda

        fn = _cuda.load("anomaly_score").gordo_anomaly_score
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def _one():
    global _one_fn
    if _one_fn is None:
        from gordo_components_torch.ops import _cuda

        fn = _cuda.load("anomaly_score").gordo_anomaly_score_one
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, p, p]
        fn.restype = ctypes.c_int
        _one_fn = fn
    return _one_fn


def _launch(target, output, shift_bank, scale_bank, idx) -> Scores:
    """Validate and launch the CUDA kernel on the current stream."""
    dev = target.device
    if target.dim() != 3:
        raise ValueError(f"target must be (B, T, F), got {tuple(target.shape)}")
    B, T, F = target.shape
    M = shift_bank.shape[0]
    if not 1 <= B <= 65535:
        raise ValueError(f"batch B={B} outside the kernel's grid (1..65535)")
    f32 = torch.float32
    check_tensor("target", target, f32, (B, T, F), dev)
    check_tensor("output", output, f32, (B, T, F), dev)
    check_tensor("shift_bank", shift_bank, f32, (M, F), dev)
    check_tensor("scale_bank", scale_bank, f32, (M, F), dev)
    check_tensor("idx", idx, torch.int32, (B,), dev)
    diff = torch.empty_like(target)
    scaled = torch.empty_like(target)
    tot_u = torch.empty((B, T), dtype=f32, device=dev)
    tot_s = torch.empty((B, T), dtype=f32, device=dev)
    err = _kernel()(
        target.data_ptr(), output.data_ptr(), shift_bank.data_ptr(),
        scale_bank.data_ptr(), idx.data_ptr(), B, T, F, diff.data_ptr(),
        scaled.data_ptr(), tot_u.data_ptr(), tot_s.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"anomaly_score kernel launch failed: cudaError {err}")
    return diff, scaled, tot_u, tot_s


def banked_anomaly_score(target, output, shift_bank, scale_bank, idx) -> Scores:
    """``(diff, scaled, total_unscaled, total_scaled)`` for (B, T, F)
    reconstructions against (M, F) error-scaler banks selected by ``idx``
    (B,) int32: the CUDA kernel for tensors on the card, the plain version
    for tensors on the CPU."""
    if target.device.type == "cpu":
        return banked_score_plain(target, output, shift_bank, scale_bank, idx)
    if target.device.type != "cuda":
        raise ValueError(f"unsupported device {target.device}")
    out = _launch(target, output, shift_bank, scale_bank, idx)
    launch_counts.add("banked_anomaly_score")
    return out


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
        rows, F, out.data_ptr(), torch.cuda.current_stream(target.get_device()).cuda_stream,
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
