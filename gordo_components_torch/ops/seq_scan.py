"""Time-major LSTM forward with the fused recurrent step as a CUDA kernel.

Counterpart of ``gordo_components_tpu/ops/seq_scan.py`` for scoring. One
scan over time with the member axis innermost: member-major windows
``(M, B, T, F)`` are viewed time-major ``(T, B, M, F)``, each layer's input
projection for all timesteps is one wide product (``tbmf,mfg->tbmg``), and
the recurrence runs in the kernel (``csrc/lstm_step.cu``). Gate math is
Flax ``OptimizedLSTMCell``'s (gate order i, f, g, o; bias on the hidden half
only)::

    z = x @ Wi + h @ Wh + b
    c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
    h' = sigmoid(o) * tanh(c')

Two wrappers launch the one kernel, which runs S consecutive steps:

- :func:`fused_lstm_step` — one step, the exact counterpart of the TPU
  kernel, with its signature and layout (S = 1);
- :func:`lstm_layer` — a whole layer over time-major ``xz`` in one launch
  (S = lookback), which is what :func:`lstm_time_major_forward` calls.

On the card a wrapper launches the kernel or raises; on the CPU it runs the
plain version (:func:`lstm_step_plain`, a Python loop over steps for the
layer), which is also the reference the kernel is held to. The kernel is
forward-only, as on the TPU: it serves every forward that needs no
gradient (scoring, validation losses, error scalers), and a wrapper raises
for a CUDA input that would need one. Training differentiates
:func:`lstm_train_forward`, PyTorch ops under autograd.

Not ported: the layout and kernel-mode knobs (``GORDO_SEQ_LAYOUT``,
``GORDO_SEQ_KERNEL``) — the port has one layout and the kernel-or-raise
rule — and ``pad_gate_lanes``, which pads H to the TPU's 128 lanes; the CUDA
kernel bounds-checks ragged H, B and M instead.

``launch_counts`` counts kernel launches per wrapper.
"""

import ctypes
import functools
from typing import List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from gordo_components_torch.ops._cuda import LaunchCounts, check_tensor
from gordo_components_torch.ops.activations import resolve_activation

LayerWeights = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # Wi, Wh, b
Weights = Tuple[List[LayerWeights], Tuple[torch.Tensor, torch.Tensor]]

MAX_HIDDEN = 1024  # one kernel thread per (window, hidden unit)
WARP_MAX_HIDDEN = 32  # the warp path's widest pair: one lane per unit
N_SM = 132  # streaming multiprocessors of an H100 SXM
BLOCK_SMEM_BUDGET = 100 * 1024  # block path: two blocks still fit an SM
WARP_STAGES = 8  # the warp path's ring slots (the kernel is built for 8)

launch_counts = LaunchCounts("fused_lstm_step", "lstm_layer")
reset_launch_counts = launch_counts.reset
_kernel_fn = None


def extract_lstm_weights(params: Mapping) -> Weights:
    """Per-layer ``(Wi, Wh, b)`` and the Dense head ``(Wd, bd)`` from a Flax
    ``LSTMStack`` param tree of arrays (with or without the ``"params"``
    level, with or without a leading member axis on every leaf), as float32
    tensors. Per-gate kernels concatenate on the last axis in the order
    i, f, g, o: shapes ``([M,] F_in, 4H)``, ``([M,] H, 4H)``, ``([M,] 4H)``."""
    from gordo_components_torch.convert import lstm_from_flax

    sd = {k: torch.as_tensor(v) for k, v in lstm_from_flax(params).items()}
    n = sum(1 for k in sd if k.endswith(".Wh"))
    layers = [tuple(sd[f"layers.{i}.{p}"] for p in ("Wi", "Wh", "b")) for i in range(n)]
    return layers, (sd["head.kernel"], sd["head.bias"])


def lstm_step_plain(xz_t, h, c, Wh, b):
    """One recurrent step in plain PyTorch (the math of ``lstm_step_jnp``):
    xz_t (B, M, 4H) precomputed input projection; h, c (B, M, H); Wh
    (M, H, 4H); b (M, 4H). Returns (c', h')."""
    z = xz_t + torch.bmm(h.transpose(0, 1), Wh).transpose(0, 1) + b[None]
    i, f, g, o = z.chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return c2, h2


def lstm_layer_plain(xz, Wh, b):
    """A layer's steps from a zero state in plain PyTorch: xz (S, B, M, 4H)
    -> every step's h, (S, B, M, H)."""
    _, B, M, _ = xz.shape
    h = c = xz.new_zeros((B, M, Wh.shape[-2]))
    ys = []
    for xz_t in xz:
        c, h = lstm_step_plain(xz_t, h, c, Wh, b)
        ys.append(h)
    return torch.stack(ys)


class LaunchPlan(NamedTuple):
    """How ``csrc/lstm_step.cu`` covers S steps of B windows x M members
    at width H (see the note at the top of that file)."""

    group: int  # warp path: lanes per (window, member) pair; 0: block path
    tile: int  # pairs (warp path) or windows of one member (block path) a block
    threads: int  # a block
    stages: int  # slots of the shared-memory ring that streams xz ahead
    stage_w: bool  # block path: Wh[m] staged in shared memory
    smem_bytes: int  # dynamic shared memory a block
    grid: Tuple[int, int]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def _launch_plan(B: int, M: int, H: int) -> LaunchPlan:
    """The kernel's launch plan for B windows, M members, width H.

    Warp path (H <= 32): the B*M (window, member) pairs are flattened,
    next_pow2(H) lanes a pair, 32 // that pairs a warp; blocks of up to 4
    warps, fewer when the pairs would not give every SM a block; an 8-slot
    ring of the warp's slice of a step (at most 512 bytes a slot).

    Block path (H > 32): windows of one member a block, about 256 threads,
    the tile balanced over the windows; a ring of 8 slots (4 where 8 do not
    fit the budget) and ``Wh[m]`` in shared memory where it fits beside them.
    """
    f32 = 4
    if H <= WARP_MAX_HIDDEN:
        group = 1 << (H - 1).bit_length()
        per_warp = 32 // group
        pairs = B * M
        warps = min(4, max(1, _cdiv(_cdiv(pairs, per_warp), N_SM)))
        tile = warps * per_warp
        smem = f32 * warps * WARP_STAGES * per_warp * 4 * H
        return LaunchPlan(group, tile, 32 * warps, WARP_STAGES, False, smem,
                          (_cdiv(pairs, tile), 1))
    n_tiles = _cdiv(B, max(1, min(B, 256 // H)))
    tile = _cdiv(B, n_tiles)
    slot = f32 * tile * 4 * H
    h_bytes = f32 * tile * H
    w_bytes = f32 * H * 4 * H
    stages = 8 if 8 * slot + h_bytes <= BLOCK_SMEM_BUDGET else 4
    stage_w = stages * slot + h_bytes + w_bytes <= BLOCK_SMEM_BUDGET
    smem = stages * slot + h_bytes + (w_bytes if stage_w else 0)
    return LaunchPlan(0, tile, 32 * _cdiv(tile * H, 32), stages, stage_w, smem, (n_tiles, M))


def _kernel():
    global _kernel_fn
    if _kernel_fn is None:
        from gordo_components_torch.ops import _cuda

        fn = _cuda.load("lstm_step").gordo_lstm_steps
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, *[i] * 12, p, p, p]
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def _launch(xz, h0: Optional[torch.Tensor], c0: Optional[torch.Tensor], Wh, b):
    """Validate and launch S steps on the current stream; returns (ys, c)."""
    if xz.dim() != 4:
        raise ValueError(f"xz must be (S, B, M, 4H), got {tuple(xz.shape)}")
    S, B, M, H4 = xz.shape
    H = H4 // 4
    if H4 != 4 * H or not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"gate width 4H={H4} needs 1 <= H <= {MAX_HIDDEN}")
    if not 1 <= M <= 65535:
        raise ValueError(f"members M={M} outside the kernel's grid (1..65535)")
    dev, f32 = xz.device, torch.float32
    check_tensor("xz", xz, f32, (S, B, M, H4), dev)
    check_tensor("Wh", Wh, f32, (M, H, H4), dev)
    check_tensor("b", b, f32, (M, H4), dev)
    for name, t in (("h", h0), ("c", c0)):
        if t is not None:
            check_tensor(name, t, f32, (B, M, H), dev)
    if xz.data_ptr() % 16:
        raise ValueError("xz must start on a 16-byte boundary (the kernel copies 16-byte pieces)")
    plan = _launch_plan(B, M, H)
    ys = torch.empty((S, B, M, H), dtype=torch.float32, device=dev)
    c_out = torch.empty((B, M, H), dtype=torch.float32, device=dev)
    err = _kernel()(
        xz.data_ptr(), None if h0 is None else h0.data_ptr(),
        None if c0 is None else c0.data_ptr(), Wh.data_ptr(), b.data_ptr(),
        S, B, M, H, plan.group, plan.tile, plan.threads, plan.stages,
        int(plan.stage_w), plan.smem_bytes, *plan.grid, ys.data_ptr(),
        c_out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"lstm_step kernel launch failed: cudaError {err}")
    return ys, c_out


def _refuse_grad(*tensors) -> None:
    """The kernel has no backward: a CUDA input that autograd would
    differentiate through it is an error, never a silent detach."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            "the fused LSTM step kernel is forward-only: call it under torch.no_grad(), "
            "or train through lstm_train_forward"
        )


def fused_lstm_step(xz_t, h, c, Wh, b):
    """One LSTM step for every (window, member), with ``lstm_step_jnp``'s
    signature and layout: xz_t (B, M, 4H), h/c (B, M, H), Wh (M, H, 4H),
    b (M, 4H). Returns (c', h'): the CUDA kernel with S = 1 for tensors on
    the card, the plain version for tensors on the CPU."""
    if xz_t.device.type == "cpu":
        return lstm_step_plain(xz_t, h, c, Wh, b)
    if xz_t.device.type != "cuda":
        raise ValueError(f"unsupported device {xz_t.device}")
    if xz_t.dim() != 3:
        raise ValueError(f"xz_t must be (B, M, 4H), got {tuple(xz_t.shape)}")
    _refuse_grad(xz_t, h, c, Wh, b)
    ys, c2 = _launch(xz_t[None], h, c, Wh, b)
    launch_counts.add("fused_lstm_step")
    return c2, ys[0]


def lstm_layer(xz, Wh, b):
    """One LSTM layer from a zero state over time-major ``xz`` (S, B, M, 4H)
    (the input projection of every step), with Wh (M, H, 4H) and b (M, 4H):
    every step's h, (S, B, M, H). One launch of the CUDA kernel for all S
    steps on the card, the plain step loop on the CPU."""
    if xz.device.type == "cpu":
        return lstm_layer_plain(xz, Wh, b)
    if xz.device.type != "cuda":
        raise ValueError(f"unsupported device {xz.device}")
    _refuse_grad(xz, Wh, b)
    ys, _ = _launch(xz, None, None, Wh, b)
    launch_counts.add("lstm_layer")
    return ys


def lstm_time_major_forward(
    weights: Weights, xb: torch.Tensor, funcs: Sequence[str], out_func: str = "linear"
) -> torch.Tensor:
    """LSTM-stack forward over member-stacked weights.

    ``weights`` is ``(layers, (Wd, bd))`` as :func:`extract_lstm_weights`
    gives it, every tensor with a leading member axis M; ``funcs`` are the
    per-layer activations and ``out_func`` the head's. ``xb``: (M, B, T, F),
    each member's batch of windows (the bank passes (slots, windows,
    lookback, F)). Returns (M, B, F): the head over the last layer's final
    hidden state."""
    layers, (Wd, bd) = weights
    if len(funcs) != len(layers):
        raise ValueError(f"{len(layers)} layers but {len(funcs)} activations")
    x = xb.permute(2, 1, 0, 3)  # (T, B, M, F), a view
    for (Wi, Wh, b), func in zip(layers, funcs):
        xz = torch.einsum("tbmf,mfg->tbmg", x, Wi).contiguous()
        x = resolve_activation(func)(lstm_layer(xz, Wh.contiguous(), b.contiguous()))
    out = torch.bmm(x[-1].transpose(0, 1), Wd) + bd[:, None, :]  # (M, B, F)
    return resolve_activation(out_func)(out)


def _train_step(xz_t, h, c, Wh):
    """One recurrent step for autograd, member-major: ``lstm_step_jnp``'s
    math with the bias already in ``xz_t`` (M, B, 4H); h, c (M, B, H), Wh
    (M, H, 4H). Returns (c', h')."""
    i, f, g, o = torch.baddbmm(xz_t, h, Wh).chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return c2, torch.sigmoid(o) * torch.tanh(c2)


def lstm_train_forward(
    weights: Weights, xb: torch.Tensor, funcs: Sequence[str], out_func: str = "linear"
) -> torch.Tensor:
    """The training forward: :func:`lstm_time_major_forward`'s function in
    PyTorch ops that autograd differentiates, never the kernel. The JAX
    package trains the same way: its fused step is forward-only and
    "training keeps the jnp step" (``gordo_components_tpu/ops/seq_scan.py:43-46``),
    ``lstm_time_major_forward(..., kernel="jnp")`` inside the gang epoch.

    ``xb`` (M, B, T, F) -> (M, B, F). Per layer one ``torch.baddbmm`` for
    every step's input projection and bias, then a loop over time whose
    step is one ``torch.baddbmm`` over (M, B, .) and the gates; the
    activation on the layer's outputs; the head on the last hidden state."""
    layers, (Wd, bd) = weights
    if len(funcs) != len(layers):
        raise ValueError(f"{len(layers)} layers but {len(funcs)} activations")
    M, B, T, _ = xb.shape
    x = xb.transpose(1, 2)  # (M, T, B, F)
    for (Wi, Wh, b), func in zip(layers, funcs):
        H = Wh.shape[-2]
        xz = torch.baddbmm(b[:, None, :], x.reshape(M, T * B, -1), Wi).view(M, T, B, 4 * H)
        h = c = xz.new_zeros((M, B, H))
        ys = []
        for t in range(T):
            c, h = _train_step(xz[:, t], h, c, Wh)
            ys.append(h)
        x = resolve_activation(func)(torch.stack(ys, dim=1))
    return resolve_activation(out_func)(torch.baddbmm(bd[:, None, :], x[:, -1], Wd))
