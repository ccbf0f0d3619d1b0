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

In bfloat16 (the models' ``compute_dtype``) the step is Flax's
``OptimizedLSTMCell(dtype=bfloat16)``, with ``r()`` the rounding to
bfloat16 and ``xz = r(bf16(x) @ Wi)`` (bfloat16 ``xz``, ``Wh`` and ``b``)::

    z = r(xz + r(r(bf16(h) @ Wh) + b))    # products accumulate in float32
    i, f, o = s(.), g = r(tanh(.))        # s(z) = r(1 / r(1 + r(exp(-z))))
    c' = f * c + r(i * g)                 # c, c' float32
    h' = o * tanh(c')                     # float32, as every layer's output

The JAX package's Pallas step cannot run this (its stores are typed by
``xz``, so bfloat16 inputs fail to trace); the contract is the cell, which
``tests/test_torch_bf16.py`` holds the plain version to. The kernel has a
bfloat16 instance for it, and each wrapper picks the instance by
``xz.dtype``. That instance reads the gates from tables
(``ops/bf16_gates.py``), which :func:`gate_tables` builds on the card at
first use and keeps for the process, one buffer a device.

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

``launch_counts`` counts kernel launches per wrapper, the bfloat16
instance's under ``fused_lstm_step_bf16`` and ``lstm_layer_bf16``.
"""

import ctypes
import functools
import threading
from typing import List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from gordo_components_torch.ops import _cuda, bf16_gates
from gordo_components_torch.ops._cuda import LaunchCounts, check_tensor
from gordo_components_torch.ops.activations import resolve_activation, sigmoid

LayerWeights = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # Wi, Wh, b
Weights = Tuple[List[LayerWeights], Tuple[torch.Tensor, torch.Tensor]]

MAX_HIDDEN = 1024  # one kernel thread per (window, hidden unit)
WARP_MAX_HIDDEN = 32  # the warp path's widest pair: one lane per unit
N_SM = 132  # streaming multiprocessors of an H100 SXM
BLOCK_SMEM_BUDGET = 100 * 1024  # block path: two blocks still fit an SM
WARP_STAGES = 8  # the warp path's ring slots (the kernel is built for 8)

launch_counts = LaunchCounts("fused_lstm_step", "lstm_layer", "fused_lstm_step_bf16", "lstm_layer_bf16")
# the kernel's instances by the dtype of xz, Wh and b: (C entry, launch-count suffix)
_INSTANCES = {torch.float32: ("gordo_lstm_steps", ""), torch.bfloat16: ("gordo_lstm_steps_bf16", "_bf16")}
reset_launch_counts = launch_counts.reset
_kernel_fns = {}
_tables = {}  # device -> its gate tables
_tables_lock = threading.Lock()


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


def _gates(z, c):
    """``(c', h')`` from the pre-activations ``z`` (..., 4H) in the compute
    dtype and the float32 carry ``c``. In bfloat16 the gates round to
    bfloat16 (the sigmoid as XLA expands it, ``ops/activations.sigmoid``),
    ``i * g`` too, and the products with the float32 ``c`` and ``tanh(c')``
    promote to float32: the cell's rounding points."""
    i, f, g, o = z.chunk(4, dim=-1)
    c2 = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
    return c2, sigmoid(o) * torch.tanh(c2)


def lstm_step_plain(xz_t, h, c, Wh, b):
    """One recurrent step in plain PyTorch (the math of ``lstm_step_jnp``,
    or of the bfloat16 cell for bfloat16 ``xz_t``, ``Wh`` and ``b``): xz_t
    (B, M, 4H) precomputed input projection; h, c (B, M, H) float32; Wh
    (M, H, 4H); b (M, 4H). Returns float32 (c', h')."""
    hW = torch.bmm(h.to(Wh.dtype).transpose(0, 1), Wh).transpose(0, 1)
    if xz_t.dtype == torch.float32:
        z = xz_t + hW + b[None]
    else:
        z = xz_t + (hW + b[None])
    return _gates(z, c)


def lstm_layer_plain(xz, Wh, b):
    """A layer's steps from a zero state in plain PyTorch: xz (S, B, M, 4H)
    -> every step's h, (S, B, M, H) float32."""
    _, B, M, _ = xz.shape
    h = c = torch.zeros((B, M, Wh.shape[-2]), device=xz.device)
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
    tables: int  # bytes of the gate tables staged in shared memory (bfloat16; 0 for float32)
    smem_bytes: int  # dynamic shared memory a block, the tables included
    grid: Tuple[int, int]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def _launch_plan(B: int, M: int, H: int, elem_bytes: int = 4) -> LaunchPlan:
    """The kernel's launch plan for B windows, M members, width H, with
    ``xz``, ``Wh`` and ``b`` of ``elem_bytes`` bytes an element (4 for
    float32, 2 for bfloat16; ``h`` is float32 in both).

    Warp path (H <= 32): the B*M (window, member) pairs are flattened,
    next_pow2(H) lanes a pair, 32 // that pairs a warp; blocks of up to 4
    warps, fewer when the pairs would not give every SM a block; an 8-slot
    ring of the warp's slice of a step (at most 512 bytes a slot).

    Block path (H > 32): windows of one member a block, about 256 threads,
    the tile balanced over the windows; a ring of 8 slots (4 where 8 do not
    fit the budget) and ``Wh[m]`` in shared memory where it fits beside them.

    bfloat16 (the table design): the gate tables (``bf16_gates.TABLE_BYTES``)
    lead the shared memory of both paths; the warp path also keeps a float
    a thread after the rings, where the pairs exchange h, and the block path
    stages ``Wh[m]`` only where it fits beside the tables (a ring and h
    take at most 70 KB, so the tables always fit). Float32 plans have none.
    """
    f32 = 4
    tables = bf16_gates.TABLE_BYTES if elem_bytes == 2 else 0
    if H <= WARP_MAX_HIDDEN:
        group = 1 << (H - 1).bit_length()
        per_warp = 32 // group
        pairs = B * M
        warps = min(4, max(1, _cdiv(_cdiv(pairs, per_warp), N_SM)))
        tile = warps * per_warp
        smem = tables + elem_bytes * warps * WARP_STAGES * per_warp * 4 * H + (4 * 32 * warps if tables else 0)
        return LaunchPlan(group, tile, 32 * warps, WARP_STAGES, False, tables, smem,
                          (_cdiv(pairs, tile), 1))
    n_tiles = _cdiv(B, max(1, min(B, 256 // H)))
    tile = _cdiv(B, n_tiles)
    slot = elem_bytes * tile * 4 * H
    h_bytes = f32 * tile * H
    w_bytes = elem_bytes * H * 4 * H
    stages = 8 if tables + 8 * slot + h_bytes <= BLOCK_SMEM_BUDGET else 4
    stage_w = tables + stages * slot + h_bytes + w_bytes <= BLOCK_SMEM_BUDGET
    smem = tables + stages * slot + h_bytes + (w_bytes if stage_w else 0)
    return LaunchPlan(0, tile, 32 * _cdiv(tile * H, 32), stages, stage_w, tables, smem, (n_tiles, M))


def _kernel(entry: str):
    """A steps entry of ``csrc/lstm_step.cu``, argument types set: (xz, h0,
    c0, Wh, b, 12 ints, ys, c_out, stream), the bfloat16 instance's with
    (tables, table_bytes) after b."""
    fn = _kernel_fns.get(entry)
    if fn is None:
        fn = getattr(_cuda.load("lstm_step"), entry)
        p, i = ctypes.c_void_p, ctypes.c_int
        tables = [p, i] if entry == "gordo_lstm_steps_bf16" else []
        fn.argtypes = [p, p, p, p, p, *tables, *[i] * 12, p, p, p]
        fn.restype = ctypes.c_int
        _kernel_fns[entry] = fn
    return fn


def gate_tables(device: torch.device) -> torch.Tensor:
    """The bfloat16 gate tables on ``device`` (a CUDA device): int16
    ``bf16_gates.TABLE_WORDS``, the header written here and the entries by
    ``gordo_lstm_bf16_gate_tables`` with the kernel's own arithmetic, at the
    first call for the device; kept for the process."""
    device = torch.device(device)
    key = torch.cuda.current_device() if device.index is None else device.index
    with _tables_lock:
        tables = _tables.get(key)
        if tables is None:
            with torch.cuda.device(key):
                tables = torch.zeros(bf16_gates.TABLE_WORDS, dtype=torch.int16, device="cuda")
                tables[:bf16_gates.HEADER_WORDS] = torch.tensor(
                    bf16_gates.HEADER, dtype=torch.int32).view(torch.int16)
                build = _cuda.load("lstm_step").gordo_lstm_bf16_gate_tables
                build.argtypes, build.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
                stream = torch.cuda.current_stream()
                err = build(tables.data_ptr(), stream.cuda_stream)
                if err != 0:
                    raise RuntimeError(f"bf16 gate table build failed: cudaError {err}")
                stream.synchronize()  # every stream's launches read them
            _tables[key] = tables
        return tables


def _launch(xz, h0: Optional[torch.Tensor], c0: Optional[torch.Tensor], Wh, b):
    """Validate and launch S steps on the current stream with the kernel's
    instance for ``xz.dtype`` (float32 or bfloat16, which ``Wh`` and ``b``
    share; ``h0``, ``c0`` and the results are float32); returns (ys, c)."""
    if xz.dim() != 4:
        raise ValueError(f"xz must be (S, B, M, 4H), got {tuple(xz.shape)}")
    S, B, M, H4 = xz.shape
    H = H4 // 4
    if H4 != 4 * H or not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"gate width 4H={H4} needs 1 <= H <= {MAX_HIDDEN}")
    if not 1 <= M <= 65535:
        raise ValueError(f"members M={M} outside the kernel's grid (1..65535)")
    dev, f32, dt = xz.device, torch.float32, xz.dtype
    if dt not in _INSTANCES:
        raise TypeError(f"xz has dtype {dt}; the kernel has float32 and bfloat16 instances")
    check_tensor("xz", xz, dt, (S, B, M, H4), dev)
    check_tensor("Wh", Wh, dt, (M, H, H4), dev)
    check_tensor("b", b, dt, (M, H4), dev)
    for name, t in (("h", h0), ("c", c0)):
        if t is not None:
            check_tensor(name, t, f32, (B, M, H), dev)
    piece = 4 * xz.element_size()  # the kernel copies xz four elements at a time
    if xz.data_ptr() % piece:
        raise ValueError(f"xz must start on a {piece}-byte boundary (the kernel copies {piece}-byte pieces)")
    plan = _launch_plan(B, M, H, xz.element_size())
    tables = (gate_tables(dev).data_ptr(), plan.tables) if dt == torch.bfloat16 else ()
    ys = torch.empty((S, B, M, H), dtype=torch.float32, device=dev)
    c_out = torch.empty((B, M, H), dtype=torch.float32, device=dev)
    err = _kernel(_INSTANCES[dt][0])(
        xz.data_ptr(), None if h0 is None else h0.data_ptr(),
        None if c0 is None else c0.data_ptr(), Wh.data_ptr(), b.data_ptr(), *tables,
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
    launch_counts.add("fused_lstm_step" + _INSTANCES[xz_t.dtype][1])
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
    launch_counts.add("lstm_layer" + _INSTANCES[xz.dtype][1])
    return ys


def lstm_time_major_forward(
    weights: Weights, xb: torch.Tensor, funcs: Sequence[str], out_func: str = "linear",
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """LSTM-stack forward over member-stacked weights, computed in
    ``dtype`` (the input projection, the kernel's instance and the head;
    the layer outputs and their activations are float32).

    ``weights`` is ``(layers, (Wd, bd))`` as :func:`extract_lstm_weights`
    gives it, every tensor with a leading member axis M; ``funcs`` are the
    per-layer activations and ``out_func`` the head's. ``xb``: (M, B, T, F),
    each member's batch of windows (the bank passes (slots, windows,
    lookback, F)). Returns float32 (M, B, F): the head over the last
    layer's final hidden state."""
    layers, (Wd, bd) = weights
    if len(funcs) != len(layers):
        raise ValueError(f"{len(layers)} layers but {len(funcs)} activations")
    x = xb.permute(2, 1, 0, 3)  # (T, B, M, F), a view
    for (Wi, Wh, b), func in zip(layers, funcs):
        xz = torch.einsum("tbmf,mfg->tbmg", x.to(dtype), Wi.to(dtype)).contiguous()
        ys = lstm_layer(xz, Wh.to(dtype).contiguous(), b.to(dtype).contiguous())
        x = resolve_activation(func)(ys)
    out = torch.bmm(x[-1].transpose(0, 1).to(dtype), Wd.to(dtype)) + bd.to(dtype)[:, None, :]  # (M, B, F)
    return resolve_activation(out_func)(out).float()


def _train_step(xz_t, h, c, Wh, b=None):
    """One recurrent step for autograd, member-major: ``lstm_step_jnp``'s
    math with the bias already in ``xz_t`` (M, B, 4H) in float32; in
    bfloat16 the cell's, with ``b`` (M, 4H) added to the rounded hidden
    product. h, c (M, B, H) float32, Wh (M, H, 4H). Returns (c', h')."""
    if b is None:
        return _gates(torch.baddbmm(xz_t, h, Wh), c)
    return _gates(xz_t + (torch.bmm(h.to(Wh.dtype), Wh) + b[:, None]), c)


def lstm_train_forward(
    weights: Weights, xb: torch.Tensor, funcs: Sequence[str], out_func: str = "linear",
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The training forward: :func:`lstm_time_major_forward`'s function in
    PyTorch ops that autograd differentiates, never the kernel. The JAX
    package trains the same way: its fused step is forward-only and
    "training keeps the jnp step" (``gordo_components_tpu/ops/seq_scan.py:43-46``),
    ``lstm_time_major_forward(..., kernel="jnp")`` inside the gang epoch.

    ``xb`` (M, B, T, F) -> (M, B, F). Per layer one ``torch.baddbmm`` for
    every step's input projection and bias, then a loop over time whose
    step is one ``torch.baddbmm`` over (M, B, .) and the gates; the
    activation on the layer's outputs; the head on the last hidden state.
    In bfloat16 the input projection is a bare product and the bias joins
    the hidden product, at the cell's rounding points."""
    layers, (Wd, bd) = weights
    if len(funcs) != len(layers):
        raise ValueError(f"{len(layers)} layers but {len(funcs)} activations")
    M, B, T, _ = xb.shape
    x = xb.transpose(1, 2)  # (M, T, B, F)
    for (Wi, Wh, b), func in zip(layers, funcs):
        H = Wh.shape[-2]
        rows = x.reshape(M, T * B, -1)
        if dtype == torch.float32:
            xz, b = torch.baddbmm(b[:, None, :], rows, Wi), None
        else:
            xz, Wh, b = torch.bmm(rows.to(dtype), Wi.to(dtype)), Wh.to(dtype), b.to(dtype)
        xz = xz.view(M, T, B, 4 * H)
        h = c = torch.zeros((M, B, H), device=xz.device)
        ys = []
        for t in range(T):
            c, h = _train_step(xz[:, t], h, c, Wh, b)
            ys.append(h)
        x = resolve_activation(func)(torch.stack(ys, dim=1))
    if dtype == torch.float32:
        return resolve_activation(out_func)(torch.baddbmm(bd[:, None, :], x[:, -1], Wd))
    out = torch.bmm(x[:, -1].to(dtype), Wd.to(dtype)) + bd.to(dtype)[:, None, :]
    return resolve_activation(out_func)(out).float()
