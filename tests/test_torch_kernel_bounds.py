"""The port's redesigned kernels at the edges of their designs, on the CPU.

- The fused LSTM step's lane groups end at H = 32 (the warp path) and its
  block path starts at H = 33: the plain layer (which the CUDA kernel is
  held to on the card, in chip_smoke.py) is held to the JAX package's Pallas
  step in interpreter mode, chained over S steps from a zero state, at
  widths on both sides of those edges and at ragged B and M.
- The anomaly-score kernel (both entry points) picks lane groups of
  next_pow2(F) up to 32 lanes: the per-model plain version and its
  one-buffer layout are held to JAX's ``fused_anomaly_score(...,
  force="interpret")`` at F on both sides of 16 and 32; the banked packed
  result to JAX's ``banked_anomaly_score(..., mode="interpret")`` at F on
  both sides of every power of two up to 32 and past a warp, at one row and
  at the LSTM bank's 97 scored rows.
- The launch plans (computed in Python, checked again in C) are replayed
  thread by thread as the kernels map threads to work: K3's must cover
  every (window, member, unit) triple exactly once within the card's
  limits, the anomaly score's every (slot row, feature) pair, for F = 1..1024
  and T up to the bank's 8192 rows a call.

Bands, as the JAX suite states them: chained steps within rtol=1e-5,
atol=1e-6; diff and scaled bitwise, the two norms within rtol=atol=1e-6.
"""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gordo_components_torch.ops import score as port_score
from gordo_components_torch.ops import seq_scan as port_seq
from gordo_components_tpu.ops.pallas_score import banked_anomaly_score, fused_anomaly_score
from gordo_components_tpu.ops.seq_scan import fused_lstm_step

FORWARD_TOL = dict(rtol=1e-5, atol=1e-6)
NORM_TOL = dict(rtol=1e-6, atol=1e-6)
MAX_THREADS = 1024
MAX_SMEM = 232_448  # 227 KB: the most dynamic shared memory a block can have
MAX_GRID_Y = 65535


@pytest.mark.parametrize(
    "H,S,B,M", list(itertools.product((7, 16, 31, 32, 33), (1, 5, 33), (1, 3), (1, 3)))
)
def test_layer_plain_matches_chained_pallas_steps(H, S, B, M):
    rng = np.random.RandomState(H * 1000 + S * 10 + B + M)
    xz = rng.randn(S, B, M, 4 * H).astype("float32")
    Wh = (rng.randn(M, H, 4 * H) / np.sqrt(H)).astype("float32")
    b = (0.1 * rng.randn(M, 4 * H)).astype("float32")
    got = port_seq.lstm_layer(*map(torch.from_numpy, (xz, Wh, b))).numpy()
    h = c = jnp.zeros((B, M, H), jnp.float32)
    Whj, bj = jnp.asarray(Wh), jnp.asarray(b)
    for t in range(S):
        c, h = fused_lstm_step(jnp.asarray(xz[t]), h, c, Whj, bj, interpret=True)
        np.testing.assert_allclose(got[t], np.asarray(h), err_msg=f"step {t}", **FORWARD_TOL)
    assert got.shape == (S, B, M, H)


@pytest.mark.parametrize("F,rows", list(itertools.product((1, 16, 17, 32, 33), (1, 64))))
def test_fused_score_matches_pallas_interpret_at_lane_group_edges(F, rows):
    rng = np.random.RandomState(F * 100 + rows)
    target = rng.randn(rows, F).astype("float32")
    output = (target + 0.1 * rng.randn(rows, F)).astype("float32")
    shift = (0.01 * rng.randn(F)).astype("float32")
    scale = (1.0 + rng.rand(F)).astype("float32")
    want = [np.asarray(a) for a in
            fused_anomaly_score(target, output, shift, scale, force="interpret")]
    args = [torch.from_numpy(a) for a in (target, output, shift, scale)]
    packed = port_score.fused_anomaly_score_packed(*args)
    assert packed.shape == (2 * rows * (F + 1),)
    for got in (port_score.fused_anomaly_score(*args),
                port_score.unpack_scores(packed, rows, F)):
        for g, w, name in zip(got[:2], want[:2], ("diff", "scaled")):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        for g, w, name in zip(got[2:], want[2:], ("tot_u", "tot_s")):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g.numpy(), w, err_msg=name, **NORM_TOL)


@pytest.mark.parametrize(
    "F,T", list(itertools.product((1, 2, 3, 5, 8, 9, 16, 17, 31, 32, 33, 130), (1, 97)))
)
def test_banked_packed_matches_pallas_interpret_at_lane_group_edges(F, T):
    B, M = 3, 4
    rng = np.random.RandomState(F * 1000 + T)
    target = rng.randn(B, T, F).astype("float32")
    output = (target + 0.1 * rng.randn(B, T, F)).astype("float32")
    shift_bank = (0.01 * rng.randn(M, F)).astype("float32")
    scale_bank = (1.0 + rng.rand(M, F)).astype("float32")
    idx = np.asarray([3, 0, 3], np.int32)
    args = (target, output, shift_bank, scale_bank, idx)
    want = [np.asarray(a) for a in banked_anomaly_score(*args, mode="interpret")]
    packed = port_score.banked_anomaly_score_packed(*map(torch.from_numpy, args))
    assert packed.shape == (B, 3 * T * F + 2 * T)
    copy, *got = port_score.unpack_banked(packed, T, F)
    np.testing.assert_array_equal(copy.numpy(), output)
    for g, w, name in zip(got[:2], want[:2], ("diff", "scaled")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    for g, w, name in zip(got[2:], want[2:], ("tot_u", "tot_s")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **NORM_TOL)


SCORE_T = (1, 7, 64, 97, 129, 8192)  # 8192: the bank's max_rows_per_call


@functools.lru_cache(maxsize=None)
def _score_rows_covered(T, group, tile, grid_x):
    """How many lane groups of the anomaly-score kernel own each of a slot's
    T rows, replaying its mapping: warp w of block x owns rows from
    (x * 8 + w) * (32 // group), one a lane group, and leaves whole when
    its first row is past T."""
    warps = port_score.THREADS // 32
    tid = np.arange(port_score.THREADS)
    t0 = (np.arange(grid_x)[:, None] * warps + tid // 32) * (32 // group)
    t = t0 + (tid % 32) // group
    owner = (t0 < T) & (t < T) & ((tid % 32) % group == 0)
    return np.bincount(t[owner], minlength=T)


@pytest.mark.parametrize("T", SCORE_T)
def test_score_launch_plan_covers_every_row_and_feature(T):
    """Every (row, feature) of a slot is owned by exactly one lane, for
    F = 1..1024: rows by lane groups, features by a group's lanes striding
    by the group; groups are powers of two within a warp, so the norms'
    xor shuffles stay inside a row. The kernel takes no shared memory."""
    for F in range(1, 1025):
        plan = port_score._launch_plan(T, F)
        group, tile, grid_x = plan
        assert group & (group - 1) == 0 and min(F, 32) <= group <= 32, (F, plan)
        assert tile == port_score.THREADS // group
        assert grid_x * tile >= T > (grid_x - 1) * tile  # no empty block
        lanes = np.arange(group)[:, None] + group * np.arange(-(-F // group))[None, :]
        assert (np.bincount(lanes[lanes < F], minlength=F) == 1).all(), (F, plan)
        rows = _score_rows_covered(T, *plan)
        assert rows.size == T and (rows == 1).all(), (T, F, plan)


def _covered(plan, B, M, H):
    """How many threads of the plan's launch own each (window, member, unit)
    triple, indexed ((b * M + m) * H + u), replaying the kernel's mapping."""
    P = B * M
    gx, gy = plan.grid
    tid = np.arange(plan.threads)[None, :]
    if plan.group:  # warp path: pairs flattened, `group` lanes a pair
        per_warp = 32 // plan.group
        p0 = (np.arange(gx)[:, None] * (plan.threads // 32) + tid // 32) * per_warp
        g, u = (tid % 32) // plan.group, (tid % 32) % plan.group
        pair = p0 + g
        active = (p0 < P) & (g < np.minimum(per_warp, P - p0)) & (u < H)
    else:  # block path: `tile` windows of member blockIdx.y a block
        bx = np.arange(gx)[:, None, None]
        by = np.arange(gy)[None, :, None]
        wl, u = tid[None] // H, tid[None] % H
        win = bx * plan.tile + wl
        pair = win * M + by
        active = (wl < plan.tile) & (win < B)
        pair, u, active = np.broadcast_arrays(pair, u, active)
    u = np.broadcast_to(u, pair.shape)
    return np.bincount((pair * H + u)[active], minlength=P * H)


def _check_plan(B, M, H):
    plan = port_seq._launch_plan(B, M, H)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= MAX_THREADS
    assert plan.smem_bytes <= MAX_SMEM and plan.grid[1] <= MAX_GRID_Y
    assert plan.stages in (4, 8)
    ring = 4 * plan.stages * plan.tile * 4 * H  # the ring's bytes a block
    if plan.group:
        assert H <= plan.group <= 32 and plan.group & (plan.group - 1) == 0
        assert plan.threads <= 128 and plan.grid[1] == 1 and plan.stages == 8
        assert plan.tile == (plan.threads // 32) * (32 // plan.group)
        assert plan.smem_bytes >= ring
    else:
        assert H > port_seq.WARP_MAX_HIDDEN
        assert plan.tile * H <= plan.threads and plan.grid[1] == M
        assert plan.smem_bytes >= ring + 4 * plan.tile * H + (16 * H * H if plan.stage_w else 0)
    counts = _covered(plan, B, M, H)
    assert counts.size == B * M * H and (counts == 1).all(), (B, M, H, plan)


@pytest.mark.parametrize("B,M", [(1, 1), (3, 7), (97, 1), (2, 3)])
def test_launch_plan_covers_every_width(B, M):
    for H in range(1, port_seq.MAX_HIDDEN + 1):
        _check_plan(B, M, H)


@pytest.mark.parametrize("H", [1, 5, 7, 8, 16, 31, 32, 33, 64, 130, 512])
def test_launch_plan_covers_the_bank_shape(H):
    """The LSTM bank's full batch (97 windows of a 128-row request, 64
    slots) and the dense bank's slot count (64 of 1 window)."""
    _check_plan(97, 64, H)
    _check_plan(1, 64, H)


def test_bank_shape_plan_fills_the_card():
    """At (B, M, H) = (97, 64, 8): 8 lanes a pair, 16 pairs a block, 388
    blocks (about 3 for each of 132 SMs) and at most 3 idle pairs."""
    plan = port_seq._launch_plan(97, 64, 8)
    assert (plan.group, plan.tile, plan.threads, plan.stages) == (8, 16, 128, 8)
    assert plan.grid == (388, 1) and plan.grid[0] * plan.tile - 97 * 64 <= 3


def test_layer_refuses_misaligned_xz():
    S, B, M, H = 2, 3, 2, 5
    flat = torch.zeros(S * B * M * 4 * H + 1)
    xz = flat[1:].view(S, B, M, 4 * H)  # 4 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        port_seq._launch(xz, None, None, torch.zeros(M, H, 4 * H), torch.zeros(M, 4 * H))
