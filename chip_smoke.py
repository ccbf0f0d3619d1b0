#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the exit code is non-zero):

1. card     torch/CUDA versions and ``nvidia-smi`` name and power limit;
2. build    compile the CUDA kernels (``gordo_components_torch/ops/csrc``)
            with nvcc for sm_90a, one nvcc per source, all at once; each
            library's kernels, most registers and most local-memory
            (spill) bytes a thread, by cuobjdump;
3. parity   hold each kernel against its plain PyTorch version on the card.
            Banked anomaly score (K2): its packed result at the serving
            shapes (B=64, F=10, M=10000, T=64 dense and 97 LSTM), ragged
            shapes, one 8192-row slot, a slot width that is not a multiple
            of 4 and lane-group edges (F = 1..130 at T = 64 and 97): output
            copy, diff and scaled bitwise, norms within rtol=atol=1e-6; its
            device time at both serving shapes and at B=T=1 (floor_us).
            Per-model anomaly score (K1): the serving shape's one request
            and ragged shapes, same bands. For both, device operations per
            call (at most 1, asserted) and the host time of each piece of
            the wrapper. Fused LSTM step (K3): one step
            (S=1) within rtol=atol=1e-6 and an S-step layer within
            rtol=1e-5, atol=1e-6, at the serving shape (S=32, B=97 windows,
            M=64 slots, H=8), ragged H, B and M, and the edges of its
            design (H = 7, 16, 31, 32, 33 at S = 1, 5, 33, and 97 windows
            of one member), and the shapes training and building give it
            (128 windows of 1,024 members at H = 8, 7, 5; one member's 128
            and 1,409 windows; the build's lookbacks 10, 12, 16 at its gang
            widths and H down to 1); its reciprocal bitwise against the IEEE
            division over every float in [1, 2^126); each lstm_hourglass
            layer's device time at the serving shape against its bound; both
            K3 wrappers refuse a CUDA input that requires grad (the kernel has
            no backward). Each kernel, its plain version
            and a library expression are timed with CUDA events;
4. train    FleetTrainer at the reference bench's fleet width (1,024
            members x 1,440 rows x 10 tags, feedforward_hourglass, 5 epochs,
            batch 128, float32) on the card: a warm fit, then a timed fit of
            the same shapes; models/hour, the fit's wall seconds, per-epoch
            seconds; the device operations of one training step and the
            device's busy share of one epoch (profiler); the share of members
            whose loss fell from epoch 1 to epoch 5 (at least 0.99);
5. train_parity  an 8-member fleet (256 rows, one batch an epoch, 3 epochs)
            from the same initial parameters fitted on the card and on the
            CPU: parameters, losses, error scalers and thresholds within
            TRAIN_RTOL/TRAIN_ATOL (the band tests/test_torch_fleet.py holds
            the port to against the JAX package);
   seq_train  the reference bench's config 2 as one fit: LSTMAutoEncoder
            (lstm_hourglass, lookback 32, 5 epochs, batch 128) on one member
            of the bench's fleet (1,440 rows x 10 tags, float32): a warm
            1-epoch fit, then the timed fit (models/hour, fit and epoch
            seconds, the loss falling from epoch 1 to 5); then the single
            build's detector fit of that estimator, whose predict runs K3 (its
            launches); a fit with a validation split of 0.2 and early
            stopping, whose K3 launches must be exactly its validation
            passes' (epochs run x validation batches x layers: the training
            steps launch none); one training step's device operations and
            host launch time, and the device's busy share of one epoch
            (profiler);
   seq_fleet  FleetTrainer of the same model at the bench's fleet width
            (SEQ_FLEET_MEMBERS x 1,440 rows x 10 tags): a warm 1-epoch fit,
            then the timed 5-epoch fit: models/hour, fit and epoch seconds,
            peak device memory, K3 launches of the error pass (two passes,
            every batch, every layer), the share of members whose loss fell
            (at least 0.99), step device operations and epoch busy share;
   seq_train_parity  8 LSTM members of ragged rows, one batch an epoch, 3
            epochs, from the same initial parameters on the card and on the
            CPU, at q = 1, at q = 0.99, and at q = 1 with a validation split
            and early stopping (patience 1, a min_delta no epoch beats: all
            stop after epoch 2 and restore epoch 1), then one member's
            single fit with the same validation and early stopping:
            parameters (restored ones), losses, validation losses, input and
            error scalers and q = 1 thresholds within LSTM_RTOL/LSTM_ATOL,
            q = 0.99 histogram thresholds within two bins;
6. http     serve a four-bucket directory of port artifacts with
            ``run_server``: 64 feedforward detectors at 10 tags, 8 at 40, and
            8 ``LSTMAutoEncoder`` + 4 ``LSTMForecast`` detectors
            (``lstm_hourglass``, 10 tags, lookback 32). Concurrent
            anomaly/prediction POSTs (64 rows feedforward, 128 rows LSTM),
            each held against the port's plain computation on the CPU, with
            the LSTM responses' index trimmed by the warm-up offset; a bad
            body (400), a request within the warm-up (400), an unknown target
            (404); the detectors' ``anomaly()`` on the card;
7. bank     10,000 feedforward hourglass members at 10 tags scored by 64
            clients x 4 requests x 64 rows through BatchingEngine(max_batch=64,
            flush_ms=2.0): latency, rows/s, average batch; then one full
            batch of 64 requests alone: its host wall time against its
            device time (profiler), and the costliest device operations;
8. lstm     the same for 10,000 ``lstm_hourglass`` members (10 tags,
            lookback 32) and 128-row requests (97 scored rows each), with the
            fused-LSTM-step launches per batch;
9. build    ``build_fleet`` on the card: 64 RandomDataset machines with the
            default model config (10 tags, 7 days at 10 min), one bespoke
            machine (a bare AutoEncoder: the single-build path), the
            ``turbine-lstm`` machine of examples/fleet.yaml (2 tags, lookback
            12, 5 epochs), 4 LSTMAutoEncoder and 2 LSTMForecast machines at
            the default estimator config (three LSTM gangs), one bespoke LSTM
            detector (single build) and two configs that are not detectors (a
            bare Pipeline, a bare AutoEncoder) into a temporary directory: 73
            built, the two others failed with NotImplementedError; the
            directory served by a ModelBank and BatchingEngine, each machine's
            training rows scored as one request (K2, and K3 for LSTM buckets)
            and by ``serializer.load(dir).anomaly`` (K1, and K3), the two held
            together within the http phase's band; no scaled training error
            above its threshold (q = 1) beyond that band;
10. counts  the three main-path wrappers' launch counters of every path
            (train, seq_train, seq_fleet, http, bank, lstm, build), each reset
            just before its path and read just after; each kernel's total
            must be above 0.

Then one JSON line with every kernel's numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Exits non-zero without
CUDA. Weights and data are random, made from fixed seeds.
"""

import ctypes
import functools
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from gordo_components_torch import resolve_device, serializer
from gordo_components_torch.builder import build_fleet
from gordo_components_torch.convert import entry_from_numpy, lstm_to_flax
from gordo_components_torch.dataset import get_dataset
from gordo_components_torch.models import (
    DiffBasedAnomalyDetector,
    LSTMAutoEncoder,
    lookup_factory,
    train_core,
)
from gordo_components_torch.models.factories.feedforward import hourglass_calc_dims
from gordo_components_torch.models.transformers import MinMaxScaler, Pipeline
from gordo_components_torch.ops import _cuda, score, seq_scan
from gordo_components_torch.parallel import FleetTrainer, quantize_batch_count
from gordo_components_torch.server import BatchingEngine, ModelBank, run_server
from gordo_components_torch.server.model_io import ModelCollection
from gordo_components_torch.workflow import Machine

ROOT = os.path.dirname(os.path.abspath(__file__))
MODEL_DIR = os.path.join(ROOT, "build", "chip_smoke_models")
FLEET_DIR = os.path.join(ROOT, "build", "chip_smoke_fleet")
# the reference bench's fleet (bench.py bench_fleet; BASELINE.json config 3)
FLEET_SHAPE = dict(n_models=1024, rows=1440, n_features=10)
FLEET_CONFIG = dict(kind="feedforward_hourglass", epochs=5, batch_size=128)
# card vs CPU after three Adam steps from the same parameters: the band
# tests/test_torch_fleet.py holds the port's FleetTrainer to against JAX's
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
NORM_RTOL = NORM_ATOL = 1e-6  # the JAX package's band for the two norms
E2E_ATOL = 1e-5  # card vs CPU: matmul accumulation order and tanh differ in the last bits
# LSTM card vs CPU: the JAX suite's band for the time-major scan against the
# per-member layout (tests/test_seq_fastpath.py)
LSTM_RTOL, LSTM_ATOL = 1e-4, 1e-5
STEP_RTOL = STEP_ATOL = 1e-6  # one fused LSTM step (the JAX suite's band)
LAYER_RTOL, LAYER_ATOL = 1e-5, 1e-6  # 32 chained steps (ditto)
SERVE_SHAPE = (64, 64, 10, 10000)  # B, T, F, M of a full coalesced batch
RAGGED = [(3, 261, 130, 5), (1, 7, 3, 1), (8, 16, 257, 16)]
K2_LSTM_SHAPE = (64, 97, 10, 10000)  # the LSTM bank's full batch: 97 scored rows a slot
# K2's packed result: the serving shapes and ragged ones, one slot of
# max_rows_per_call rows, a slot width (3*T*F + 2*T = 77) that is not a
# multiple of 4, and lane groups on both sides of each power of two up to 32
# (and past a warp), at 64 and 97 rows
K2_SHAPES = ([SERVE_SHAPE, K2_LSTM_SHAPE, *RAGGED, (1, 8192, 10, 1), (5, 7, 3, 4)]
             + [(4, n, f, 6) for f in (1, 2, 3, 5, 8, 9, 16, 17, 31, 32, 33, 130)
                for n in (64, 97)])
LOOKBACK = 32
# the reference bench's config 2 (bench.py bench_sequence_models) in float32,
# 5 epochs; as a fleet at the bench's fleet width
SEQ_CONFIG = dict(kind="lstm_hourglass", lookback_window=LOOKBACK, batch_size=128)
SEQ_EPOCHS = 5
SEQ_FLEET_MEMBERS = 1024
QUANTILE_BINS = 8192  # the sequence error pass's histogram bins
# (S, B, M, H) of the LSTM bank's full batch: 32 steps, 97 windows of a
# 128-row request, 64 slots, the widest hourglass layer; then ragged shapes
LSTM_SERVE = (LOOKBACK, 97, 64, 8)
LSTM_RAGGED = [(LOOKBACK, 1, 1, 5), (LOOKBACK, 3, 7, 37), (LOOKBACK, 200, 1, 64),
               (LOOKBACK, 3, 7, 130), (LOOKBACK, 1, 7, 512), (LOOKBACK, 200, 7, 512)]
# the edges of K3's design: lane groups of next_pow2(H) up to H = 32 (warp
# path), the block path from H = 33; S = 1, 5 and 33 steps (33 passes the
# 8-slot ring several times); 97 windows of one member
LSTM_EDGES = [(S, B, M, H) for H in (7, 16, 31, 32, 33)
              for S, B, M in ((1, 3, 5), (5, 2, 3), (33, 97, 1))]
# the shapes training and building give K3: seq_fleet's error passes (a
# batch of 128 windows of 1,024 members, every hourglass width), seq_train's
# validation batches and its detector's predict (128 and 1,409 windows of
# one member), and the build's gangs and single builds (lookbacks 10, 12 and
# 16, batch 100, 4 and 2 members; turbine-lstm's widths 2 and 1 at 2 tags; a
# bespoke detector's predict over 992 windows)
LSTM_TRAIN = ([(LOOKBACK, 128, 1024, H) for H in (8, 7, 5)]
              + [(LOOKBACK, 128, 1, 8), (LOOKBACK, 1409, 1, 8), (10, 100, 4, 8), (10, 100, 2, 7),
                 (12, 100, 4, 8), (12, 100, 1, 2), (12, 100, 1, 1), (16, 992, 1, 5)])
HOURGLASS_WIDTHS = (8, 7, 5, 5, 7, 8)  # lstm_hourglass's layers at 10 tags
KERNELS = {
    "banked_anomaly_score": "gordo_components_tpu/ops/pallas_score.py:298",
    "fused_anomaly_score": "gordo_components_tpu/ops/pallas_score.py:84",
    "lstm_layer": "gordo_components_tpu/ops/seq_scan.py:218",
}
SOURCE = "gordo_components_torch/ops/csrc/anomaly_score.cu"
LSTM_SOURCE = "gordo_components_torch/ops/csrc/lstm_step.cu"


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def resource_usage(libs) -> dict:
    """library -> (kernels, most registers a thread, most local-memory
    bytes a thread: spills) from ``cuobjdump --dump-resource-usage``, or
    "not measured" where the tool or its output is missing."""
    cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    out = {name: "not measured" for name in libs}
    if not os.path.exists(cuobjdump):
        return out
    for name, lib in sorted(libs.items()):
        proc = subprocess.run([cuobjdump, "--dump-resource-usage", str(lib)],
                              capture_output=True, text=True, timeout=120)
        use = [(int(r), int(l)) for r, l in re.findall(r"REG:(\d+) .*?LOCAL:(\d+)", proc.stdout)]
        out[name] = ((len(use), max(r for r, _ in use), max(l for _, l in use)) if use
                     else "not measured")
    return out


def card_clocks() -> str:
    """The card's SM clock, power draw and temperature now (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ #
# phase 3: kernels against their plain versions
# ------------------------------------------------------------------ #


def make_case(B, T, F, M, seed):
    g = torch.Generator().manual_seed(seed)
    target = torch.randn(B, T, F, generator=g)
    output = target + 0.1 * torch.randn(B, T, F, generator=g)
    shift = 0.01 * torch.randn(M, F, generator=g)
    scale = 1.0 + torch.rand(M, F, generator=g)
    idx = torch.randint(0, M, (B,), generator=g, dtype=torch.int32)
    return [a.cuda() for a in (target, output, shift, scale, idx)]


def compare(got, want, what: str) -> float:
    for g, w, name in zip(got[:2], want[:2], ("diff", "scaled")):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{what}: {name} is not bitwise equal to the plain version")
    err = 0.0
    for g, w, name in zip(got[2:], want[2:], ("tot_u", "tot_s")):
        if not torch.allclose(g, w, rtol=NORM_RTOL, atol=NORM_ATOL):
            raise AssertionError(f"{what}: {name} outside rtol=atol=1e-6")
        err = max(err, float((g - w).abs().max()))
    return err


def library_banked(target, output, shift_bank, scale_bank, idx):
    """The epilogue as one PyTorch expression (yardstick only)."""
    diff = (target - output).abs()
    scaled = (diff - shift_bank[idx.long()][:, None]) * scale_bank[idx.long()][:, None]
    return diff, scaled, torch.linalg.vector_norm(diff, dim=-1), torch.linalg.vector_norm(scaled, dim=-1)


def library_fused(target, output, shift, scale):
    diff = (target - output).abs()
    scaled = (diff - shift) * scale
    return diff, scaled, torch.linalg.vector_norm(diff, dim=-1), torch.linalg.vector_norm(scaled, dim=-1)


def packed_plain(target, output, shift_bank, scale_bank, idx):
    """The banked epilogue's packed result from its plain version."""
    B = target.shape[0]
    plain = score.banked_score_plain(target, output, shift_bank, scale_bank, idx)
    return torch.cat([a.reshape(B, -1) for a in (output, *plain)], dim=1)


def library_packed(target, output, shift_bank, scale_bank, idx):
    """The packed result as one PyTorch expression and a cat (yardstick
    only)."""
    B = target.shape[0]
    parts = library_banked(target, output, shift_bank, scale_bank, idx)
    return torch.cat([a.reshape(B, -1) for a in (output, *parts)], dim=1)


def compare_packed(buf, args, what: str) -> float:
    """The packed result against the plain version: the output copy, diff
    and scaled bitwise, the norms within rtol=atol=1e-6."""
    target, output = args[:2]
    B, T, F = target.shape
    if buf.shape != (B, 3 * T * F + 2 * T):
        raise AssertionError(f"{what}: packed shape {tuple(buf.shape)}")
    copy, *got = score.unpack_banked(buf, T, F)
    if not torch.equal(copy, output):
        raise AssertionError(f"{what}: the output copy is not bitwise equal to the output")
    return compare(got, score.banked_score_plain(*args), what)


def host_us(fn, n=1000) -> float:
    """Mean host time of one call, perf_counter_ns over n calls."""
    for _ in range(50):
        fn()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    us = (time.perf_counter_ns() - t0) / n / 1e3
    torch.cuda.synchronize()
    return round(us, 3)


def host_split(pieces) -> dict:
    """Where a wrapper's host time goes: each piece timed alone
    (perf_counter_ns over 1,000 calls each)."""
    return {k: host_us(f) for k, f in pieces.items()}


def k1_pieces(single):
    tgt, out, sh, sc = single
    rows, F = tgt.shape
    dev, f32, index = tgt.device, torch.float32, tgt.get_device()
    buf = torch.empty(2 * rows * (F + 1), dtype=f32, device=dev)
    stream, one, counts = torch.cuda.current_stream(dev).cuda_stream, score._one(), _cuda.LaunchCounts("k")
    plan = score._launch_plan(rows, F)
    return {
        "checks_x4": lambda: [t.shape != w or t.dtype != f32 or t.device != dev
                              or not t.is_contiguous() for t, w in (
                                  (tgt, tgt.shape), (out, tgt.shape), (sh, (F,)), (sc, (F,)))],
        "empty_x1": lambda: torch.empty(2 * rows * (F + 1), dtype=f32, device=dev),
        "plan_lookup": lambda: score._launch_plan(rows, F),
        "stream_of_index": lambda: torch.cuda.current_stream(index).cuda_stream,
        "ctypes_launch_11_args": lambda: one(tgt.data_ptr(), out.data_ptr(), sh.data_ptr(),
                                             sc.data_ptr(), rows, F, *plan, buf.data_ptr(), stream),
        "launch_counter": lambda: counts.add("k"),
        "unpack_views": lambda: score.unpack_scores(buf, rows, F),
        "whole": lambda: score.fused_anomaly_score(*single),
    }


def k2_pieces(args):
    tgt, out, sh, sc, ix = args
    B, T, F = tgt.shape
    M = sh.shape[0]
    dev, f32, index = tgt.device, torch.float32, tgt.get_device()
    buf = torch.empty((B, 3 * T * F + 2 * T), dtype=f32, device=dev)
    stream, banked = torch.cuda.current_stream(dev).cuda_stream, score._banked()
    counts = _cuda.LaunchCounts("k")
    plan = score._launch_plan(T, F)
    return {
        "checks_x5": lambda: [t.shape != w or t.dtype != d or t.device != dev
                              or not t.is_contiguous() for t, d, w in (
                                  (tgt, f32, tgt.shape), (out, f32, tgt.shape), (sh, f32, (M, F)),
                                  (sc, f32, (M, F)), (ix, torch.int32, (B,)))],
        "empty_x1": lambda: torch.empty((B, 3 * T * F + 2 * T), dtype=f32, device=dev),
        "plan_lookup": lambda: score._launch_plan(T, F),
        "stream_of_index": lambda: torch.cuda.current_stream(index).cuda_stream,
        "ctypes_launch_13_args": lambda: banked(
            tgt.data_ptr(), out.data_ptr(), sh.data_ptr(), sc.data_ptr(), ix.data_ptr(), B, T, F,
            *plan, buf.data_ptr(), stream),
        "launch_counter": lambda: counts.add("k"),
        "whole": lambda: score.banked_anomaly_score_packed(*args),
    }


def device_ops_per_call(fn, args, runs=50) -> float:
    """Device operations (kernels, fills, copies) per call, from the
    profiler's trace of ``runs`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn(*args)
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events()) / runs


def time_ms(fn, args, warmup=20, runs=100) -> float:
    """Median over ``runs`` calls of CUDA-event time around one call."""
    for _ in range(warmup):
        fn(*args)
    pairs = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def kernel_device_us(fn, args, runs=50, kernel="score_rows", attempts=2):
    """Average device time of the named CUDA kernel itself, from the
    profiler's CUDA trace; a trace that holds no device time for it (the
    profiler can drop a trace's device events) is taken again, and None is
    returned when every attempt's trace lacks it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn(*args)
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            if kernel in evt.key:
                us = getattr(evt, "device_time", None) or getattr(evt, "cuda_time", None)
                if us:
                    return round(us, 3)
    return None


def bound_ms(B, T, F, idx=None) -> float:
    """Least time for the epilogue on this card: every input byte read once
    and every output byte written once, against ~8 float32 operations per
    element. Banked (idx given): target, output, idx and the scaler rows
    this idx gathers in, the packed result (output copy, diff, scaled, two
    norms) out; per model (idx None): target, output and one scaler row
    pair in, diff, scaled and the norms out."""
    if idx is None:
        moved = 4 * (2 * T * F + 2 * F) + 4 * (2 * T * F + 2 * T)
    else:
        rows = len(torch.unique(idx))
        moved = 4 * (2 * B * T * F + B + 2 * rows * F) + 4 * (3 * B * T * F + 2 * B * T)
    ops = 8 * B * T * F + 2 * B * T
    return max(moved / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S) * 1e3


def kernel_phase():
    results = {}
    B, T, F, M = SERVE_SHAPE
    # K2: the packed result at every shape of K2_SHAPES
    err = 0.0
    for i, shape in enumerate(K2_SHAPES):
        args = make_case(*shape, seed=i)
        buf = score.banked_anomaly_score_packed(*args)
        torch.cuda.synchronize()
        err = max(err, compare_packed(buf, args, "banked {}x{}x{}x{}".format(*shape)))
    args = make_case(B, T, F, M, seed=99)
    bound = bound_ms(B, T, F, args[4])
    k2 = results["banked_anomaly_score"] = {
        "name": "banked_anomaly_score", "route": "cuda", "source": SOURCE,
        "replaces": KERNELS["banked_anomaly_score"], "launches": None, "max_abs_err": err,
        "ms": time_ms(score.banked_anomaly_score_packed, args),
        "plain_ms": time_ms(packed_plain, args), "bound_ms": bound, "bound_by": "bytes",
        "library_ms": time_ms(library_packed, args),
    }
    ops = device_ops_per_call(score.banked_anomaly_score_packed, args)
    # at most one device operation a call (the profiler may drop an event,
    # never add one)
    if ops > 1.0:
        raise AssertionError(f"banked_anomaly_score makes {ops} device operations a call, more than 1")
    lstm_args = make_case(*K2_LSTM_SHAPE, seed=98)
    phase("parity", kernel="banked_anomaly_score", shapes=len(K2_SHAPES),
          bitwise="output_copy,diff,scaled", max_norm_err=err,
          kernel_device_us=kernel_device_us(score.banked_anomaly_score_packed, args),
          lstm_shape_device_us=kernel_device_us(score.banked_anomaly_score_packed, lstm_args),
          lstm_shape_bound_us=round(bound_ms(*K2_LSTM_SHAPE[:3], lstm_args[4]) * 1e3, 4),
          floor_us=kernel_device_us(score.banked_anomaly_score_packed, make_case(1, 1, F, 1, seed=97)),
          device_ops_per_call=ops, ms=round(k2["ms"], 5), plain_ms=round(k2["plain_ms"], 5),
          library_ms=round(k2["library_ms"], 5), below_library=k2["ms"] < k2["library_ms"],
          bound_ms=round(bound, 6), host_us=json.dumps(host_split(k2_pieces(args))))
    # K1: one detector's request at the serving shapes, then ragged ones
    err = 0.0
    for i, (b, t, f, m) in enumerate([SERVE_SHAPE, *RAGGED]):
        tgt, out, sh, sc, ix = make_case(b, t, f, m, seed=i)
        m0 = int(ix[0])
        single = (tgt[0].contiguous(), out[0].contiguous(), sh[m0].contiguous(), sc[m0].contiguous())
        got = score.fused_anomaly_score(*single)
        torch.cuda.synchronize()
        err = max(err, compare(got, score.score_plain(*single), f"fused {t}x{f}"))
    tgt, out, sh, sc, ix = args
    single = (tgt[0].contiguous(), out[0].contiguous(), sh[int(ix[0])].contiguous(),
              sc[int(ix[0])].contiguous())
    bound = bound_ms(1, T, F)
    k1 = results["fused_anomaly_score"] = {
        "name": "fused_anomaly_score", "route": "cuda", "source": SOURCE,
        "replaces": KERNELS["fused_anomaly_score"], "launches": None, "max_abs_err": err,
        "ms": time_ms(score.fused_anomaly_score, single),
        "plain_ms": time_ms(score.score_plain, single), "bound_ms": bound, "bound_by": "bytes",
        "library_ms": time_ms(library_fused, single),
    }
    ops = device_ops_per_call(score.fused_anomaly_score, single)
    if ops > 1.0:
        raise AssertionError(f"fused_anomaly_score makes {ops} device operations a call, more than 1")
    phase("parity", kernel="fused_anomaly_score", shapes=1 + len(RAGGED), bitwise="diff,scaled",
          max_norm_err=err, kernel_device_us=kernel_device_us(score.fused_anomaly_score, single),
          device_ops_per_call=ops, ms=round(k1["ms"], 5), plain_ms=round(k1["plain_ms"], 5),
          library_ms=round(k1["library_ms"], 5), below_library=k1["ms"] < k1["library_ms"],
          bound_ms=round(bound, 7), host_us=json.dumps(host_split(k1_pieces(single))))
    return results


def lstm_case(S, B, M, H, seed):
    """Inputs of S LSTM steps at the scale of a fitted stack: xz (S, B, M,
    4H), h, c (B, M, H), Wh (M, H, 4H) with columns of unit variance, b
    (M, 4H)."""
    g = torch.Generator().manual_seed(seed)
    xz = torch.randn(S, B, M, 4 * H, generator=g)
    h = torch.tanh(torch.randn(B, M, H, generator=g))
    c = torch.randn(B, M, H, generator=g)
    Wh = torch.randn(M, H, 4 * H, generator=g) / H ** 0.5
    b = 0.1 * torch.randn(M, 4 * H, generator=g)
    return [a.cuda() for a in (xz, h, c, Wh, b)]


def library_step(xz_t, h, c, Wh, b):
    """One step as one torch.baddbmm plus the gate expression (yardstick
    only), in the (M, B, .) layout baddbmm wants."""
    z = torch.baddbmm(xz_t.transpose(0, 1), h.transpose(0, 1), Wh) + b[:, None, :]
    i, f, g, o = z.chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * c.transpose(0, 1) + torch.sigmoid(i) * torch.tanh(g)
    return c2.transpose(0, 1), (torch.sigmoid(o) * torch.tanh(c2)).transpose(0, 1)


def library_layer(xz, Wh, b):
    """A layer as S library steps from a zero state (yardstick only)."""
    S, B, M, H4 = xz.shape
    h = c = xz.new_zeros((B, M, H4 // 4))
    ys = []
    for t in range(S):
        c, h = library_step(xz[t], h, c, Wh, b)
        ys.append(h)
    return torch.stack(ys)


def lstm_bound(S, B, M, H):
    """Least time for S fused steps on this card, and what bounds it: xz, Wh
    and b read once, every step's h and the final c written once; per
    (step, window, member) 8H^2 operations for the product, 8H for the two
    additions and about 24H for the gates and the carry update."""
    moved = 4 * (S * B * M * 4 * H + M * H * 4 * H + M * 4 * H) + 4 * (S * B * M * H + B * M * H)
    ops = S * B * M * (8 * H * H + 32 * H)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def close(got, want, rtol, atol, what) -> float:
    if got.shape != want.shape or not torch.allclose(got, want, rtol=rtol, atol=atol):
        err = float((got - want).abs().max()) if got.shape == want.shape else None
        raise AssertionError(f"{what}: outside rtol={rtol}, atol={atol} (max err {err})")
    return float((got - want).abs().max())


def lstm_kernel_phase():
    """K3 against its plain versions: one step (fused_lstm_step, S=1) and a
    whole layer (lstm_layer, S steps) at every shape, the serving, edge and
    training shapes; times at the bank's."""
    resolve_device("cuda")  # full float32 products for the plain versions
    step_err = layer_err = 0.0
    shapes = [LSTM_SERVE, *LSTM_RAGGED, *LSTM_EDGES, *LSTM_TRAIN]
    for i, (S, B, M, H) in enumerate(shapes):
        xz, h, c, Wh, b = lstm_case(S, B, M, H, seed=100 + i)
        got = seq_scan.fused_lstm_step(xz[0], h, c, Wh, b)
        torch.cuda.synchronize()
        want = seq_scan.lstm_step_plain(xz[0], h, c, Wh, b)
        for g, w, name in zip(got, want, ("c", "h")):
            step_err = max(step_err, close(g, w, STEP_RTOL, STEP_ATOL,
                                           f"fused_lstm_step {name} B={B} M={M} H={H}"))
        got = seq_scan.lstm_layer(xz, Wh, b)
        torch.cuda.synchronize()
        layer_err = max(layer_err, close(got, seq_scan.lstm_layer_plain(xz, Wh, b), LAYER_RTOL,
                                         LAYER_ATOL, f"lstm_layer S={S} B={B} M={M} H={H}"))
    # the kernel's reciprocal against the IEEE division, every float it takes
    check = _cuda.load("lstm_step").gordo_lstm_rcp_check
    check.argtypes, check.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
    mismatches = torch.zeros(1, dtype=torch.int32, device="cuda")
    if check(mismatches.data_ptr(), torch.cuda.current_stream().cuda_stream) != 0:
        raise RuntimeError("lstm_step reciprocal self-test did not launch")
    if int(mismatches) != 0:
        raise AssertionError(f"rcp_in_range differs from 1.0f / y on {int(mismatches)} values")
    # the kernel has no backward: both wrappers refuse an input that autograd
    # would differentiate through it
    xz, h, c, Wh, b = lstm_case(4, 3, 2, 8, seed=198)
    for name, fn, args in (
        ("lstm_layer", seq_scan.lstm_layer, (xz.requires_grad_(), Wh, b)),
        ("fused_lstm_step", seq_scan.fused_lstm_step, (xz[0].detach(), h, c, Wh.requires_grad_(), b)),
    ):
        try:
            fn(*args)
        except RuntimeError as exc:
            if "forward-only" not in str(exc):
                raise
        else:
            raise AssertionError(f"{name} launched on an input that requires grad")
    S, B, M, H = LSTM_SERVE
    xz, h, c, Wh, b = lstm_case(S, B, M, H, seed=199)
    step = (xz[0].contiguous(), h, c, Wh, b)
    step_bound, _ = lstm_bound(1, B, M, H)
    phase("parity", kernel="fused_lstm_step", steps=1, shapes=len(shapes),
          band="rtol=atol=1e-6", max_err=step_err, rcp_bitwise_over="[1,2^126)",
          rcp_mismatches=int(mismatches), refuses_requires_grad="lstm_layer,fused_lstm_step",
          kernel_device_us=kernel_device_us(seq_scan.fused_lstm_step, step,
                                            kernel="lstm_steps"),
          ms=round(time_ms(seq_scan.fused_lstm_step, step), 5),
          plain_ms=round(time_ms(seq_scan.lstm_step_plain, step), 5),
          library_ms=round(time_ms(library_step, step), 5), bound_ms=round(step_bound, 6))
    layer = (xz, Wh, b)
    bound, bound_by = lstm_bound(S, B, M, H)
    result = {
        "name": "lstm_layer", "route": "cuda", "source": LSTM_SOURCE,
        "replaces": KERNELS["lstm_layer"], "launches": None, "max_abs_err": layer_err,
        "ms": time_ms(seq_scan.lstm_layer, layer),
        "plain_ms": time_ms(seq_scan.lstm_layer_plain, layer, warmup=3, runs=20),
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": time_ms(library_layer, layer, warmup=3, runs=20),
    }
    phase("parity", kernel="lstm_layer", steps=S, shapes=len(shapes),
          band="rtol=1e-5,atol=1e-6", max_err=layer_err,
          kernel_device_us=kernel_device_us(seq_scan.lstm_layer, layer,
                                            kernel="lstm_steps"),
          ms=round(result["ms"], 5), plain_ms=round(result["plain_ms"], 5),
          library_ms=round(result["library_ms"], 5), bound_ms=round(bound, 6),
          bound_by=bound_by)
    # every layer of the LSTM bank's batch: device us against the bound
    device_us, bound_us = {}, {}
    for H in sorted(set(HOURGLASS_WIDTHS)):
        xz, _, _, Wh, b = lstm_case(S, B, M, H, seed=300 + H)
        device_us[H] = kernel_device_us(seq_scan.lstm_layer, (xz, Wh, b), kernel="lstm_steps")
        bound_us[H] = lstm_bound(S, B, M, H)[0] * 1e3
    # the same layer for one member: at most one warp an SM, so its time is
    # the latency of the step chain alone
    H = LSTM_SERVE[3]
    xz, _, _, Wh, b = lstm_case(S, B, 1, H, seed=400)
    one_member_us = kernel_device_us(seq_scan.lstm_layer, (xz, Wh, b), kernel="lstm_steps")
    phase("lstm_layers", S=S, B=B, M=M, H=json.dumps(HOURGLASS_WIDTHS),
          device_us=json.dumps([device_us[H] for H in HOURGLASS_WIDTHS]),
          bound_us=json.dumps([round(bound_us[H], 3) for H in HOURGLASS_WIDTHS]),
          bound_share=json.dumps([round(bound_us[H] / device_us[H], 4) if device_us[H] else None
                                  for H in HOURGLASS_WIDTHS]),
          sum_device_us=round(sum(device_us[H] or 0.0 for H in HOURGLASS_WIDTHS), 3),
          one_member_device_us=one_member_us, one_member_H=H)
    return {"lstm_layer": result}


# ------------------------------------------------------------------ #
# phases 4-6: the served path
# ------------------------------------------------------------------ #


def random_entry(name: str, n_features: int, rng: np.random.Generator):
    enc = hourglass_calc_dims(0.5, 3, n_features)
    dims = [n_features, *enc, *enc[::-1], n_features]
    params = {"params": {
        f"Dense_{i}": {
            "kernel": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(b)).astype(np.float32),
        }
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))
    }}
    return entry_from_numpy(
        name, "AutoEncoder", "feedforward_hourglass", {}, n_features, params,
        in_shift=0.1 * rng.standard_normal(n_features),
        in_scale=1.0 + rng.random(n_features),
        err_shift=0.05 * rng.random(n_features),
        err_scale=1.0 + rng.random(n_features),
        tags=[f"tag-{i}" for i in range(n_features)],
    )


@functools.lru_cache(maxsize=None)
def lstm_hourglass_shapes(F: int):
    module = lookup_factory("LSTMAutoEncoder", "lstm_hourglass")(F)
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def random_lstm_entry(name: str, registry_type: str, rng: np.random.Generator):
    """An ``lstm_hourglass`` detector at 10 tags, lookback 32, with random
    weights (columns of unit variance) and scalers; forecasters predict t+1."""
    F = 10
    state = {
        k: ((0.1 if k.endswith(".b") or k == "head.bias" else 1.0 / np.sqrt(shape[0]))
            * rng.standard_normal(shape)).astype(np.float32)
        for k, shape in lstm_hourglass_shapes(F).items()
    }
    return entry_from_numpy(
        name, registry_type, "lstm_hourglass", {}, F, lstm_to_flax(state),
        in_shift=0.1 * rng.standard_normal(F),
        in_scale=1.0 + rng.random(F),
        err_shift=0.05 * rng.random(F),
        err_scale=1.0 + rng.random(F),
        tags=[f"tag-{i}" for i in range(F)],
        lookback=LOOKBACK, target_offset=int(registry_type == "LSTMForecast"),
    )


def http_json(url: str, body=None, raw: bytes = None):
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def check_arrays(got: dict, want: dict, what: str, rtol=0.0, atol=E2E_ATOL) -> None:
    for key, w in want.items():
        g = np.asarray(got[key], np.float32)
        if g.shape != w.shape or not np.all(np.isfinite(g)):
            raise AssertionError(f"{what}: {key} has shape {g.shape} or non-finite values")
        if not np.allclose(g, w, rtol=rtol, atol=atol):
            err = float(np.abs(g - w).max())
            raise AssertionError(f"{what}: {key} off by {err} (rtol={rtol}, atol={atol})")


def response_arrays(body: dict, tags) -> dict:
    data = body["data"]
    out = {k: np.asarray([data[k][t] for t in tags], np.float32).T
           for k in ("model-input", "model-output", "tag-anomaly-unscaled", "tag-anomaly-scaled")}
    out.update({k: np.asarray(data[k], np.float32)
                for k in ("total-anomaly-unscaled", "total-anomaly-scaled")})
    return out


def http_phase():
    shutil.rmtree(MODEL_DIR, ignore_errors=True)
    rng = np.random.default_rng(1)
    widths = {f"m{i:03d}": 10 for i in range(64)} | {f"w{i:03d}": 40 for i in range(8)}
    for name, f in widths.items():
        serializer.dump(random_entry(name, f, rng), os.path.join(MODEL_DIR, name))
    lstm = {f"lae{i}": "LSTMAutoEncoder" for i in range(8)} | {f"lfc{i}": "LSTMForecast" for i in range(4)}
    for name, registry_type in lstm.items():
        serializer.dump(random_lstm_entry(name, registry_type, rng), os.path.join(MODEL_DIR, name))
    widths |= {name: 10 for name in lstm}
    offsets = {name: LOOKBACK - 1 + int(t == "LSTMForecast") for name, t in lstm.items()}
    server = run_server(MODEL_DIR, host="127.0.0.1", port=0, background=True)
    try:
        base = server.url + "/gordo/v0/smoke"
        status, models = http_json(base + "/models")
        if status != 200 or models["models"] != sorted(widths) or models["bank"]["n_buckets"] != 4:
            raise AssertionError(f"/models answered {status}: {models}")
        status, body = http_json(base + "/m000/healthcheck")
        if status != 200 or "gordo-server-version" not in body:
            raise AssertionError(f"healthcheck answered {status}: {body}")
        # concurrent POSTs: 56 to the 10-tag dense bucket and 8 to the 40-tag
        # one (64 rows each), and one to every LSTM detector (128 rows)
        targets = [f"m{i:03d}" for i in range(56)] + [f"w{i:03d}" for i in range(8)] + list(lstm)
        n_rows = {t: 128 if t in lstm else 64 for t in targets}
        index = [f"2020-01-01T{m // 60:02d}:{m % 60:02d}:00Z" for m in range(128)]
        X = {t: rng.random((n_rows[t], widths[t])).astype(np.float32) for t in targets}
        replies = {}

        def post(t):
            replies[t] = http_json(f"{base}/{t}/anomaly/prediction",
                                   {"X": X[t].tolist(), "index": index[:n_rows[t]]})

        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(t,)) for t in targets]
        for th in threads:
            th.start()
        for th in threads:
            th.join(180)
            if th.is_alive():
                raise AssertionError("an HTTP client did not finish")
        wall = time.perf_counter() - t0
        for t in targets:
            status, body = replies[t]
            if status != 200:
                raise AssertionError(f"{t}: anomaly/prediction answered {status}: {body}")
            off = offsets.get(t, 0)
            want_index = [s.replace("Z", "+00:00") for s in index[off:n_rows[t]]]
            if body["index"] != want_index:
                raise AssertionError(f"{t}: index {body['index'][:2]}... not trimmed by {off}")
            band = {"rtol": LSTM_RTOL, "atol": LSTM_ATOL} if t in lstm else {}
            path = os.path.join(MODEL_DIR, t)
            plain = serializer.load(path, device="cpu").anomaly(X[t])
            check_arrays(response_arrays(body, [f"tag-{i}" for i in range(widths[t])]), plain,
                         f"http {t}", **band)
            # the detector's own anomaly() on the card: the per-model kernel
            # (and, for an LSTM, the fused step)
            check_arrays(serializer.load(path).anomaly(X[t]), plain, f"detector {t}", **band)
        for t in ("lae0", "lfc0"):
            status, body = http_json(f"{base}/{t}/prediction", {"X": X[t].tolist(), "index": index})
            plain = serializer.load(os.path.join(MODEL_DIR, t), device="cpu").anomaly(X[t])
            want_index = [s.replace("T", " ").replace("Z", "+00:00") for s in index[offsets[t]:]]
            if status != 200 or body["index"] != want_index:
                raise AssertionError(f"{t}: /prediction answered {status} or an untrimmed index")
            check_arrays({"model-output": body["data"]}, {"model-output": plain["model-output"]},
                         f"prediction {t}", rtol=LSTM_RTOL, atol=LSTM_ATOL)
            short = X[t][: offsets[t]].tolist()
            status, body = http_json(f"{base}/{t}/anomaly/prediction", {"X": short})
            if status != 400:
                raise AssertionError(f"{t}: a {offsets[t]}-row request answered {status}: {body}")
        status, body = http_json(base + "/m000/anomaly/prediction", raw=b"not json")
        if status != 400:
            raise AssertionError(f"bad body answered {status}: {body}")
        status, body = http_json(base + "/ghost/anomaly/prediction", {"X": X["m000"].tolist()})
        if status != 404:
            raise AssertionError(f"unknown target answered {status}: {body}")
        batches = server.app.engine.stats["batches"]
    finally:
        server.close()
        shutil.rmtree(MODEL_DIR, ignore_errors=True)
    phase("http", models=len(widths), buckets=4, posts=len(targets), rows="64,128(lstm)",
          wall_s=round(wall, 4), engine_batches=batches,
          checked="all six arrays vs CPU plain", index_trimmed_by="31,32",
          status_400="bad body,warm-up", status_404=True)


def profile_batch(bank, requests, runs=5):
    """Where one full bank call of ``requests`` spends its time: the median
    host wall time of ``runs`` calls, and from one call under the profiler
    the device time of every kernel and copy, summed, and their count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(runs + 1):  # the first call warms the allocator
        t0 = time.perf_counter()
        bank.score_many(requests)  # ends in a device-to-host copy
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        bank.score_many(requests)
        torch.cuda.synchronize()
    by_name = {}
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    wall_ms = statistics.median(walls[1:]) * 1e3
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return {
        "batch_wall_ms": round(wall_ms, 4), "batch_device_ms": round(device_ms, 4),
        "device_busy_share": round(device_ms / wall_ms, 4), "device_ops": len(events),
        "top_device_ms": json.dumps({k[:40]: round(v, 4) for k, v in top}),
    }


def bank_phase(card: str, lstm: bool = False):
    """A 10,000-member bank driven by 64 closed-loop clients through the
    engine: dense hourglass members with 64-row requests, or LSTM hourglass
    members (lookback 32) with 128-row requests."""
    rng = np.random.default_rng(3 if lstm else 2)
    n_members, n_clients, n_requests = 10_000, 64, 4
    n_rows = 128 if lstm else 64
    t0 = time.perf_counter()
    if lstm:
        entries = [random_lstm_entry(f"l{i:05d}", "LSTMAutoEncoder", rng) for i in range(n_members)]
    else:
        entries = [random_entry(f"m{i:05d}", 10, rng) for i in range(n_members)]
    bank = ModelBank.from_entries(entries)
    build_s = time.perf_counter() - t0
    off = entries[0].offset
    # the cyclic collector's pass over the 10,000 freshly built entries
    # (about 0.2 s) runs here, not at whatever request of the timed loop
    # crosses its threshold, where it would stall every client at once
    gc.collect()
    engine = BatchingEngine(bank, max_batch=64, flush_ms=2.0)
    engine.start()
    try:
        X = rng.random((n_clients, n_requests, n_rows, 10)).astype(np.float32)
        names = [[entries[int(j)].name for j in rng.integers(0, n_members, n_requests)]
                 for _ in range(n_clients)]
        engine.score_blocking(names[0][0], X[0, 0])  # first batch pays allocator warm-up
        before = dict(engine.stats)
        launches_before = dict(score.launch_counts, **seq_scan.launch_counts)
        lat, results, failures = [], {}, []
        barrier = threading.Barrier(n_clients)

        def client(c):
            try:
                barrier.wait(60)
                for r in range(n_requests):
                    t = time.perf_counter()
                    results[(c, r)] = engine.score_blocking(names[c][r], X[c, r], timeout=120)
                    lat.append(time.perf_counter() - t)
            except Exception as exc:  # reported below: the phase fails
                failures.append(repr(exc))

        threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        wall = time.perf_counter() - t0
        if failures or len(results) != n_clients * n_requests:
            raise AssertionError(f"bank phase: {len(results)} results, failures {failures[:3]}")
        stats = {k: engine.stats[k] - before[k] for k in ("requests", "batches")}
        stats["max_batch_seen"] = engine.stats["max_batch_seen"]
        after = dict(score.launch_counts, **seq_scan.launch_counts)
        launches = {k: after[k] - launches_before[k] for k in after}
    finally:
        engine.stop()
    # one full batch alone, outside the engine: host wall vs device time
    profiled = profile_batch(bank, [(names[c][0], X[c, 0], None) for c in range(n_clients)])
    from gordo_components_torch.models.anomaly.diff import DiffBasedAnomalyDetector

    band = {"rtol": LSTM_RTOL, "atol": LSTM_ATOL} if lstm else {}
    by_name = {e.name: e for e in entries}
    for (c, r), res in results.items():
        arrays = res.to_arrays()
        if not all(np.all(np.isfinite(a)) for a in arrays.values()):
            raise AssertionError(f"bank phase: non-finite scores for {names[c][r]}")
        if len(res.model_output) != n_rows - off:
            raise AssertionError(f"bank phase: {len(res.model_output)} rows for {names[c][r]}")
        if c % 8 == 0:  # hold a sample against the CPU plain computation
            plain = DiffBasedAnomalyDetector.from_entry(by_name[names[c][r]], device="cpu")
            check_arrays(arrays, plain.anomaly(X[c, r]), f"bank {names[c][r]}", **band)
    lat_ms = np.asarray(lat) * 1e3
    batches = max(stats["batches"], 1)
    summary = {
        "members": n_members, "clients": n_clients, "requests": len(results),
        "rows_per_request": n_rows, "scored_rows_per_request": n_rows - off,
        "build_s": round(build_s, 3),
        "p50_ms": round(float(np.percentile(lat_ms, 50)), 4),
        "p99_ms": round(float(np.percentile(lat_ms, 99)), 4),
        "rows_per_s": round(len(results) * (n_rows - off) / wall, 1),
        "avg_batch": round(stats["requests"] / batches, 3),
        "batches": stats["batches"], "max_batch_seen": stats["max_batch_seen"],
        "banked_launches_per_batch": round(launches["banked_anomaly_score"] / batches, 3),
    }
    if lstm:
        summary["lstm_layer_launches_per_batch"] = round(launches["lstm_layer"] / batches, 3)
    summary.update(profiled)
    phase("lstm" if lstm else "bank", **summary, card=json.dumps(card))
    return summary


# ------------------------------------------------------------------ #
# phases 4-5: training
# ------------------------------------------------------------------ #


def synth_fleet(n_models: int, rows: int, n_features: int, seed: int = 0):
    """The reference bench's synthetic fleet (``bench.py`` ``_synth_fleet``):
    per member, sine waves of random frequency and phase plus noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(rows)
    out = {}
    for i in range(n_models):
        freqs = 0.01 + 0.002 * rng.rand(n_features)
        phases = 2 * np.pi * rng.rand(n_features)
        X = np.sin(np.outer(t, freqs) + phases) + rng.normal(scale=0.05, size=(rows, n_features))
        out[f"machine-{i}"] = X.astype("float32")
    return out


def cuda_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def stacked_block(members, batch_size: int, warmup: int = 0):
    """The members' rows stacked on the card as a fleet bucket holds them:
    rows (M, padded items + warmup, F), item masks (M, padded items), and the
    real items a member (all members have the same rows)."""
    arrays = np.stack(list(members.values()))
    M, rows, F = arrays.shape
    n_items = rows - warmup
    n_pad = quantize_batch_count(-(-n_items // batch_size)) * batch_size
    dev = torch.device("cuda")
    X = torch.zeros(M, n_pad + warmup, F, device=dev)
    X[:, :rows] = torch.from_numpy(arrays).to(dev)
    mask = (torch.arange(n_pad, device=dev) < n_items).float().expand(M, n_pad).contiguous()
    return X, mask, [n_items] * M


def profile_training(stack, X, mask, n_real, batch_size: int):
    """One training step and one epoch of the stacked train core over the
    rows ``X`` and item masks ``mask`` on the card, under the profiler:
    device operations of the step, and the epoch's device time against its
    wall time."""
    from torch.profiler import ProfilerActivity, profile

    dev = X.device
    M, n_pad = mask.shape
    opt = train_core.make_optimizer("adam", 1e-3)
    init_fn, epoch_fn = train_core.make_train_fns(stack, opt, batch_size)
    step = train_core.make_step_fn(stack, opt)
    state = init_fn([train_core.member_generator(0, i) for i in range(M)], dev)
    lr = torch.full((M,), 1e-3, device=dev)
    state, _ = epoch_fn(state, X, X, mask, lr, n_real=n_real)  # warm
    xb, yb = stack.batch(X, X, torch.arange(batch_size, device=dev).expand(M, batch_size))
    mb = mask[:, :batch_size]
    step(state.params, state.opt_state, xb, yb, mb, lr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state.params, state.opt_state, xb, yb, mb, lr)
        torch.cuda.synchronize()
    step_ops = len(cuda_events(prof))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, losses = epoch_fn(state, X, X, mask, lr, n_real=n_real)
        losses.cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3
    clocks = card_clocks()
    events = cuda_events(prof)
    by_kernel = {}  # device ms by kernel, template arguments dropped
    for e in events:
        kernel = e.name.removeprefix("void ").split("<")[0][:60]
        by_kernel[kernel] = by_kernel.get(kernel, 0.0) + e.time_range.elapsed_us() / 1e3
    device_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    # host pieces of an epoch, each timed alone (median of 5): the shuffle
    # (one randperm a member on the CPU, one copy, then a wait) and one
    # step's launches (the wait after it untimed)
    def median_ms(fn, wait_inside: bool) -> float:
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            if wait_inside:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        return statistics.median(times)

    shuffle_ms = median_ms(lambda: train_core.shuffle_perm(state.generators, n_real, n_pad, dev), True)
    launch_ms = median_ms(lambda: step(state.params, state.opt_state, xb, yb, mb, lr), False)
    return {
        "step_device_ops": step_ops, "step_launch_ms": round(launch_ms, 4),
        "epoch_steps": n_pad // batch_size, "epoch_shuffle_ms": round(shuffle_ms, 3),
        "epoch_device_ops": len(events), "profiled_epoch_wall_ms": round(wall_ms, 3),
        "epoch_device_ms": round(device_ms, 4),
        "profiled_epoch_busy_share": round(device_ms / wall_ms, 4),
        "epoch_top_device_ms": json.dumps({k: round(v, 3) for k, v in top}),
        "card_after_epoch": json.dumps(clocks),
    }


def train_phase(card: str):
    """FleetTrainer at full width: a warm fit, then a timed fit."""
    members = synth_fleet(**FLEET_SHAPE)
    FleetTrainer(**FLEET_CONFIG).fit(members)
    trainer = FleetTrainer(**FLEET_CONFIG)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    models = trainer.fit(members)
    wall = time.perf_counter() - t0
    epochs = trainer.last_stats["buckets"][0]["epoch_seconds"]
    losses = np.array([m.history["loss"] for m in models.values()])
    if losses.shape != (len(members), FLEET_CONFIG["epochs"]) or not np.all(np.isfinite(losses)):
        raise AssertionError(f"train: loss histories of shape {losses.shape} or non-finite")
    fell = float(np.mean(losses[:, -1] < losses[:, 0]))
    if fell < 0.99:
        raise AssertionError(f"train: the loss fell for a share of {fell} of the members, below 0.99")
    steady = statistics.median(epochs[1:])
    bs = FLEET_CONFIG["batch_size"]
    X, mask, n_real = stacked_block(members, bs)
    stack = train_core.StackedDense(lookup_factory("AutoEncoder", FLEET_CONFIG["kind"])(X.shape[-1]))
    prof = profile_training(stack, X, mask, n_real, bs)
    phase("train", members=len(members), rows=FLEET_SHAPE["rows"], tags=FLEET_SHAPE["n_features"],
          epochs=FLEET_CONFIG["epochs"], batch=FLEET_CONFIG["batch_size"], dtype="float32",
          padded=json.dumps({k: trainer.last_stats["buckets"][0][k]
                             for k in ("padded_rows", "padded_members")}),
          fit_wall_s=round(wall, 4), models_per_hour=round(len(members) / wall * 3600, 1),
          epoch_s=json.dumps(epochs), steady_epoch_s=round(steady, 4),
          loss_fell_share=fell, loss_epoch1_median=round(float(np.median(losses[:, 0])), 6),
          loss_epoch5_median=round(float(np.median(losses[:, -1])), 6),
          **prof, epoch_device_busy_share=round(prof["epoch_device_ms"] / 1e3 / steady, 4),
          card=json.dumps(card))


def train_parity_phase():
    """The same small fleet from the same initial parameters on the card and
    on the CPU: one batch an epoch, so both see the same rows in each step."""
    members = synth_fleet(8, 256, 10, seed=5)
    module = lookup_factory("AutoEncoder", FLEET_CONFIG["kind"])(10)
    stack = train_core.StackedDense(module)
    init = stack.state_dicts(stack.init([train_core.member_generator(7, i) for i in range(8)]))
    initial = dict(zip(members, init))
    config = dict(kind=FLEET_CONFIG["kind"], epochs=3, batch_size=256)
    card = FleetTrainer(**config).fit(members, initial_params=initial)
    cpu = FleetTrainer(device="cpu", **config).fit(members, initial_params=initial)
    err = {"params": 0.0, "loss": 0.0, "error_scaler": 0.0, "thresholds": 0.0}

    def hold(got, want, what, key):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        if got.shape != want.shape or not np.allclose(got, want, rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
            raise AssertionError(f"train_parity: {what} outside rtol={TRAIN_RTOL}, atol={TRAIN_ATOL}")
        err[key] = max(err[key], float(np.abs(got - want).max()))

    for name in members:
        a, b = card[name], cpu[name]
        for k in b.params:
            hold(a.params[k], b.params[k], f"{name} {k}", "params")
        hold(a.history["loss"], b.history["loss"], f"{name} losses", "loss")
        for x, y in zip(a.error_scaler, b.error_scaler):
            hold(x, y, f"{name} error scaler", "error_scaler")
        hold(a.feature_thresholds, b.feature_thresholds, f"{name} feature thresholds", "thresholds")
        hold(a.total_threshold, b.total_threshold, f"{name} total threshold", "thresholds")
    phase("train_parity", members=len(members), rows=256, epochs=3, batch=256,
          band=f"rtol={TRAIN_RTOL},atol={TRAIN_ATOL}",
          max_abs_err=json.dumps({k: float(f"{v:.3g}") for k, v in err.items()}))


def lstm_launches() -> int:
    return seq_scan.launch_counts["lstm_layer"] + seq_scan.launch_counts["fused_lstm_step"]


def seq_train_phase(card: str):
    """The reference bench's config 2 as one fit, then its single build's
    detector fit, which scores the training rows through K3."""
    X = synth_fleet(1, FLEET_SHAPE["rows"], FLEET_SHAPE["n_features"])["machine-0"]
    LSTMAutoEncoder(epochs=1, **SEQ_CONFIG).fit(X)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = LSTMAutoEncoder(epochs=SEQ_EPOCHS, **SEQ_CONFIG).fit(X)
    wall = time.perf_counter() - t0
    loss = est.history["loss"]
    if len(loss) != SEQ_EPOCHS or not np.all(np.isfinite(loss)) or not loss[-1] < loss[0]:
        raise AssertionError(f"seq_train: losses {loss} are not finite or did not fall")
    k3_before = lstm_launches()
    t0 = time.perf_counter()
    det = DiffBasedAnomalyDetector(base_estimator=Pipeline([
        ("scale", MinMaxScaler()), ("model", LSTMAutoEncoder(epochs=SEQ_EPOCHS, **SEQ_CONFIG))])).fit(X)
    det_wall = time.perf_counter() - t0
    k3_fit = lstm_launches() - k3_before
    if k3_fit <= 0:
        raise AssertionError("seq_train: the detector's fit launched no fused LSTM step")
    scored = det.anomaly(X)
    n_out = FLEET_SHAPE["rows"] - (LOOKBACK - 1)
    total = scored["total-anomaly-scaled"]
    if total.shape != (n_out,) or not np.all(np.isfinite(total)):
        raise AssertionError(f"seq_train: anomaly() gave {total.shape} or non-finite scores")
    over = float(total.max() - det.total_threshold_)
    if over > LSTM_ATOL + LSTM_RTOL * det.total_threshold_:
        raise AssertionError(f"seq_train: a training row's score exceeds the threshold by {over}")
    bs = SEQ_CONFIG["batch_size"]
    module = lookup_factory("LSTMAutoEncoder", SEQ_CONFIG["kind"])(X.shape[1])
    # with a validation split and early stopping: the validation loss is the
    # fit's only forward without a gradient, so every K3 launch of the fit is
    # one of it (epochs run x validation batches x layers) and the training
    # steps launch none
    k3_before = lstm_launches()
    val_est = LSTMAutoEncoder(epochs=SEQ_EPOCHS, validation_split=0.2, early_stopping_patience=2,
                              **SEQ_CONFIG).fit(X)
    k3_val = lstm_launches() - k3_before
    val_loss = val_est.history["val_loss"]
    n_val = int(n_out * 0.2)
    want_k3 = len(val_loss) * -(-n_val // bs) * len(module.dims)
    if k3_val != want_k3 or len(val_loss) != len(val_est.history["loss"]):
        raise AssertionError(f"seq_train: {k3_val} fused LSTM step launches in the validated fit "
                             f"({len(val_loss)} validation losses), expected {want_k3}")
    if not np.all(np.isfinite(val_loss)):
        raise AssertionError(f"seq_train: validation losses {val_loss} are not finite")
    block = stacked_block({"machine-0": X}, bs, LOOKBACK - 1)
    prof = profile_training(train_core.StackedLSTM(module, LOOKBACK), *block, bs)
    steady = statistics.median(est.epoch_seconds_[1:])
    phase("seq_train", model="LSTMAutoEncoder", kind=SEQ_CONFIG["kind"], lookback=LOOKBACK,
          rows=len(X), tags=X.shape[1], epochs=SEQ_EPOCHS, batch=bs, dtype="float32",
          items=n_out, fit_wall_s=round(wall, 4), models_per_hour=round(3600 / wall, 1),
          epoch_s=json.dumps([round(e, 4) for e in est.epoch_seconds_]), steady_epoch_s=round(steady, 4),
          loss_epoch1=round(loss[0], 6), loss_epoch5=round(loss[-1], 6),
          detector_fit_wall_s=round(det_wall, 4), k3_launches_detector_fit=k3_fit,
          max_over_threshold=over, validated_epochs=len(val_loss),
          val_loss=json.dumps([round(v, 6) for v in val_loss]), k3_launches_validation=k3_val,
          **prof,
          epoch_device_busy_share=round(prof["epoch_device_ms"] / 1e3 / steady, 4),
          card=json.dumps(card))


def seq_fleet_phase(card: str):
    """FleetTrainer of config 2's model at the bench's fleet width: a warm
    1-epoch fit, then the timed fit, whose error pass runs K3."""
    members = synth_fleet(SEQ_FLEET_MEMBERS, FLEET_SHAPE["rows"], FLEET_SHAPE["n_features"])
    config = dict(model_type="LSTMAutoEncoder", **SEQ_CONFIG)
    FleetTrainer(epochs=1, **config).fit(members)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = FleetTrainer(epochs=SEQ_EPOCHS, **config)
    k3_before = lstm_launches()
    t0 = time.perf_counter()
    models = trainer.fit(members)
    wall = time.perf_counter() - t0
    k3_fit = lstm_launches() - k3_before
    peak = torch.cuda.max_memory_allocated()
    bucket = trainer.last_stats["buckets"][0]
    bs = SEQ_CONFIG["batch_size"]
    module = lookup_factory("LSTMAutoEncoder", SEQ_CONFIG["kind"])(FLEET_SHAPE["n_features"])
    # no validation: every launch is the error pass, two passes of every
    # batch, one launch a layer
    want_k3 = 2 * (bucket["padded_items"] // bs) * len(module.dims)
    if k3_fit != want_k3:
        raise AssertionError(f"seq_fleet: {k3_fit} fused LSTM step launches, expected {want_k3}")
    losses = np.array([m.history["loss"] for m in models.values()])
    if losses.shape != (len(members), SEQ_EPOCHS) or not np.all(np.isfinite(losses)):
        raise AssertionError(f"seq_fleet: loss histories of shape {losses.shape} or non-finite")
    fell = float(np.mean(losses[:, -1] < losses[:, 0]))
    if fell < 0.99:
        raise AssertionError(f"seq_fleet: the loss fell for a share of {fell} of the members, below 0.99")
    epochs = bucket["epoch_seconds"]
    steady = statistics.median(epochs[1:])
    block = stacked_block(members, bs, LOOKBACK - 1)
    prof = profile_training(train_core.StackedLSTM(module, LOOKBACK), *block, bs)
    phase("seq_fleet", members=len(members), rows=FLEET_SHAPE["rows"], tags=FLEET_SHAPE["n_features"],
          lookback=LOOKBACK, epochs=SEQ_EPOCHS, batch=bs, dtype="float32",
          padded=json.dumps({k: bucket[k] for k in ("padded_items", "padded_rows", "padded_members")}),
          fit_wall_s=round(wall, 4), models_per_hour=round(len(members) / wall * 3600, 1),
          epoch_s=json.dumps(epochs), steady_epoch_s=round(steady, 4),
          peak_device_gib=round(peak / 2**30, 3), k3_launches_error_pass=k3_fit,
          loss_fell_share=fell, loss_epoch1_median=round(float(np.median(losses[:, 0])), 6),
          loss_epoch5_median=round(float(np.median(losses[:, -1])), 6), **prof,
          epoch_device_busy_share=round(prof["epoch_device_ms"] / 1e3 / steady, 4),
          card=json.dumps(card))


def seq_train_parity_phase():
    """8 LSTM members of ragged rows from the same initial parameters on the
    card and on the CPU, one batch an epoch, at q = 1 and q = 0.99, and with
    a validation split and early stopping; then one member's single fit with
    the same validation and early stopping."""
    fleet = synth_fleet(8, 160, 10, seed=6)
    members = {name: X[: 160 - 8 * i] for i, (name, X) in enumerate(fleet.items())}
    module = lookup_factory("LSTMAutoEncoder", SEQ_CONFIG["kind"])(10)
    stack = train_core.StackedLSTM(module, LOOKBACK)
    initial = dict(zip(members, stack.state_dicts(stack.init(
        [train_core.member_generator(7, i) for i in range(len(members))]))))
    err = {"params": 0.0, "loss": 0.0, "val_loss": 0.0, "scalers": 0.0, "thresholds_q1": 0.0,
           "thresholds_q0.99": 0.0}
    stopped = {}  # member -> epochs run with validation and early stopping

    def hold(got, want, what, key, rtol=LSTM_RTOL, atol=LSTM_ATOL):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        if got.shape != want.shape or not np.allclose(got, want, rtol=rtol, atol=atol):
            raise AssertionError(f"seq_train_parity: {what} outside rtol={rtol}, atol={atol}")
        err[key] = max(err[key], float(np.abs(got - want).max()))

    # q = 1 and 0.99; then q = 1 with a validation split and early stopping,
    # whose validation loss runs K3 on the card: no epoch beats the first by
    # min_delta, so every member stops after epoch 2 and restores epoch 1's
    # parameters (a stop decided by a near tie could differ between the card
    # and the CPU)
    validated = dict(validation_split=0.2, early_stopping_patience=1, early_stopping_min_delta=10.0)
    for q, extra in ((1.0, {}), (0.99, {}), (1.0, validated)):
        config = dict(model_type="LSTMAutoEncoder", kind=SEQ_CONFIG["kind"], lookback_window=LOOKBACK,
                      epochs=3, batch_size=256, threshold_quantile=q)
        config.update(extra)
        card = FleetTrainer(**config).fit(members, initial_params=initial)
        cpu = FleetTrainer(device="cpu", **config).fit(members, initial_params=initial)
        for name in members:
            a, b = card[name], cpu[name]
            for k in b.params:
                hold(a.params[k], b.params[k], f"{name} {k}", "params")
            hold(a.history["loss"], b.history["loss"], f"{name} losses", "loss")
            if extra:
                hold(a.history["val_loss"], b.history["val_loss"], f"{name} validation losses", "val_loss")
                stopped[name] = len(b.history["loss"])
            for x, y in (*zip(a.scaler, b.scaler), *zip(a.error_scaler, b.error_scaler)):
                hold(x, y, f"{name} scalers", "scalers")
            if q >= 1.0:
                hold(a.feature_thresholds, b.feature_thresholds, f"{name} thresholds", "thresholds_q1")
                hold(a.total_threshold, b.total_threshold, f"{name} total threshold", "thresholds_q1")
            else:  # histogram thresholds: within two bins
                hold(a.feature_thresholds, b.feature_thresholds, f"{name} q thresholds",
                     "thresholds_q0.99", rtol=0.0, atol=2 / QUANTILE_BINS)
                hold(a.total_threshold, b.total_threshold, f"{name} q total threshold",
                     "thresholds_q0.99", rtol=0.0, atol=2 * np.sqrt(10) / QUANTILE_BINS)
            if a.threshold_method != b.threshold_method:
                raise AssertionError(f"seq_train_parity: threshold methods {a.threshold_method}, "
                                     f"{b.threshold_method}")
    # the single estimator's validation and early stopping (one member, its
    # own init and shuffles from the seed on both sides)
    name, X = next(iter(members.items()))
    single = dict(SEQ_CONFIG, batch_size=256, epochs=3, **validated)
    a = LSTMAutoEncoder(**single).fit(X)
    b = LSTMAutoEncoder(device="cpu", **single).fit(X)
    for k in b.params_:
        hold(a.params_[k], b.params_[k], f"single {k}", "params")
    for k in ("loss", "val_loss"):
        hold(a.history[k], b.history[k], f"single {k}", k if k == "val_loss" else "loss")
    stopped["single"] = len(b.history["loss"])
    if set(stopped.values()) != {2}:
        raise AssertionError(f"seq_train_parity: early stopping ran {stopped} epochs, expected 2 each")
    phase("seq_train_parity", members=len(members), rows="160..104", lookback=LOOKBACK, epochs=3,
          batch=256, quantiles="1.0,0.99", validated=json.dumps(validated),
          epochs_run_validated=json.dumps(stopped), band=f"rtol={LSTM_RTOL},atol={LSTM_ATOL}",
          q099_band="2 bins", max_abs_err=json.dumps({k: float(f"{v:.3g}") for k, v in err.items()}))


# ------------------------------------------------------------------ #
# phase 9: build a fleet and serve what it built
# ------------------------------------------------------------------ #


def lstm_pipeline(model_type: str, **kwargs):
    return {"gordo_components_torch.models.DiffBasedAnomalyDetector": {"base_estimator": {
        "sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler",
            {f"gordo_components_torch.models.{model_type}": kwargs}]}}}}


def build_phase():
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    out_dir, reg_dir = os.path.join(FLEET_DIR, "models"), os.path.join(FLEET_DIR, "register")

    def dataset(name, tags=10):
        return {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00Z",
                "train_end_date": "2020-01-08T00:00:00Z",
                "tag_list": [f"{name}-tag-{j}" for j in range(tags)]}

    machines = [Machine(name=f"fleet-{i:03d}", dataset=dataset(f"fleet-{i:03d}")) for i in range(64)]
    # a bare AutoEncoder (no scaler step) is not fleetable: the single-build path
    machines.append(Machine(name="bespoke", dataset=dataset("bespoke"), model={
        "gordo_components_torch.models.DiffBasedAnomalyDetector": {"base_estimator": {
            "gordo_components_torch.models.AutoEncoder": {"kind": "feedforward_hourglass"}}}}))
    # examples/fleet.yaml's LSTM machine, as its dict
    machines.append(Machine.from_dict({
        "name": "turbine-lstm",
        "dataset": {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00Z",
                    "train_end_date": "2020-01-08T00:00:00Z", "tag_list": ["tl-vibration", "tl-load"]},
        "model": {"gordo_components_tpu.models.DiffBasedAnomalyDetector": {"base_estimator": {
            "sklearn.pipeline.Pipeline": {"steps": [
                "sklearn.preprocessing.MinMaxScaler",
                {"gordo_components_tpu.models.LSTMAutoEncoder": {
                    "kind": "lstm_hourglass", "lookback_window": 12, "epochs": 5}}]}}}},
    }))
    lstm_types = {f"lae-{i}": "LSTMAutoEncoder" for i in range(4)} | {f"lfc-{i}": "LSTMForecast" for i in range(2)}
    machines += [Machine(name=n, dataset=dataset(n), model=lstm_pipeline(t, kind="lstm_hourglass"))
                 for n, t in lstm_types.items()]
    # an LSTM detector without a scaler step: the single-build path
    machines.append(Machine(name="bespoke-lstm", dataset=dataset("bespoke-lstm"), model={
        "gordo_components_torch.models.DiffBasedAnomalyDetector": {"base_estimator": {
            "gordo_components_torch.models.LSTMForecast": {
                "kind": "lstm_hourglass", "lookback_window": 16, "epochs": 3}}}}))
    # top-level configs that are not detectors: no port artifact yet
    not_detectors = {
        "c1-pipeline": {"sklearn.pipeline.Pipeline": {"steps": [
            "sklearn.preprocessing.MinMaxScaler", "gordo_components_torch.models.AutoEncoder"]}},
        "c1-estimator": {"gordo_components_torch.models.AutoEncoder": {}},
    }
    machines += [Machine(name=n, dataset=dataset(n), model=m) for n, m in not_detectors.items()]
    lstm_names = {"turbine-lstm", "bespoke-lstm", *lstm_types}
    engine = None
    try:
        t0 = time.perf_counter()
        report = build_fleet(machines, out_dir, model_register_dir=reg_dir)
        build_s = time.perf_counter() - t0
        manifest = report.manifest()
        if manifest["n_built"] != len(machines) - 2 or sorted(report.failed) != sorted(not_detectors):
            raise AssertionError(f"build: {manifest['n_built']} built, failed {report.failed}")
        for name, error in report.failed.items():
            if not error.startswith("NotImplementedError"):
                raise AssertionError(f"build: {name} failed with {error}")
        collection = ModelCollection(out_dir)
        bank = ModelBank.from_entries(list(collection.entries.values()))
        engine = BatchingEngine(bank, max_batch=64, flush_ms=2.0)
        engine.start()
        built = [m for m in machines if m.name in report]
        data = {m.name: get_dataset(m.dataset).get_data()[0].values for m in built}
        results = {name: engine.score_blocking(name, X, timeout=120) for name, X in data.items()}
        worst = 0.0
        for name, res in results.items():
            arrays = res.to_arrays()
            if not all(np.all(np.isfinite(a)) for a in arrays.values()):
                raise AssertionError(f"build: non-finite scores for {name}")
            th = collection.metadata[name]["thresholds"]
            feat = np.array([th["feature-thresholds"][t] for t in collection.entries[name].tags])
            over = max(float((res.scaled - feat).max()),
                       float(res.total_scaled.max() - th["total-anomaly-threshold"]))
            worst = max(worst, over)
            band = LSTM_ATOL + LSTM_RTOL * max(feat.max(), th["total-anomaly-threshold"]) \
                if name in lstm_names else E2E_ATOL
            if over > band:
                raise AssertionError(f"build: {name}'s training error exceeds its threshold by {over}")
        for name in results:
            got = serializer.load(os.path.join(out_dir, name)).anomaly(data[name])
            band = {"rtol": LSTM_RTOL, "atol": LSTM_ATOL} if name in lstm_names else {}
            check_arrays(got, results[name].to_arrays(), f"build {name}: anomaly() vs bank", **band)
    finally:
        if engine is not None:
            engine.stop()
        shutil.rmtree(FLEET_DIR, ignore_errors=True)
    phase("build", machines=len(machines), n_built=manifest["n_built"], n_failed=manifest["n_failed"],
          failed=json.dumps(sorted(report.failed)), lstm_machines=len(lstm_names),
          build_s=round(build_s, 3), rows_per_machine=len(data["fleet-000"]),
          bank_buckets=bank.n_buckets, scored="every machine, by the bank and by anomaly()",
          max_over_threshold=worst)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a card", file=sys.stderr)
        return 2
    card = card_line()
    phase("card", torch=torch.__version__, cuda=torch.version.cuda,
          device=json.dumps(torch.cuda.get_device_name(0)), nvidia_smi=json.dumps(card))

    t0 = time.perf_counter()
    libs = _cuda.build_all()
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          libraries=",".join(sorted(libs)), flags=json.dumps(" ".join(_cuda.NVCC_FLAGS)),
          kernels_max_regs_max_local_bytes=json.dumps(resource_usage(libs)))

    kernels = kernel_phase()
    kernels.update(lstm_kernel_phase())

    # every path: the launch counters from 0 just before it, read just after
    paths = {}

    def drive(name, fn, *args):
        score.reset_launch_counts()
        seq_scan.reset_launch_counts()
        fn(*args)
        paths[name] = dict(score.launch_counts, **seq_scan.launch_counts)

    drive("train", train_phase, card)
    train_parity_phase()
    drive("seq_train", seq_train_phase, card)
    drive("seq_fleet", seq_fleet_phase, card)
    seq_train_parity_phase()
    drive("http", http_phase)
    drive("bank", bank_phase, card)
    drive("lstm", bank_phase, card, True)
    drive("build", build_phase)
    for path, kernel in (("seq_train", "lstm_layer"), ("seq_fleet", "lstm_layer"),
                         ("build", "banked_anomaly_score"), ("build", "fused_anomaly_score"),
                         ("build", "lstm_layer")):
        if paths[path][kernel] <= 0:
            raise AssertionError(f"{path}: launched no {kernel}")
    phase("counts", **{f"{k}_{path}": v for path, c in paths.items() for k, v in c.items()})
    for name in kernels:
        n = sum(c[name] for c in paths.values())
        if n <= 0:
            raise AssertionError(f"{name}: the main path launched its kernel {n} times")
        kernels[name]["launches"] = n

    print(json.dumps({"kernels": list(kernels.values())}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
