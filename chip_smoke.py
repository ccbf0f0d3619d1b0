#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the exit code is non-zero):

1. card     torch/CUDA versions and ``nvidia-smi`` name and power limit;
2. build    compile the CUDA kernels (``gordo_components_torch/ops/csrc``)
            with nvcc for sm_90a;
3. parity   hold each kernel against its plain PyTorch version on the card,
            at the serving shape (B=64, T=64, F=10, M=10000) and at ragged
            shapes: diff/scaled bitwise, norms within rtol=atol=1e-6; time
            kernel, plain version and a library expression with CUDA events;
4. http     serve a two-bucket directory of port artifacts (64 detectors at
            10 tags, 8 at 40) with ``run_server``; 64 concurrent
            anomaly/prediction POSTs of 64 rows, each held against the
            port's plain computation on the CPU at atol=1e-5; a bad body
            (400), an unknown target (404); the detectors' ``anomaly()`` on
            the card;
5. bank     10,000 hourglass members at 10 tags scored by 64 clients x 4
            requests x 64 rows through BatchingEngine(max_batch=64,
            flush_ms=2.0): latency, rows/s, average batch;
6. counts   both kernels' launch counters over phases 4-5 (the main path),
            which must both be above 0.

Then one JSON line with every kernel's numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Exits non-zero without
CUDA. Weights and data are random, made from fixed seeds.
"""

import json
import os
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

from gordo_components_torch import serializer
from gordo_components_torch.convert import entry_from_numpy
from gordo_components_torch.models.factories.feedforward import hourglass_calc_dims
from gordo_components_torch.ops import _cuda, score
from gordo_components_torch.server import BatchingEngine, ModelBank, run_server

ROOT = os.path.dirname(os.path.abspath(__file__))
MODEL_DIR = os.path.join(ROOT, "build", "chip_smoke_models")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
NORM_RTOL = NORM_ATOL = 1e-6  # the JAX package's band for the two norms
E2E_ATOL = 1e-5  # card vs CPU: matmul accumulation order and tanh differ in the last bits
SERVE_SHAPE = (64, 64, 10, 10000)  # B, T, F, M of a full coalesced batch
RAGGED = [(3, 261, 130, 5), (1, 7, 3, 1), (8, 16, 257, 16)]
KERNELS = {
    "banked_anomaly_score": "gordo_components_tpu/ops/pallas_score.py:298",
    "fused_anomaly_score": "gordo_components_tpu/ops/pallas_score.py:84",
}
SOURCE = "gordo_components_torch/ops/csrc/anomaly_score.cu"


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


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


def kernel_device_us(fn, args, runs=50):
    """Average device time of the anomaly-score kernel itself, from the
    profiler's CUDA trace; None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn(*args)
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        if "anomaly_score_kernel" in evt.key:
            us = getattr(evt, "device_time", None) or getattr(evt, "cuda_time", None)
            return round(us, 3) if us else None
    return None


def bound_ms(B, T, F, idx) -> float:
    """Least time for the epilogue on this card: every input byte read once
    (target, output, idx and the scaler rows this idx gathers) and every
    output byte written once, against ~8 float32 operations per element."""
    rows = len(torch.unique(idx))
    moved = 4 * (2 * B * T * F + B + 2 * rows * F) + 4 * (2 * B * T * F + 2 * B * T)
    ops = 8 * B * T * F + 2 * B * T
    return max(moved / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S) * 1e3


def kernel_phase():
    results = {}
    B, T, F, M = SERVE_SHAPE
    errs = {k: 0.0 for k in KERNELS}
    for i, (b, t, f, m) in enumerate([SERVE_SHAPE, *RAGGED]):
        args = make_case(b, t, f, m, seed=i)
        got = score.banked_anomaly_score(*args)
        torch.cuda.synchronize()
        errs["banked_anomaly_score"] = max(errs["banked_anomaly_score"], compare(
            got, score.banked_score_plain(*args), f"banked {b}x{t}x{f}"))
        tgt, out, sh, sc, ix = args
        m0 = int(ix[0])
        single = (tgt[0].contiguous(), out[0].contiguous(), sh[m0].contiguous(), sc[m0].contiguous())
        got = score.fused_anomaly_score(*single)
        torch.cuda.synchronize()
        errs["fused_anomaly_score"] = max(errs["fused_anomaly_score"], compare(
            got, score.score_plain(*single), f"fused {t}x{f}"))
    # times at the main path's shapes: a full coalesced batch, and one
    # detector's 64-row request
    args = make_case(B, T, F, M, seed=99)
    tgt, out, sh, sc, ix = args
    single = (tgt[0].contiguous(), out[0].contiguous(), sh[int(ix[0])].contiguous(),
              sc[int(ix[0])].contiguous())
    timed = {
        "banked_anomaly_score": (score.banked_anomaly_score, score.banked_score_plain,
                                 library_banked, args, bound_ms(B, T, F, ix)),
        "fused_anomaly_score": (score.fused_anomaly_score, score.score_plain,
                                library_fused, single,
                                bound_ms(1, T, F, ix[:1])),
    }
    for name, (kernel, plain, library, a, bound) in timed.items():
        results[name] = {
            "name": name, "route": "cuda", "source": SOURCE, "replaces": KERNELS[name],
            "launches": None, "max_abs_err": errs[name],
            "ms": time_ms(kernel, a), "plain_ms": time_ms(plain, a),
            "bound_ms": bound, "bound_by": "bytes", "library_ms": time_ms(library, a),
        }
        phase("parity", kernel=name, shapes=1 + len(RAGGED), bitwise="diff,scaled",
              max_norm_err=errs[name], kernel_device_us=kernel_device_us(kernel, a),
              ms=round(results[name]["ms"], 5),
              plain_ms=round(results[name]["plain_ms"], 5),
              library_ms=round(results[name]["library_ms"], 5), bound_ms=round(bound, 6))
    return results


# ------------------------------------------------------------------ #
# phases 4-5: the served path
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


def http_json(url: str, body=None, raw: bytes = None):
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def check_arrays(got: dict, want: dict, what: str) -> None:
    for key, w in want.items():
        g = np.asarray(got[key], np.float32)
        if g.shape != w.shape or not np.all(np.isfinite(g)):
            raise AssertionError(f"{what}: {key} has shape {g.shape} or non-finite values")
        err = float(np.abs(g - w).max())
        if err > E2E_ATOL:
            raise AssertionError(f"{what}: {key} off by {err} > {E2E_ATOL}")


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
    server = run_server(MODEL_DIR, host="127.0.0.1", port=0, background=True)
    try:
        base = server.url + "/gordo/v0/smoke"
        status, models = http_json(base + "/models")
        if status != 200 or models["models"] != sorted(widths) or models["bank"]["n_buckets"] != 2:
            raise AssertionError(f"/models answered {status}: {models}")
        status, body = http_json(base + "/m000/healthcheck")
        if status != 200 or "gordo-server-version" not in body:
            raise AssertionError(f"healthcheck answered {status}: {body}")
        # 64 concurrent POSTs of 64 rows: 56 to the 10-tag bucket, 8 to the 40-tag one
        targets = [f"m{i:03d}" for i in range(56)] + [f"w{i:03d}" for i in range(8)]
        index = [f"2020-01-01T{m // 60:02d}:{m % 60:02d}:00Z" for m in range(0, 128, 2)]
        want_index = [s.replace("Z", "+00:00") for s in index]
        X = {t: rng.random((64, widths[t])).astype(np.float32) for t in targets}
        replies = {}

        def post(t):
            replies[t] = http_json(f"{base}/{t}/anomaly/prediction",
                                   {"X": X[t].tolist(), "index": index})

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
            if body["index"] != want_index:
                raise AssertionError(f"{t}: index {body['index'][:2]}...")
            path = os.path.join(MODEL_DIR, t)
            plain = serializer.load(path, device="cpu").anomaly(X[t])
            check_arrays(response_arrays(body, [f"tag-{i}" for i in range(widths[t])]), plain,
                         f"http {t}")
            # the detector's own anomaly() on the card: the per-model kernel
            check_arrays(serializer.load(path).anomaly(X[t]), plain, f"detector {t}")
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
    phase("http", models=len(widths), buckets=2, posts=len(targets), rows=64,
          wall_s=round(wall, 4), engine_batches=batches, checked="all six arrays vs CPU plain",
          status_400=True, status_404=True)


def bank_phase(card: str):
    rng = np.random.default_rng(2)
    n_members, n_clients, n_requests, n_rows = 10_000, 64, 4, 64
    t0 = time.perf_counter()
    entries = [random_entry(f"m{i:05d}", 10, rng) for i in range(n_members)]
    bank = ModelBank.from_entries(entries)
    build_s = time.perf_counter() - t0
    engine = BatchingEngine(bank, max_batch=64, flush_ms=2.0)
    engine.start()
    try:
        X = rng.random((n_clients, n_requests, n_rows, 10)).astype(np.float32)
        names = [[entries[int(j)].name for j in rng.integers(0, n_members, n_requests)]
                 for _ in range(n_clients)]
        engine.score_blocking(names[0][0], X[0, 0])  # first batch pays allocator warm-up
        before = dict(engine.stats)
        launches_before = score.launch_counts["banked_anomaly_score"]
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
        stats["launches"] = score.launch_counts["banked_anomaly_score"] - launches_before
    finally:
        engine.stop()
    from gordo_components_torch.models.anomaly.diff import DiffBasedAnomalyDetector

    by_name = {e.name: e for e in entries}
    for (c, r), res in results.items():
        arrays = res.to_arrays()
        if not all(np.all(np.isfinite(a)) for a in arrays.values()):
            raise AssertionError(f"bank phase: non-finite scores for {names[c][r]}")
        if c % 8 == 0:  # hold a sample against the CPU plain computation
            plain = DiffBasedAnomalyDetector.from_entry(by_name[names[c][r]], device="cpu")
            check_arrays(arrays, plain.anomaly(X[c, r]), f"bank {names[c][r]}")
    lat_ms = np.asarray(lat) * 1e3
    summary = {
        "members": n_members, "clients": n_clients, "requests": len(results),
        "rows_per_request": n_rows, "build_s": round(build_s, 3),
        "p50_ms": round(float(np.percentile(lat_ms, 50)), 4),
        "p99_ms": round(float(np.percentile(lat_ms, 99)), 4),
        "samples_per_s": round(len(results) * n_rows / wall, 1),
        "avg_batch": round(stats["requests"] / max(stats["batches"], 1), 3),
        "batches": stats["batches"], "max_batch_seen": stats["max_batch_seen"],
        "banked_launches_per_batch": round(stats["launches"] / max(stats["batches"], 1), 3),
    }
    phase("bank", **summary, card=json.dumps(card))
    return summary


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
          libraries=",".join(sorted(libs)), flags=json.dumps(" ".join(_cuda.NVCC_FLAGS)))

    kernels = kernel_phase()

    score.reset_launch_counts()
    http_phase()
    after_http = dict(score.launch_counts)
    bank_phase(card)
    counts = dict(score.launch_counts)
    phase("counts", **{f"{k}_http": v for k, v in after_http.items()},
          **{f"{k}_bank": counts[k] - after_http[k] for k in counts})
    for name, n in counts.items():
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
