"""The port's scoring pipeline and padded-buffer arena, on the CPU, against
the JAX package's.

A four-bucket bank (dense, LSTM, conv and dense bfloat16 members, random
weights from a seed) scores a mixed batch (odd lengths, one request
chunked past ``max_rows_per_call``) at windows 1, 2 and 4: every result
is bitwise window 1's, and each matches the JAX bank on the same weights
(its Pallas kernel in interpret mode) within the bands of
tests/test_torch_bank.py, tests/test_torch_seq_bank.py and
tests/test_torch_bf16.py. Then the cases of tests/test_bank_pipeline.py:
the arena's LRU bound, an oversized buffer, dtype keys, pooling disabled,
counters monotonic across a /reload's bank; a recycled dirty buffer; one
group's failure, in a call and through the engine; a failure mid-pipeline
that drains and releases; the environment's knobs; the warmup's shape
grid against the shapes ``score_many`` dispatches; the stage spans.
"""

import dataclasses

import numpy as np
import pytest

from gordo_components_torch.convert import entry_from_numpy, params_to_flax
from gordo_components_torch.models import lookup_factory
from gordo_components_torch.observability.metrics import MetricsRegistry
from gordo_components_torch.observability.tracing import Tracer
from gordo_components_torch.server import BatchingEngine, ModelBank
from gordo_components_torch.server.arena import PaddedArena
from gordo_components_tpu.server import bank as jax_bank_module

F = 3
BF16 = "bfloat16"
# name prefix -> (registry type, kind, factory kwargs, lookback, compute dtype)
FAMILIES = {
    "dense": ("AutoEncoder", "feedforward_model", {"encoding_dim": (4,), "decoding_dim": (4,)}, 1, "float32"),
    "lstm": ("LSTMAutoEncoder", "lstm_model", {"dims": (4,)}, 6, "float32"),
    "conv": ("ConvAutoEncoder", "conv1d_autoencoder", {"channels": (4, 2), "kernel_size": 3}, 8, "float32"),
    "bf16": ("AutoEncoder", "feedforward_model", {"encoding_dim": (4,), "decoding_dim": (4,)}, 1, BF16),
}
# port against JAX: the dense band (tests/test_torch_bank.py), the sequence
# one (tests/test_torch_seq_bank.py, tests/test_torch_conv.py) and the
# bfloat16 ceiling (tests/test_torch_bf16.py) times max(1, |x|)
BANDS = {"dense": dict(rtol=0, atol=1e-5), "lstm": dict(rtol=1e-4, atol=1e-5), "conv": dict(rtol=1e-4, atol=1e-5)}
BF16_CEILING = 2e-2
KEYS = ("model-input", "model-output", "tag-anomaly-unscaled", "tag-anomaly-scaled",
        "total-anomaly-unscaled", "total-anomaly-scaled")


def _pieces(family, rng):
    """(flax params, in_shift, in_scale, err_shift, err_scale) at random."""
    rt, kind, kw, _lb, dtype = FAMILIES[family]
    state = {k: (rng.standard_normal(tuple(v.shape)) / np.sqrt(max(1, v.shape[0]))).astype("f4")
             for k, v in lookup_factory(rt, kind)(F, **kw).state_dict().items()}
    scalers = (0.1 * rng.standard_normal(F), 1.0 + rng.random(F), 0.05 * rng.random(F), 1.0 + rng.random(F))
    return params_to_flax(state), *(np.asarray(s, np.float32) for s in scalers)


@pytest.fixture(scope="module")
def fleet():
    """Two members a family: the port's entries and the JAX bank's."""
    rng = np.random.default_rng(0)
    port, jax_entries = [], {}
    for family, (rt, kind, kw, lookback, dtype) in FAMILIES.items():
        for i in range(2):
            name = f"{family}-{i}"
            params, *scalers = _pieces(family, rng)
            seq = rt != "AutoEncoder"
            port.append(entry_from_numpy(name, rt, kind, kw, F, params, *scalers,
                                         lookback=lookback if seq else 1, compute_dtype=dtype))
            jax_entries[name] = jax_bank_module._BankEntry(
                name=name, registry_type=rt, kind=kind, factory_kwargs=dict(kw), compute_dtype=dtype, n_features=F,
                lookback=lookback if seq else 1, target_offset=0, params=params, in_shift=scalers[0],
                in_scale=scalers[1], err_shift=scalers[2], err_scale=scalers[3])
    return port, jax_entries


def _requests(seed=1, long_rows=150):
    rng = np.random.default_rng(seed)
    rows = {"dense-0": 37, "conv-1": 29, "lstm-0": long_rows, "bf16-1": 21, "dense-1": 12, "lstm-1": 9,
            "conv-0": 64, "bf16-0": 5}
    out = []
    for name, n in rows.items():
        X = rng.random((n, F), dtype=np.float32)
        y = rng.random((n, F), dtype=np.float32) if name == "dense-1" else None
        out.append((name, X, y))
    return out


def _bank(entries, **kwargs):
    return ModelBank.from_entries(entries, device="cpu", max_rows_per_call=32, **kwargs)


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key, value in w.to_arrays().items():
            np.testing.assert_array_equal(g.to_arrays()[key], value, err_msg=key)
        assert (g.offset, g.tags) == (w.offset, w.tags)


@pytest.mark.parametrize("window", [2, 4])
def test_windows_are_bitwise_the_serial_order(fleet, window):
    entries, _ = fleet
    serial = _bank(entries, inflight=1, arena_max_mb=0)
    piped = _bank(entries, inflight=window, registry=MetricsRegistry())
    requests = _requests()
    want = serial.score_many(requests)
    for _ in range(3):  # the arena recycles its buffers from the second call on
        _assert_bitwise(piped.score_many(requests), want)
    stats = piped.pipeline_stats()
    assert stats["inflight_window"] == window and piped.inflight_peak == window
    assert stats["overlap"]["calls"] == stats["overlap"]["multi_group_calls"] == 3
    assert stats["arena"]["outstanding"] == 0 and stats["arena"]["hits"] > 0
    # results are copies, never views into a pooled buffer
    pooled = [buf for stack in piped.arena._pool.values() for buf in stack]
    assert not any(np.shares_memory(a, buf) for r in piped.score_many(requests) for buf in pooled
                   for a in (r.model_output, r.diff, r.scaled, r.total_unscaled, r.total_scaled))


def test_each_result_matches_the_jax_bank(fleet, monkeypatch):
    entries, jax_entries = fleet
    # the JAX bank over the same weights: its own from_models, given the entries
    monkeypatch.setattr(jax_bank_module, "_extract_entry", lambda name, model: (model, None))
    jax_bank = jax_bank_module.ModelBank.from_models(jax_entries, max_rows_per_call=32, registry=False,
                                                     bank_kernel="interpret", inflight=2)
    requests = _requests(seed=2)
    want = jax_bank.score_many(requests)
    for window in (1, 2, 4):
        got = _bank(entries, inflight=window).score_many(requests)
        for (name, _X, _y), g, w in zip(requests, got, want):
            family = name.split("-")[0]
            assert g.offset == w.offset, name
            for key in KEYS:
                gv, wv = g.to_arrays()[key], np.asarray(w.to_arrays()[key])
                assert gv.shape == wv.shape, (name, key)
                if family == "bf16":
                    atol = BF16_CEILING * max(1.0, float(np.abs(wv).max()))
                    np.testing.assert_allclose(gv, wv, rtol=0, atol=atol, err_msg=f"{name} {key}")
                else:
                    np.testing.assert_allclose(gv, wv, **BANDS[family], err_msg=f"{name} {key}")


def test_a_recycled_buffer_leaks_nothing(fleet):
    entries, _ = fleet
    serial = _bank(entries, inflight=1, arena_max_mb=0)
    piped = _bank(entries, inflight=2)
    rng = np.random.default_rng(3)
    piped.score_many([("dense-0", (100.0 * rng.random((61, F))).astype("f4"), None)])  # poison the pool
    hits = piped.arena.hits
    short = [("dense-0", rng.random((40, F), dtype=np.float32), None)]  # the same (1, 64) shape
    got = piped.score_many(short)
    assert piped.arena.hits > hits
    _assert_bitwise(got, serial.score_many(short))
    assert piped.arena.outstanding == 0


# --------------------------------------------------------------------- #
# the arena (tests/test_bank_pipeline.py's cases)
# --------------------------------------------------------------------- #


def test_arena_lru_bound_and_accounting():
    shapes = ((4, 64, 10), (2, 128, 10), (8, 32, 10))  # 10 KiB each; the budget holds two
    nbytes = int(np.zeros(shapes[0], np.float32).nbytes)
    arena = PaddedArena(max_bytes=2 * nbytes)
    a, clean_a = arena.acquire(shapes[0])
    b, _ = arena.acquire(shapes[1])
    c, _ = arena.acquire(shapes[2])
    assert clean_a and arena.misses == 3 and arena.outstanding == 3 and not arena.pinned
    for buf in (a, b, c):
        arena.release(buf)
    stats = arena.stats()
    assert stats["outstanding"] == 0 and stats["pooled_bytes"] == arena.max_bytes and stats["evictions"] == 1
    again, clean_again = arena.acquire(shapes[2])
    assert again is c and not clean_again
    fresh, clean_fresh = arena.acquire(shapes[0])
    assert clean_fresh and fresh is not a
    assert arena.hits == 1 and arena.misses == 4


def test_arena_oversized_buffer_never_evicts_the_pool():
    small_shape = (4, 64, 10)
    small_bytes = int(np.zeros(small_shape, np.float32).nbytes)
    arena = PaddedArena(max_bytes=4 * small_bytes)
    small, _ = arena.acquire(small_shape)
    big, _ = arena.acquire((64, 64, 10))
    arena.release(small)
    arena.release(big)
    stats = arena.stats()
    assert stats["outstanding"] == 0 and stats["evictions"] == 1 and stats["pooled_bytes"] == small_bytes
    again, clean = arena.acquire(small_shape)
    assert again is small and not clean


def test_arena_keys_on_dtype():
    shape = (4, 64)
    arena = PaddedArena(max_bytes=64 * 1024 * 1024)
    f32, clean_f32 = arena.acquire(shape, np.float32)
    i32, clean_i32 = arena.acquire(shape, np.int32)
    assert clean_f32 and clean_i32 and f32 is not i32 and (f32.dtype, i32.dtype) == (np.float32, np.int32)
    arena.release(f32)
    arena.release(i32)
    assert arena.acquire(shape, np.float32) == (f32, False)
    assert arena.acquire(shape, np.int32)[0] is i32
    assert arena.hits == 2 and arena.misses == 2 and arena.outstanding == 2


def test_arena_disabled_is_plain_zeros(monkeypatch):
    arena = PaddedArena(max_bytes=0)
    buf, clean = arena.acquire((2, 8, 3))
    assert clean and not np.any(buf)
    arena.release(buf)
    stats = arena.stats()
    assert stats["enabled"] is False and stats["hits"] == stats["misses"] == stats["outstanding"] == 0
    monkeypatch.setenv("GORDO_ARENA_MAX_MB", "0")
    assert PaddedArena().enabled is False
    monkeypatch.setenv("GORDO_ARENA_MAX_MB", "lots")
    with pytest.raises(ValueError, match="GORDO_ARENA_MAX_MB"):
        PaddedArena()


def _scraped(registry, name):
    for line in registry.render().splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise AssertionError(f"{name} not rendered")


def test_arena_counters_monotonic_across_reload(fleet):
    entries, _ = fleet
    registry = MetricsRegistry()
    X = np.random.default_rng(4).random((30, F), dtype=np.float32)
    bank1 = _bank(entries, registry=registry)
    for _ in range(2):
        bank1.score_many([("dense-0", X, None)] * 2)
    total1 = bank1.arena.hits + bank1.arena.misses
    assert bank1.arena.hits > 0 and _scraped(registry, "gordo_bank_arena_hits_total") == bank1.arena.hits
    bank2 = _bank(entries, registry=registry)  # a /reload's bank, on the app's registry
    assert _scraped(registry, "gordo_bank_arena_hits_total") + _scraped(
        registry, "gordo_bank_arena_misses_total") == total1
    bank2.score_many([("dense-0", X, None)] * 2)
    assert _scraped(registry, "gordo_bank_arena_hits_total") + _scraped(
        registry, "gordo_bank_arena_misses_total") == total1 + bank2.arena.hits + bank2.arena.misses
    assert _scraped(registry, "gordo_bank_inflight_groups") == 0
    pooled = bank1.arena.pooled_bytes + bank2.arena.pooled_bytes  # the old bank's gauge while it lives
    assert _scraped(registry, "gordo_bank_arena_bytes") == pooled
    del bank1
    import gc

    gc.collect()
    assert _scraped(registry, "gordo_bank_arena_bytes") == bank2.arena.pooled_bytes
    assert _scraped(registry, "gordo_bank_arena_hits_total") + _scraped(
        registry, "gordo_bank_arena_misses_total") == total1 + bank2.arena.hits + bank2.arena.misses


def test_env_knobs_configure_the_pipeline(fleet, monkeypatch):
    entries, _ = fleet
    monkeypatch.setenv("GORDO_BANK_INFLIGHT", "3")
    monkeypatch.setenv("GORDO_ARENA_MAX_MB", "1")
    bank = _bank(entries)
    assert bank._inflight_window == 3 and bank.arena.max_bytes == 1024 * 1024
    monkeypatch.setenv("GORDO_BANK_INFLIGHT", "0")  # clamped to serial
    assert _bank(entries)._inflight_window == 1
    monkeypatch.setenv("GORDO_BANK_INFLIGHT", "nope")
    with pytest.raises(ValueError, match="GORDO_BANK_INFLIGHT"):
        _bank(entries)


# --------------------------------------------------------------------- #
# failures
# --------------------------------------------------------------------- #


def _failing_once(bucket, monkeypatch, message="injected"):
    real = bucket.score_batch
    fired = []

    def score_batch(*args):
        if not fired:
            fired.append(1)
            raise RuntimeError(message)
        return real(*args)

    monkeypatch.setattr(bucket, "score_batch", score_batch)
    return fired


def test_partial_results_fail_only_the_owning_group(fleet, monkeypatch):
    entries, _ = fleet
    serial = _bank(entries, inflight=1, arena_max_mb=0)
    piped = _bank(entries, inflight=2)
    requests = _requests(seed=5)
    want = serial.score_many(requests)
    lstm = piped._buckets[piped._index["lstm-0"][0]]
    _failing_once(lstm, monkeypatch)
    got = piped.score_many(requests, return_exceptions=True)
    for (name, _X, _y), g, w in zip(requests, got, want):
        if name.startswith("lstm"):
            assert isinstance(g, RuntimeError), name
        else:
            _assert_bitwise([g], [w])
    assert piped.arena.outstanding == 0


def test_the_engine_rescores_only_the_failed_group(fleet, monkeypatch):
    entries, _ = fleet
    bank = _bank(entries, inflight=2)
    dispatched = []
    real = bank._dispatch

    def counting(run):
        dispatched.append(run.bucket.label)
        return real(run)

    monkeypatch.setattr(bank, "_dispatch", counting)
    _failing_once(bank._buckets[bank._index["dense-0"][0]], monkeypatch)
    engine = BatchingEngine(bank, max_batch=8, flush_ms=200.0)
    engine.start()
    try:
        X = np.random.default_rng(6).random((30, F), dtype=np.float32)
        futures = [engine.submit(n, X) for n in ("dense-0", "dense-1", "conv-0", "lstm-0")]
        results = [f.result(60) for f in futures]
    finally:
        engine.stop()
    assert all(np.isfinite(r.total_scaled).all() for r in results)
    label = {n: bank._buckets[bank._index[n][0]].label for n in ("dense-0", "conv-0", "lstm-0")}
    # three groups in the batch (the dense one failed), then the dense
    # group's two requests again, alone
    assert dispatched.count(label["dense-0"]) == 3 and len(dispatched) == 5
    assert dispatched.count(label["conv-0"]) == dispatched.count(label["lstm-0"]) == 1
    assert bank.arena.outstanding == 0


def test_a_failure_mid_pipeline_drains_and_releases(fleet, monkeypatch):
    entries, _ = fleet
    bank = _bank(entries, inflight=2)
    requests = [("dense-0", np.ones((30, F), np.float32), None), ("conv-0", np.ones((30, F), np.float32), None)]

    def boom(*args):
        raise RuntimeError("second-group dispatch died")

    monkeypatch.setattr(bank._buckets[bank._index["conv-0"][0]], "score_batch", boom)
    tracer = Tracer(sample=1.0)
    traces = [tracer.start_trace("bench") for _ in requests]
    with pytest.raises(RuntimeError, match="second-group"):
        # the first group is still in flight when the second one's dispatch raises
        bank.score_many(requests, traces=traces)
    assert bank.arena.outstanding == 0 and bank._inflight_now == 0
    for trace in traces:
        trace.finish(error=True)
        assert trace.error and all(s.end is not None for s in trace.spans)
    assert tracer.inflight == 0
    monkeypatch.undo()
    assert all(np.isfinite(r.total_scaled).all() for r in bank.score_many(requests))


# --------------------------------------------------------------------- #
# warmup and spans
# --------------------------------------------------------------------- #


def _pooled_shapes(bank):
    return sorted(key[0] for key in bank.arena._pool)


@pytest.mark.parametrize("rows,batches,max_rows", [((64, 128), (1, 4), 8192), (500, (8,), 32), ((3, 33), (3,), 8192)])
def test_warmup_fills_the_shapes_score_many_dispatches(fleet, rows, batches, max_rows):
    entries, _ = fleet
    dense = [e for e in entries if e.name.startswith("dense")]
    bank = ModelBank.from_entries(dense, device="cpu", max_rows_per_call=max_rows)
    assert bank.warmup(rows=rows, batch_sizes=batches) == 1
    (bucket,) = bank._buckets.values()
    grid = bank.warmup_shapes(bucket, rows if isinstance(rows, tuple) else (rows,), batches)
    warmed = _pooled_shapes(bank)
    assert warmed == sorted({(B, T, F) for T, B in grid} | {(B,) for _T, B in grid})
    misses = bank.arena.misses
    rng = np.random.default_rng(7)
    for T, B in grid:  # a request of T rows, B of them: exactly a warmed shape
        n = min(T, max(r for r in (rows if isinstance(rows, tuple) else (rows,))))
        bank.score_many([("dense-0", rng.random((n, F), dtype=np.float32), None)] * B)
    assert bank.arena.misses == misses and _pooled_shapes(bank) == warmed


def test_warmup_env_grid(fleet, monkeypatch):
    entries, _ = fleet
    bank = ModelBank.from_entries([e for e in entries if e.name.startswith("lstm")], device="cpu")
    monkeypatch.setenv("GORDO_WARMUP_ROWS", "64")
    monkeypatch.setenv("GORDO_WARMUP_BATCHES", "1,2")
    assert bank.warmup() == 1
    assert _pooled_shapes(bank) == [(1,), (1, 64, F), (2,), (2, 64, F)]
    monkeypatch.setenv("GORDO_WARMUP_BATCHES", "wat")  # falls back to batch 1
    assert bank.warmup(rows=64) == 1 and _pooled_shapes(bank) == [(1,), (1, 64, F), (2,), (2, 64, F)]


def test_stage_spans_and_the_overlap_span(fleet):
    entries, _ = fleet
    bank = _bank(entries, inflight=2)
    requests = _requests(seed=8)
    tracer = Tracer(sample=1.0, ring=16, slow_keep=16)
    traces = [tracer.start_trace("bench") for _ in requests]
    busy = bank.pipeline_stats()["overlap"]["device_busy_s"]
    bank.score_many(requests, traces=traces)
    for trace in traces:
        names = [s.name for s in trace.spans]
        for stage in ("coalesce", "pad", "device_execute", "postprocess"):
            assert names.count(stage) == 1, names
        (overlap,) = [s for s in trace.spans if s.name == "pipeline_overlap"]
        assert overlap.attributes["groups"] == 4 and overlap.attributes["window"] == 2
        trace.finish()
    assert bank.pipeline_stats()["overlap"]["device_busy_s"] > busy


def test_a_bfloat16_bucket_is_a_group_of_its_own(fleet):
    entries, _ = fleet
    twins = [e for e in entries if e.name == "dense-0"]
    twins.append(dataclasses.replace(twins[0], name="dense-0-bf16", compute_dtype=BF16))
    bank = _bank(twins, inflight=2)
    X = np.random.default_rng(9).random((20, F), dtype=np.float32)
    a, b = bank.score_many([("dense-0", X, None), ("dense-0-bf16", X, None)])
    assert bank.n_buckets == 2 and bank.pipeline_stats()["overlap"]["multi_group_calls"] == 1
    # the same weights in another dtype: another answer, in float32 all the same
    assert b.model_output.dtype == np.float32 and not np.array_equal(a.model_output, b.model_output)
    np.testing.assert_allclose(b.model_output, a.model_output, rtol=0,
                               atol=BF16_CEILING * max(1.0, float(np.abs(a.model_output).max())))
