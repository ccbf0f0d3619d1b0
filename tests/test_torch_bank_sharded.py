"""The port's sharded bank (``server/bank.py`` over a ``parallel/mesh.py``
mesh) on logical CPU shards, against its unsharded bank and the JAX
package's sharded bank (after tests/test_bank_sharded.py).

The JAX bank shards over the 8 virtual CPU devices of tests/conftest.py;
the port's over a mesh naming the CPU several times (its logical shards),
which ``fleet_mesh(devices=...)`` builds and ``build_app(devices=)`` counts
once a test patches ``parallel.mesh.available_devices``.

- **Bitwise against the unsharded port bank** at the same batch
  composition, for dense, LSTM, conv and bfloat16 members over 2, 4 and 8
  shards: one request at a time and one heterogeneous batch, fewer members
  than shards (the stack padded by repeating a member), long requests
  chunked past ``max_rows_per_call``.
- **Against the JAX sharded bank** on the same weights (its Pallas kernel in
  interpret mode) within the bands of tests/test_torch_pipeline.py.
- **The router.** Each shard's stack holds its contiguous block, the
  shard counters count each shard's rows, pad rows and chunks as the JAX
  bank's do, every group dispatches every shard once, the placement and
  ``coverage()["devices"]`` name the shards, and the warm-up warms every
  bucket.
- **The app.** ``build_app(devices=8)`` serves sharded and answers as
  ``devices=1``; a count above the devices present clamps with the JAX
  warning; ``/reload`` rebuilds under the same mesh; the batching engine
  over a sharded bank coalesces and answers within rtol 1e-5 / atol 1e-6 of
  single requests (the JAX test's band); a mesh naming a card that is not
  there raises.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from gordo_components_torch.convert import entry_from_numpy, params_to_flax
from gordo_components_torch import serializer
from gordo_components_torch.models import lookup_factory
from gordo_components_torch.observability.metrics import MetricsRegistry
from gordo_components_torch.parallel import mesh as port_mesh
from gordo_components_torch.server import BatchingEngine, ModelBank, build_app, run_server
from gordo_components_tpu.parallel.mesh import fleet_mesh as jax_fleet_mesh
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
# port against JAX (tests/test_torch_pipeline.py)
BANDS = {"dense": dict(rtol=0, atol=1e-5), "lstm": dict(rtol=1e-4, atol=1e-5), "conv": dict(rtol=1e-4, atol=1e-5)}
BF16_CEILING = 2e-2
ENGINE_BAND = dict(rtol=1e-5, atol=1e-6)  # tests/test_bank_sharded.py:233-240
KEYS = ("model-input", "model-output", "tag-anomaly-unscaled", "tag-anomaly-scaled",
        "total-anomaly-unscaled", "total-anomaly-scaled")
P = "/gordo/v0/p"


def _pieces(family, rng):
    rt, kind, kw, _lb, _dtype = FAMILIES[family]
    state = {k: (rng.standard_normal(tuple(v.shape)) / np.sqrt(max(1, v.shape[0]))).astype("f4")
             for k, v in lookup_factory(rt, kind)(F, **kw).state_dict().items()}
    scalers = (0.1 * rng.standard_normal(F), 1.0 + rng.random(F), 0.05 * rng.random(F), 1.0 + rng.random(F))
    return params_to_flax(state), *(np.asarray(s, np.float32) for s in scalers)


def _fleet(per_family, seed=0):
    """``per_family`` members a family: the port's entries and the JAX bank's."""
    rng = np.random.default_rng(seed)
    port, jax_entries = [], {}
    for family, (rt, kind, kw, lookback, dtype) in FAMILIES.items():
        for i in range(per_family):
            name = f"{family}-{i}"
            params, *scalers = _pieces(family, rng)
            lb = lookback if rt != "AutoEncoder" else 1
            port.append(entry_from_numpy(name, rt, kind, kw, F, params, *scalers, lookback=lb, compute_dtype=dtype))
            jax_entries[name] = jax_bank_module._BankEntry(
                name=name, registry_type=rt, kind=kind, factory_kwargs=dict(kw), compute_dtype=dtype, n_features=F,
                lookback=lb, target_offset=0, params=params, in_shift=scalers[0], in_scale=scalers[1],
                err_shift=scalers[2], err_scale=scalers[3])
    return port, jax_entries


@pytest.fixture(scope="module")
def fleet():
    return _fleet(5)  # 5 a bucket: padded to 6 or 8 over 2, 4 and 8 shards


def _requests(entries, seed=1, rows=(20, 37, 9, 64, 150)):
    rng = np.random.default_rng(seed)
    return [(e.name, rng.random((rows[i % len(rows)], F), dtype=np.float32), None) for i, e in enumerate(entries)]


def _mesh(n):
    return port_mesh.fleet_mesh(devices=["cpu"] * n)


def _assert_bitwise(got, want):
    for key, value in want.to_arrays().items():
        np.testing.assert_array_equal(got.to_arrays()[key], value, err_msg=key)
    assert (got.offset, got.tags) == (want.offset, want.tags)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_bank_is_bitwise_the_unsharded_one(fleet, shards):
    entries, _ = fleet
    single = ModelBank.from_entries(entries, device="cpu", registry=False)
    sharded = ModelBank.from_entries(entries, mesh=_mesh(shards), registry=False)
    assert len(sharded) == len(single) == len(entries)
    for bucket in sharded._buckets.values():
        assert bucket.n_shards == shards and len(bucket.shards) == shards
        assert bucket.shard_size == -(-5 // shards) and bucket.members == 5
        assert all(s.device == torch.device("cpu") for s in bucket.shards)
    requests = _requests(entries)
    for req in requests:  # one at a time
        _assert_bitwise(sharded.score(*req), single.score(*req))
    for g, w in zip(sharded.score_many(requests), single.score_many(requests)):  # heterogeneous
        _assert_bitwise(g, w)


def test_sharded_bank_matches_the_jax_sharded_bank(fleet, monkeypatch):
    entries, jax_entries = fleet
    monkeypatch.setattr(jax_bank_module, "_extract_entry", lambda name, model: (model, None))
    jax_bank = jax_bank_module.ModelBank.from_models(jax_entries, mesh=jax_fleet_mesh(), registry=False,
                                                     bank_kernel="interpret")
    sharded = ModelBank.from_entries(entries, mesh=_mesh(8), registry=False)
    requests = _requests(entries, seed=2)
    for (name, _X, _y), g, w in zip(requests, sharded.score_many(requests), jax_bank.score_many(requests)):
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
    # the same placement: members in stack order, D shards, the padded block
    # (the bucket labels are each bank's own)
    def placement(bank):
        return sorted((b["members"], b["n_shards"], b["shard_size"]) for b in bank.placement()["buckets"])

    assert placement(sharded) == placement(jax_bank)


def test_fewer_members_than_shards():
    """3 members over 8 shards: the stack is padded by repeating the last
    member, and no answer changes."""
    entries = [e for e in _fleet(3, seed=3)[0] if e.name.startswith("dense")]
    single = ModelBank.from_entries(entries, device="cpu", registry=False)
    sharded = ModelBank.from_entries(entries, mesh=_mesh(8), registry=False)
    (bucket,) = sharded._buckets.values()
    assert (bucket.shard_size, bucket.members, len(bucket.names)) == (1, 3, 3)
    X = np.random.default_rng(4).random((25, F), dtype=np.float32)
    for e in entries:
        _assert_bitwise(sharded.score(e.name, X), single.score(e.name, X))


def test_long_requests_chunk_as_unsharded(fleet):
    entries, _ = fleet
    single = ModelBank.from_entries(entries, device="cpu", registry=False, max_rows_per_call=32)
    sharded = ModelBank.from_entries(entries, mesh=_mesh(4), registry=False, max_rows_per_call=32)
    big = np.random.default_rng(5).random((360, F), dtype=np.float32)
    for name in ("dense-3", "lstm-1", "conv-4"):
        got = sharded.score(name, big)
        assert len(got.model_output) == len(big) - got.offset
        _assert_bitwise(got, single.score(name, big))


def test_router_counts_each_shard_as_the_jax_bank(fleet, monkeypatch):
    """One request each for dense-0 (shard 0) and dense-4 (shard 2 of 4):
    per-shard routed rows, pad rows and chunks as the JAX bank counts them,
    every shard dispatched once a group."""
    entries, jax_entries = fleet
    dense = [e for e in entries if e.name.startswith("dense")]
    registry = MetricsRegistry()
    sharded = ModelBank.from_entries(dense, mesh=_mesh(4), registry=registry)
    monkeypatch.setattr(jax_bank_module, "_extract_entry", lambda name, model: (model, None))
    from gordo_components_tpu.observability import MetricsRegistry as JaxRegistry

    jax_registry = JaxRegistry()
    jax_bank = jax_bank_module.ModelBank.from_models({e.name: jax_entries[e.name] for e in dense},
                                                     mesh=jax_fleet_mesh(4), registry=jax_registry,
                                                     bank_kernel="interpret")
    X = np.random.default_rng(6).random((20, F), dtype=np.float32)
    reqs = [("dense-0", X, None), ("dense-4", X[:7], None), ("dense-0", X[:3], None)]
    sharded.score_many(reqs)
    jax_bank.score_many(reqs)

    def shard_series(snap):
        return {name: sorted((v["labels"]["shard"], v["value"]) for v in snap[name]["values"])
                for name in ("gordo_bank_shard_routed_rows_total", "gordo_bank_shard_padded_rows_total",
                             "gordo_bank_shard_requests_total")}

    assert shard_series(registry.snapshot()) == shard_series(jax_registry.snapshot())
    assert shard_series(registry.snapshot())["gordo_bank_shard_routed_rows_total"] == [
        ("0", 23), ("1", 0), ("2", 7), ("3", 0)]
    assert sharded.shard_launches == {0: 1, 1: 1, 2: 1, 3: 1}
    assert sharded.model_rows == {"dense-0": 23, "dense-4": 7}
    assert sharded.coverage()["devices"] == 4 and sharded.placement()["devices"] == 4
    # the unsharded bank counts everything under shard "0", as the JAX one
    flat_registry = MetricsRegistry()
    ModelBank.from_entries(dense, device="cpu", registry=flat_registry).score_many(reqs)
    assert shard_series(flat_registry.snapshot())["gordo_bank_shard_routed_rows_total"] == [("0", 30)]


def test_sharded_warmup_warms_every_bucket(fleet):
    entries, _ = fleet
    sharded = ModelBank.from_entries(entries, mesh=_mesh(4), registry=False)
    assert sharded.warmup(rows=64) == sharded.n_buckets == 4
    assert sum(sharded.shard_launches.values()) == 4 * 4


def test_a_mesh_naming_a_missing_card_raises():
    """Never lands on the CPU: a card past those present raises (here,
    without CUDA, any card), and so does a mesh of no device."""
    with pytest.raises(RuntimeError):
        port_mesh.fleet_mesh(devices=[f"cuda:{torch.cuda.device_count()}"] * 2)
    with pytest.raises(RuntimeError, match="no cuda device"):
        port_mesh.fleet_mesh(n_devices=0, kind="cuda")
    assert port_mesh.fleet_mesh(devices=["cpu"] * 3).devices == (torch.device("cpu"),) * 3
    assert port_mesh.pad_count_to_mesh(5, _mesh(4)) == 8 and port_mesh.shard_blocks(8, _mesh(4))[2] == (4, 6)


def test_engine_over_a_sharded_bank_coalesces(fleet):
    entries, _ = fleet
    single = ModelBank.from_entries(entries, device="cpu", registry=False)
    engine = BatchingEngine(ModelBank.from_entries(entries, mesh=_mesh(8), registry=False), flush_ms=20.0)
    engine.start()
    X = np.random.default_rng(7).random((40, F), dtype=np.float32)
    results = {}
    try:
        def one(name):
            results[name] = engine.submit(name, X).result(60)

        threads = [threading.Thread(target=one, args=(e.name,)) for e in entries]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        engine.stop()
    assert engine.stats["max_batch_seen"] > 1
    for e in entries:
        np.testing.assert_allclose(results[e.name].total_scaled, single.score(e.name, X).total_scaled, **ENGINE_BAND)


# ------------------------------------------------------------------ #
# build_app(devices=)
# ------------------------------------------------------------------ #


@pytest.fixture
def cpu_shards(monkeypatch):
    """The CPU as 8 devices, as tests/conftest.py gives JAX 8 virtual ones."""
    monkeypatch.setattr(port_mesh, "available_devices", lambda kind="cuda": [torch.device(kind)] * 8)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, fleet):
    entries, _ = fleet
    root = tmp_path_factory.mktemp("sharded-models")
    for e in entries[:3] + [e for e in entries if e.name == "lstm-0"]:
        serializer.dump(e, str(root / e.name))
    return root


def _post(base, name, X):
    req = urllib.request.Request(f"{base}{P}/{name}/anomaly/prediction", data=json.dumps({"X": X.tolist()}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _get(base, path):
    with urllib.request.urlopen(base + P + path, timeout=60) as resp:
        return json.loads(resp.read())


def test_build_app_devices_serves_sharded(model_dir, cpu_shards, monkeypatch):
    monkeypatch.setenv("GORDO_SERVER_WARMUP", "0")
    X = np.random.default_rng(8).random((30, F), dtype=np.float32)
    answers = []
    for devices in (1, 8):
        server = run_server(str(model_dir), host="127.0.0.1", port=0, device="cpu", background=True, devices=devices)
        try:
            assert (server.app.bank.mesh is not None) == (devices == 8)
            answers.append([_post(server.url, n, X) for n in ("dense-1", "lstm-0")])
            body = _get(server.url, "/models")
            assert set(body["bank"]["banked"]) == {"dense-0", "dense-1", "dense-2", "lstm-0"}
            assert body["bank"]["devices"] == devices
        finally:
            server.close()
    assert answers[0] == answers[1]


def test_environment_devices_and_the_clamp(model_dir, cpu_shards, monkeypatch, caplog):
    monkeypatch.setenv("GORDO_SERVER_WARMUP", "0")
    for env, want in (("0", 8), ("-1", 8), ("3", 3), ("1", 1)):
        monkeypatch.setenv("GORDO_SERVER_DEVICES", env)
        app = build_app(str(model_dir), device="cpu")
        try:
            assert app.bank.coverage()["devices"] == want, env
        finally:
            app.close()
    monkeypatch.delenv("GORDO_SERVER_DEVICES")
    with caplog.at_level("WARNING", logger="gordo_components_torch.server"):
        app = build_app(str(model_dir), device="cpu", devices=999)
    try:
        assert app.bank.mesh is not None and app.bank.mesh.size == 8
    finally:
        app.close()
    assert "GORDO_SERVER_DEVICES=999 but only 8 device(s) present; sharding the bank over 8" in caplog.text
    monkeypatch.setenv("GORDO_SERVER_DEVICES", "x")
    with pytest.raises(ValueError, match="GORDO_SERVER_DEVICES"):
        build_app(str(model_dir), device="cpu")


def test_reload_rebuilds_under_the_same_mesh(model_dir, fleet, cpu_shards, monkeypatch, tmp_path):
    entries, _ = fleet
    monkeypatch.setenv("GORDO_SERVER_WARMUP", "0")
    serializer.dump(entries[0], str(tmp_path / entries[0].name))
    server = run_server(str(tmp_path), host="127.0.0.1", port=0, device="cpu", background=True, devices=8)
    try:
        assert server.app.bank.mesh.size == 8
        serializer.dump(entries[1], str(tmp_path / entries[1].name))
        req = urllib.request.Request(f"{server.url}{P}/reload", data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
        assert body["bank_models"] == 2 and body["swap"]["generation"] == 1
        assert server.app.bank.mesh.size == 8 and server.app.bank.coverage()["devices"] == 8
        assert _post(server.url, entries[1].name, np.random.default_rng(9).random((20, F), dtype=np.float32))[0] == 200
    finally:
        server.close()
