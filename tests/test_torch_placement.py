"""The port's placement plane (``gordo_components_torch/placement``) against
the JAX package's, on the CPU (after tests/test_placement.py).

- **The planner.** ``skew_ratio`` and ``plan_rebalance`` equal JAX's on the
  same placements and loads: the clustered hot members, determinism, each
  gate (balanced, single shard, too few rows, below the threshold, the
  goodput floor), the capacity constraint and random loads; the summaries,
  the member orders and the verdicts compare equal.
- **The swap.** ``ordered_models`` realises a plan's order and keeps the
  strays; a bank over 8 logical CPU shards, rebuilt in the plan's order,
  scores bitwise as before and cuts the measured shard skew of the same
  traffic by at least 2x; an armed ``bank.swap`` rolls the app's and the
  engine's pointers (and a just-started engine) back and leaves the
  registry's bank series (with an engine, its whole exposition) byte-equal.
- **The routes.** Both servers over one converted collection of 32
  members, sharded over 8 shards (JAX's virtual devices, the port's
  logical CPU shards): ``/placement`` (and ``?dry_run=1``) and ``POST
  /rebalance`` answer with JAX's status codes and bodies under the same
  skewed traffic (swap timings masked); the port's generation and series
  step, the same traffic's skew falls at least 2x and a second rebalance
  is a no-op; the ``bank.swap`` fault answers 500 with ``rolled_back``
  while a POSTing thread gets no answer but 200, and the retry applies
  under that thread too; the bank off answers as JAX's;
  the watchman fans a dry run out.

Tolerances: the planner and the routes' JSON equal; scores bitwise.
"""

import asyncio
import importlib.util
import json
import os
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from gordo_components_torch.observability.metrics import MetricsRegistry
from gordo_components_torch.parallel import mesh as port_mesh
from gordo_components_torch.placement import planner as port_planner
from gordo_components_torch.resilience import faults as port_faults
from gordo_components_torch.server import ModelBank, run_server
from gordo_components_torch.server import swap as port_swap
from gordo_components_torch.watchman import run_watchman
from gordo_components_tpu import serializer as jax_serializer
from gordo_components_tpu.models import AutoEncoder, DiffBasedAnomalyDetector
from gordo_components_tpu.placement import planner as jax_planner
from gordo_components_tpu.placement import swap as jax_swap
from gordo_components_tpu.resilience import faults as jax_faults
from gordo_components_tpu.server import build_app as jax_build_app

_SPEC = importlib.util.spec_from_file_location(
    "jax_artifact_to_torch",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools", "jax_artifact_to_torch.py"))
TOOL = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(TOOL)

N_MODELS = 32  # over 8 shards: shard_size 4, the first 4 members hot
HOT_WEIGHT = 8
SHARDS = 8
P = "/gordo/v0/p"
ROWS = [[0.1, 0.2, 0.3]] * 16


@pytest.fixture(autouse=True)
def _clean_faults():
    port_faults.reset()
    jax_faults.reset()
    yield
    port_faults.reset()
    jax_faults.reset()


def _synth_placement(n_members, n_shards, shard_size):
    return [{"bucket": "b", "key": "k", "n_shards": n_shards, "shard_size": shard_size,
             "members": [f"m-{i:02d}" for i in range(n_members)]}]


def _skewed_loads(n_members, hot, weight=HOT_WEIGHT, rows=16):
    return {f"m-{i:02d}": rows * (weight if i in hot else 1) for i in range(n_members)}


_RNG_LOADS = {f"m-{i:02d}": float(v) for i, v in enumerate(np.random.RandomState(4).randint(0, 500, 24))}

# (placement, loads, kwargs): tests/test_placement.py:111-191 and random loads
PLAN_CASES = {
    "clustered_hot": (_synth_placement(32, 8, 4), _skewed_loads(32, range(4)), dict(threshold=1.2, min_rows=1)),
    "balanced": (_synth_placement(16, 8, 2), {f"m-{i:02d}": 100 for i in range(16)}, dict(threshold=1.2, min_rows=1)),
    "single_shard": (_synth_placement(16, 1, 16), _skewed_loads(16, (0,)), dict(min_rows=1)),
    "insufficient": (_synth_placement(16, 8, 2), _skewed_loads(16, (0, 1)), dict(threshold=1.2, min_rows=10**9)),
    "mild": (_synth_placement(16, 8, 2), {f"m-{i:02d}": 110 if i == 0 else 100 for i in range(16)},
             dict(threshold=1.2, min_rows=1)),
    "goodput_gate": (_synth_placement(16, 8, 2), _skewed_loads(16, (0, 1)),
                     dict(threshold=1.2, min_rows=1, goodput={"padded_row_waste_ratio": 0.001}, min_pad_ratio=0.05)),
    "uneven_capacity": (_synth_placement(12, 8, 2), _skewed_loads(12, (0, 1)), dict(threshold=1.0, min_rows=1)),
    "random_loads": (_synth_placement(24, 4, 6) + [{**_synth_placement(24, 4, 6)[0], "bucket": "c", "key": "c"}],
                     _RNG_LOADS, dict(threshold=1.1, min_rows=1)),
    "no_load": (_synth_placement(8, 4, 2), {}, dict(min_rows=0)),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_rebalance_equals_jax(case):
    placement, loads, kwargs = PLAN_CASES[case]
    port = port_planner.plan_rebalance(placement, loads, **kwargs)
    jax = jax_planner.plan_rebalance(placement, loads, **kwargs)
    assert port.summary() == jax.summary()
    assert port.member_order() == jax.member_order()
    assert (port.should_apply, port.reason) == (jax.should_apply, jax.reason)
    # determinism: the same inputs, the same plan
    assert port_planner.plan_rebalance(placement, loads, **kwargs).summary() == port.summary()
    if case == "clustered_hot":
        assert port.should_apply and port.improvement >= 2.0
        order = port.buckets[0].order
        hot = {"m-00", "m-01", "m-02", "m-03"}
        assert all(len(order[d * 4:(d + 1) * 4]) == 4 and len(hot & set(order[d * 4:(d + 1) * 4])) <= 1
                   for d in range(8))
    if case == "uneven_capacity":
        assert sorted(port.buckets[0].order) == sorted(placement[0]["members"])


@pytest.mark.parametrize("loads", [[], [0.0, 0.0], [1.0, 1.0, 1.0], [8.0, 0.0, 0.0, 0.0], [3.0, 5.0]])
def test_skew_ratio_equals_jax(loads):
    assert port_planner.skew_ratio(loads) == jax_planner.skew_ratio(loads)


def test_threshold_defaults_read_the_environment_as_jax(monkeypatch):
    for env in ({}, {"GORDO_REBALANCE_THRESHOLD": "1.5"}, {"GORDO_MESH_THRESHOLD": "2", "GORDO_MESH_MAX_MOVES": "7"}):
        for k in ("GORDO_REBALANCE_THRESHOLD", "GORDO_MESH_THRESHOLD", "GORDO_MESH_MAX_MOVES"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for fn in ("default_threshold", "default_fleet_threshold", "default_max_moves"):
            assert getattr(port_planner, fn)() == getattr(jax_planner, fn)(), (env, fn)
    monkeypatch.setenv("GORDO_REBALANCE_THRESHOLD", "x")
    with pytest.raises(ValueError, match="GORDO_REBALANCE_THRESHOLD"):
        port_planner.default_threshold()


def test_ordered_models_realizes_plan_and_keeps_strays():
    models = {f"m-{i:02d}": i for i in range(6)}
    for order in ({"k": ["m-04", "m-00", "ghost", "m-02"]}, None, {"a": ["m-05"], "b": ["m-01", "m-05"]}):
        out = port_swap.ordered_models(models, order)
        assert list(out) == list(jax_swap.ordered_models(models, order))
    assert list(port_swap.ordered_models(models, {"k": ["m-04", "m-00", "ghost", "m-02"]})) == [
        "m-04", "m-00", "m-02", "m-01", "m-03", "m-05"]


# ------------------------------------------------------------------ #
# the collection both servers serve
# ------------------------------------------------------------------ #


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """32 copies of one fitted JAX detector, and the port's conversion
    (placement cares for names and loads; one fit keeps it fast)."""
    X = np.random.RandomState(0).rand(60, 3).astype("float32")
    det = DiffBasedAnomalyDetector(base_estimator=AutoEncoder(epochs=1, batch_size=64))
    det.fit(X)
    jax_root, port_root = tmp_path_factory.mktemp("jax-fleet"), tmp_path_factory.mktemp("port-fleet")
    for i in range(N_MODELS):
        name = f"m-{i:02d}"
        jax_serializer.dump(det, str(jax_root / name), metadata={"name": name})
    assert TOOL.main([str(jax_root), str(port_root)]) == 0
    return str(jax_root), str(port_root), X


@pytest.fixture
def cpu_shards(monkeypatch):
    """The CPU as 8 devices, as tests/conftest.py gives JAX 8 virtual ones."""
    monkeypatch.setattr(port_mesh, "available_devices", lambda kind="cuda": [torch.device(kind)] * SHARDS)


def _port_models(port_root):
    from gordo_components_torch.server.model_io import ModelCollection

    return dict(ModelCollection(port_root, device="cpu").models)


def _shard_rows(registry):
    snap = registry.snapshot()
    return {v["labels"]["shard"]: v["value"]
            for v in snap.get("gordo_bank_shard_routed_rows_total", {}).get("values", [])}


def _app(bank, registry, mesh=None):
    """What the swap reads of an app."""
    return SimpleNamespace(bank=bank, engine=None, engine_config={}, metrics=registry, events=None, placement=None,
                           bank_config={"device": "cpu", "registry": registry, "mesh": mesh})


def test_swap_applies_plan_and_cuts_measured_skew(roots):
    _jax_root, port_root, X = roots
    models = _port_models(port_root)
    registry = MetricsRegistry()
    mesh = port_mesh.fleet_mesh(devices=["cpu"] * SHARDS)
    bank = ModelBank.from_models(models, mesh=mesh, registry=registry, device="cpu")
    assert bank.coverage()["devices"] == SHARDS and bank.placement()["buckets"][0]["shard_size"] == 4
    hot = bank.placement()["buckets"][0]["members"][:4]
    requests = [(name, X[:16], None) for name in models for _ in range(HOT_WEIGHT if name in hot else 1)]
    bank.score_many(requests)
    plan = port_planner.plan_rebalance(bank.placement()["buckets"], dict(bank.model_rows), threshold=1.2, min_rows=1)
    assert plan.should_apply and plan.improvement >= 2.0, plan.summary()
    app = _app(bank, registry, mesh)
    prev = port_swap.snapshot_collectors(registry)
    new_bank = port_swap.build_bank(app, models, member_order=plan.member_order(), warmup=False)
    result = port_swap.swap_bank(app, new_bank, prev_collectors=prev)
    try:
        assert app.bank is new_bank and new_bank.generation == 1
        assert new_bank.placement()["buckets"][0]["members"] == plan.buckets[0].order
        assert sum(new_bank.model_rows.values()) == sum(bank.model_rows.values())
        a, b = bank.score("m-00", X[:16]), new_bank.score("m-00", X[:16])
        np.testing.assert_array_equal(a.total_scaled, b.total_scaled)
        np.testing.assert_array_equal(a.model_output, b.model_output)
        before = _shard_rows(registry)
        new_bank.score_many(requests)
        after = _shard_rows(registry)
        measured = port_planner.skew_ratio([after[s] - before.get(s, 0.0) for s in sorted(after)])
        assert measured is not None and plan.skew_before / measured >= 2.0, (plan.skew_before, measured)
        assert result.pause_s < 0.1, result
    finally:
        app.engine.stop()


@pytest.mark.parametrize("with_engine", [False, True])
def test_swap_fault_rolls_back_pointers_and_collectors(roots, with_engine):
    """``bank.swap`` fires between the engine's flip and the app's: both
    pointers (and a just-started engine) roll back, the old bank serves,
    and the registry renders exactly as before; the next swap applies."""
    from gordo_components_torch.server.engine import BatchingEngine

    _jax_root, port_root, X = roots
    models = {k: v for k, v in _port_models(port_root).items() if k in ("m-00", "m-01")}
    registry = MetricsRegistry()
    bank = ModelBank.from_models(models, registry=registry, device="cpu")
    bank.score("m-00", X[:8])
    app = _app(bank, registry)
    if with_engine:
        app.engine = BatchingEngine(bank)
        app.engine.start()
    old_engine = app.engine
    render_before = registry.render()
    prev = port_swap.snapshot_collectors(registry)
    new_bank = port_swap.build_bank(app, models, warmup=False)
    port_faults.arm("bank.swap", port_faults.FaultSpec(times=1))
    try:
        with pytest.raises(port_faults.FaultInjected):
            port_swap.swap_bank(app, new_bank, prev_collectors=prev)
    finally:
        port_faults.disarm("bank.swap")
    try:
        assert app.bank is bank and app.engine is old_engine and app.bank.generation == 0
        if with_engine:
            assert app.engine.bank is bank
        if with_engine:
            assert registry.render() == render_before
        else:
            # an engine started for the new bank keeps its own families
            # (as the JAX one's); the bank's series are the old ones
            def bank_lines(text):
                return [line for line in text.splitlines() if "gordo_bank_" in line]

            assert bank_lines(registry.render()) == bank_lines(render_before)
        assert np.isfinite(bank.score("m-00", X[:8]).total_scaled).all()
        result = port_swap.swap_bank(app, new_bank, prev_collectors=None)
        assert result.generation == 1 and app.bank is new_bank and app.engine.bank is new_bank
    finally:
        if app.engine is not None:
            app.engine.stop()


# ------------------------------------------------------------------ #
# the routes, both servers
# ------------------------------------------------------------------ #


def _call(url, method="GET", body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _weights(hot):
    return {f"m-{i:02d}": (HOT_WEIGHT if f"m-{i:02d}" in hot else 1) for i in range(N_MODELS)}


# the sequence both servers answer (after the skewed traffic)
ROUTE_STEPS = [("placement", "GET", "/placement", None), ("dry_run", "GET", "/placement?dry_run=1", None),
               ("rebalance_dry", "POST", "/rebalance?dry_run=1", None),
               ("bad_body", "POST", "/rebalance", b"not json"), ("list_body", "POST", "/rebalance", b"[1]"),
               ("rebalance", "POST", "/rebalance", {}), ("placement_after", "GET", "/placement", None),
               ("noop", "POST", "/rebalance", {})]


async def _jax_route_answers(root, hot_fn):
    client = TestClient(TestServer(jax_build_app(root, devices=SHARDS)))
    await client.start_server()
    try:
        place = await (await client.get(f"{P}/placement")).json()
        weights = _weights(hot_fn(place))
        for name, w in weights.items():
            for _ in range(w):
                resp = await client.post(f"{P}/{name}/anomaly/prediction", json={"X": ROWS})
                assert resp.status == 200
        out = {}
        for key, method, path, body in ROUTE_STEPS:
            data = body if isinstance(body, bytes) else (None if body is None else json.dumps(body))
            resp = await client.request(method, P + path, data=data,
                                        headers={"Content-Type": "application/json"})
            out[key] = resp.status, await resp.json()
        return out
    finally:
        await client.close()


def _mask(body):
    """A body less what differs by nature: the swap's wall times, and the
    bucket's internal key (each bank's own JSON)."""
    if isinstance(body, dict):
        return {k: ("<t>" if k in ("pause_ms", "build_s", "warmup_s", "last_pause_ms") else
                    "<key>" if k == "key" else _mask(v)) for k, v in body.items()}
    if isinstance(body, list):
        return [_mask(v) for v in body]
    return body


def _port_call_raw(base, method, path, body):
    data = body if isinstance(body, bytes) else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(base + P + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _drive(base, weights):
    statuses = []
    for name, w in weights.items():
        for _ in range(w):
            statuses.append(_call(f"{base}{P}/{name}/anomaly/prediction", "POST", {"X": ROWS})[0])
    return statuses


def test_routes_answer_as_jax_and_the_rebalance_cuts_skew(roots, cpu_shards, monkeypatch):
    jax_root, port_root, _X = roots
    monkeypatch.setenv("GORDO_REBALANCE_MIN_ROWS", "1")
    monkeypatch.setenv("GORDO_SERVER_WARMUP", "0")
    hot_fn = lambda place: place["buckets"][0]["members"][:4]  # noqa: E731
    jax = asyncio.run(_jax_route_answers(jax_root, hot_fn))
    server = run_server(port_root, host="127.0.0.1", port=0, device="cpu", background=True, devices=SHARDS)
    base = server.url
    try:
        registry = server.app.metrics
        place = _call(base + P + "/placement")[1]
        assert place["buckets"][0]["n_shards"] == SHARDS and place["buckets"][0]["shard_size"] == 4
        weights = _weights(hot_fn(place))
        before = _shard_rows(registry)
        assert set(_drive(base, weights)) == {200}
        now = _shard_rows(registry)
        skew_before = port_planner.skew_ratio([now[s] - before.get(s, 0.0) for s in sorted(now)])
        assert skew_before is not None and skew_before > 2.0
        port = {key: _port_call_raw(base, method, path, body) for key, method, path, body in ROUTE_STEPS}
        for key, _m, _p, _b in ROUTE_STEPS:
            assert port[key][0] == jax[key][0], key
            want = _mask(jax[key][1])
            got = _mask(port[key][1])
            got.pop("request_id", None), want.pop("request_id", None)
            assert got == want, key
        status, body = port["rebalance"]
        assert status == 200 and body["applied"] and body["swap"]["generation"] == 1
        assert body["plan"]["improvement"] >= 2.0 and body["swap"]["pause_ms"] <= 250.0
        assert port["noop"][1]["applied"] is False
        # the same traffic on the new placement
        before = _shard_rows(registry)
        assert set(_drive(base, weights)) == {200}
        now = _shard_rows(registry)
        skew_after = port_planner.skew_ratio([now[s] - before.get(s, 0.0) for s in sorted(now)])
        assert skew_before / skew_after >= 2.0, (skew_before, skew_after)
        snap = registry.snapshot()
        assert snap["gordo_bank_generation"]["values"][0]["value"] == 1
        assert snap["gordo_rebalance_swap_pause_seconds"]["values"][0]["count"] == 1
        assert snap["gordo_rebalance_total"]["values"][0]["value"] == 1
        events = _call(base + P + "/events?type=rebalance.applied,rebalance.plan,bank.swap")[1]["events"]
        assert [e["type"] for e in events] == ["bank.swap", "rebalance.applied", "rebalance.plan"]
        traces = _call(base + P + "/traces?n=50")[1]["traces"]
        # the controller's forced trace: the one ``rebalance`` trace without
        # a request id (a POST /rebalance request's own trace shares the
        # name and is kept at the head-sampling rate)
        spans = [t for t in traces if t["name"] == "rebalance" and t["request_id"] is None]
        assert len(spans) == 1, [(t["name"], t["request_id"]) for t in traces]
        assert [c["name"] for c in spans[0]["spans"]["children"]] == ["plan", "build", "swap", "drain"]
    finally:
        server.close()


def test_swap_fault_over_http_rolls_back_and_serving_goes_on(roots, cpu_shards, monkeypatch):
    _jax_root, port_root, _X = roots
    monkeypatch.setenv("GORDO_REBALANCE_MIN_ROWS", "1")
    monkeypatch.setenv("GORDO_SERVER_WARMUP", "0")
    monkeypatch.setenv("GORDO_FAULTS", "bank.swap=error,times=1")
    server = run_server(port_root, host="127.0.0.1", port=0, device="cpu", background=True, devices=SHARDS)
    base = server.url
    try:
        registry = server.app.metrics
        place = _call(base + P + "/placement")[1]
        assert set(_drive(base, _weights(place["buckets"][0]["members"][:4]))) == {200}
        bank_series = [line for line in registry.render().splitlines() if line.startswith("gordo_bank_")]
        load_statuses, stop = [], threading.Event()

        def load():
            i = 0
            while not stop.is_set():
                i += 1
                load_statuses.append(_call(f"{base}{P}/m-{i % N_MODELS:02d}/anomaly/prediction", "POST",
                                           {"X": ROWS})[0])

        loader = threading.Thread(target=load)
        loader.start()
        try:
            status, body = _call(base + P + "/rebalance", "POST", {})
        finally:
            stop.set()
            loader.join()
        assert status == 500 and body["rolled_back"] is True and body["generation"] == 0, body
        assert load_statuses and set(load_statuses) == {200}
        snap = registry.snapshot()
        assert snap["gordo_rebalance_failed_total"]["values"][0]["value"] == 1
        assert snap["gordo_bank_generation"]["values"][0]["value"] == 0
        # the old generation's series: the same lines but the traffic's counters
        after = [line for line in registry.render().splitlines() if line.startswith("gordo_bank_")]
        assert [line.rsplit(" ", 1)[0] for line in after] == [line.rsplit(" ", 1)[0] for line in bank_series]
        # the retry applies, under a POSTing thread: no answer but 200
        load_statuses.clear()
        stop.clear()
        loader = threading.Thread(target=load)
        loader.start()
        try:
            status, body = _call(base + P + "/rebalance", "POST", {})
        finally:
            stop.set()
            loader.join()
        assert status == 200 and body["applied"] is True and body["swap"]["generation"] == 1
        assert load_statuses and set(load_statuses) == {200}, sorted(set(load_statuses))
        stats = _call(base + P + "/placement")[1]["stats"]
        assert (stats["failed"], stats["applied"]) == (1, 1)
    finally:
        server.close()


def test_placement_disabled_without_bank_as_jax(roots, monkeypatch):
    jax_root, port_root, _X = roots
    monkeypatch.setenv("GORDO_SERVER_BANK", "0")

    async def jax_answers():
        client = TestClient(TestServer(jax_build_app(jax_root)))
        await client.start_server()
        try:
            a = await client.get(f"{P}/placement")
            b = await client.post(f"{P}/rebalance")
            return (a.status, await a.json()), (b.status, await b.json())
        finally:
            await client.close()

    jax = asyncio.run(jax_answers())
    server = run_server(port_root, host="127.0.0.1", port=0, device="cpu", background=True)
    try:
        assert _call(server.url + P + "/placement") == jax[0] == (200, {"enabled": False})
        assert _call(server.url + P + "/rebalance", "POST") == jax[1]
        assert jax[1][0] == 404
    finally:
        server.close()


def test_watchman_fans_a_dry_run_rebalance_out(roots, cpu_shards, monkeypatch):
    _jax_root, port_root, _X = roots
    monkeypatch.setenv("GORDO_REBALANCE_MIN_ROWS", "1")
    monkeypatch.setenv("GORDO_SERVER_WARMUP", "0")
    server = run_server(port_root, host="127.0.0.1", port=0, device="cpu", background=True, devices=SHARDS)
    wm = run_watchman("p", server.url, metrics_urls=[server.url + P + "/metrics"], host="127.0.0.1", port=0,
                      background=True)
    try:
        place = _call(server.url + P + "/placement")[1]
        _drive(server.url, _weights(place["buckets"][0]["members"][:4]))
        status, body = _call(wm.url + "/rebalance?dry_run=1", "POST", {"force": True})
        assert status == 200 and body["dry_run"] is True and body["force"] is True and body["applied"] == 0
        (replica,) = body["replicas"]
        assert replica["reached"] and replica["status"] == 200 and replica["applied"] is False
        assert replica["reason"].startswith("predicted skew")
        assert _call(server.url + P + "/placement")[1]["generation"] == 0
    finally:
        wm.close()
        server.close()
