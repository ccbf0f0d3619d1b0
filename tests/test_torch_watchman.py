"""The port's watchman (``gordo_components_torch/watchman/server.py``) against
the JAX package's, on the CPU.

- **Pure functions.** ``aggregate_fleet_metrics`` and ``render_fleet_metrics``
  bitwise JAX's on the same texts: the JAX server's ``/metrics`` (a meshed
  bank's shard series), the port replicas' (one shard, ``"0"``, each), NaN
  samples, the first scrape, a counter reset, a frozen replica
  (``tests/test_watchman.py:133-240``).
- **Two watchmen over the same replicas.** Three port replicas
  (``run_server(device="cpu")``: dense detectors fitted on the CPU,
  ``GORDO_STREAM=1``, ``GORDO_HISTORY=1``) behind recording proxies, so
  both watchmen read the same bytes; the JAX ``build_watchman_app`` on an
  aiohttp ``TestServer`` and the port's ``run_watchman(background=True)``
  on one frozen ``ReplayClock``. Every read route answers alike (the
  version key masked; ``/metrics`` byte-equal; ``/routing`` with its
  ``ETag`` and 304), and under each fault point the same.
- **Each behaviour** of ``tests/test_watchman.py:32-470``, the watchman cases
  of ``tests/test_chaos.py:530-620`` and the routing cases of
  ``tests/test_mesh.py``, on the port: full metadata, bank coverage,
  explicit unknown targets, unreachable, caching, one request a snapshot,
  the per-target fallback, the version bumping on a change only, the
  unreachable and recovered events.
- **The rest.** The write routes answer 405 to another method and each
  POST a first answer (the fan-out's verdicts, a migration's 409 or 400);
  their behaviour is held in tests/test_torch_mesh.py;
  ``Client(routing_url=...)`` against the port's watchman answers as the
  replicas do directly; ``run-watchman``'s options and environment
  variables are the JAX CLI's.
"""

import asyncio
import json
import os
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

import gordo_components_tpu.resilience as jax_resilience
from gordo_components_torch import resilience as port_resilience
from gordo_components_torch import serializer as port_serializer
from gordo_components_torch.client import Client as PortClient
from gordo_components_torch.parallel.fleet import FleetTrainer
from gordo_components_torch.replay.clock import ReplayClock
from gordo_components_torch.server import run_server
from gordo_components_torch.watchman import server as port_wm
from gordo_components_torch.watchman.server import WatchmanState, run_watchman
from gordo_components_tpu.watchman import server as jax_wm

PROJECT = "proj"
TAGS = ["tag-0", "tag-1", "tag-2"]
# three one-card replicas: each its own members, none on two
REPLICAS = (("m-0", "m-1"), ("m-2", "m-3"), ("m-4",))
ENV = {"GORDO_STREAM": "1", "GORDO_HISTORY": "1", "GORDO_SERVER_WARMUP": "0", "GORDO_TRACE_SAMPLE": "1",
       "GORDO_STREAM_MIN_ROWS": "8"}
VERSION_KEY = "gordo-watchman-version"
DATASET = {"type": "RandomDataset", "tag_list": TAGS, "resolution": "10min"}


def _set_env(values):
    before = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    return before


def _restore_env(before):
    for k, v in before.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _get(url, headers=None, method="GET", data=None):
    """(status, headers, body bytes) of one request, any status."""
    req = urllib.request.Request(url, headers=headers or {}, method=method, data=data)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read()


def _post_anomaly(base, name, rows):
    body = json.dumps({"X": rows.tolist()}).encode()
    status, _, raw = _get(f"{base}/gordo/v0/{PROJECT}/{name}/anomaly/prediction",
                          headers={"Content-Type": "application/json"}, method="POST", data=body)
    assert status == 200, raw[:300]
    return json.loads(raw)


class Fleet:
    """Port replicas on the CPU, and what was fitted for them."""

    def __init__(self, servers, dirs):
        self.servers = servers
        self.dirs = dirs
        self.urls = [s.url for s in servers]

    def metrics_urls(self, bases=None):
        return [f"{b}/gordo/v0/{PROJECT}/metrics" for b in (bases or self.urls)]


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    rng = np.random.RandomState(0)
    root = tmp_path_factory.mktemp("watchman-fleet")
    names = [n for members in REPLICAS for n in members]
    frames = {n: rng.rand(96, len(TAGS)).astype("float32") for n in names}
    fitted = FleetTrainer(kind="feedforward_hourglass", epochs=1, batch_size=32, device="cpu").fit(frames)
    dirs = []
    for i, members in enumerate(REPLICAS):
        d = root / f"replica-{i}"
        for n in members:
            port_serializer.dump(fitted[n].to_estimator(), str(d / n), metadata={"name": n, "dataset": DATASET})
        dirs.append(str(d))
    before = _set_env(ENV)
    try:
        servers = [run_server(d, host="127.0.0.1", port=0, device="cpu", background=True) for d in dirs]
    finally:
        _restore_env(before)
    fleet = Fleet(servers, dirs)
    # traffic, so traces, heat, costs and SLO windows hold something
    for base, members in zip(fleet.urls, REPLICAS):
        for n in members:
            for _ in range(2):
                _post_anomaly(base, n, rng.rand(16, len(TAGS)).astype("float32"))
    try:
        yield fleet
    finally:
        for s in servers:
            s.close()


class _Tape(ThreadingHTTPServer):
    """A recording proxy: each GET (path and query) goes once to the
    replica behind it, and every later one is answered from the
    recording, so two watchmen read the same bytes of a live replica."""

    daemon_threads = True

    def __init__(self, upstream):
        self.upstream = upstream
        self.tape = {}
        self.lock = threading.Lock()
        self.dark = False  # answer nothing: the replica is gone
        self.gate = None  # a threading.Event: hold every request until it is set (a hung replica)
        super().__init__(("127.0.0.1", 0), _TapeHandler)
        threading.Thread(target=self.serve_forever, kwargs={"poll_interval": 0.05}, daemon=True).start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.server_address[1]}"

    def close(self):
        self.shutdown()
        self.server_close()


class _TapeHandler(BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def do_GET(self):
        srv = self.server
        if srv.dark:
            self.close_connection = True
            self.connection.close()
            return
        if srv.gate is not None:
            srv.gate.wait(60)
        path, _, query = self.path.partition("?")
        key = (path, tuple(sorted(query.split("&"))) if query else ())
        with srv.lock:
            hit = srv.tape.get(key)
            if hit is None:
                status, headers, body = _get(srv.upstream + self.path)
                hit = srv.tape[key] = (status, headers.get("Content-Type", "application/json"), body)
        status, ctype, body = hit
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def _masked(raw: bytes) -> str:
    body = json.loads(raw)
    if isinstance(body, dict) and VERSION_KEY in body:
        body[VERSION_KEY] = None
    return json.dumps(body)


class Pair:
    """The JAX watchman on a ``TestServer`` and the port's beside it, over
    the same tapes and one clock."""

    def __init__(self, client, port, tapes, clock):
        self.client, self.port, self.tapes, self.clock = client, port, tapes, clock

    async def get(self, path, headers=None):
        """((status, headers, body) of JAX's, the same of the port's)."""
        resp = await self.client.get(path, headers=headers)
        jax = (resp.status, {k.lower(): v for k, v in resp.headers.items()}, await resp.read())
        status, got, body = await asyncio.to_thread(_get, self.port.url + path, headers)
        return jax, (status, {k.lower(): v for k, v in got.items()}, body)

    async def same(self, path, headers=None, raw=False):
        (js, jh, jb), (ps, ph, pb) = await self.get(path, headers)
        assert js == ps, (path, js, ps, jb[:300], pb[:300])
        if raw:
            assert jb == pb, path
        elif jb or pb:
            assert _masked(jb) == _masked(pb), path
        return js, jh, json.loads(pb) if pb and not raw else pb


async def _pair(fleet, refresh_interval=30.0, **kwargs):
    tapes = [_Tape(u) for u in fleet.urls]
    urls = fleet.metrics_urls([t.url for t in tapes])
    clock = ReplayClock(1_780_000_000.0)
    app = jax_wm.build_watchman_app(PROJECT, tapes[0].url, refresh_interval=refresh_interval, metrics_urls=urls,
                                    clock=clock, **kwargs)
    client = TestClient(TestServer(app))
    await client.start_server()
    port = run_watchman(PROJECT, tapes[0].url, host="127.0.0.1", port=0, refresh_interval=refresh_interval,
                        metrics_urls=urls, clock=clock, background=True, **kwargs)
    return Pair(client, port, tapes, clock)


async def _close(pair):
    await pair.client.close()
    pair.port.close()
    for t in pair.tapes:
        t.close()


# ---------------------------------------------------------------------- #
# two watchmen over the same replicas
# ---------------------------------------------------------------------- #


async def test_every_read_route_answers_as_the_jax_watchman(fleet):
    pair = await _pair(fleet)
    try:
        status, headers, table = await pair.same("/routing")
        assert status == 200 and table["version"] == 1
        assert table["members"] == {n: i for i, members in enumerate(REPLICAS) for n in members}
        etag = headers["etag"]
        (js, jh, _), (ps, ph, pb) = await pair.get("/routing?refresh=1", headers={"If-None-Match": etag})
        assert js == ps == 304 and ph["etag"] == jh["etag"] == etag and pb == b""
        await pair.same("/metrics", raw=True)
        await pair.same("/drift")
        _, _, root = await pair.same("/")
        assert [e["target"] for e in root["endpoints"]] == sorted(REPLICAS[0])
        assert root["fleet-metrics"]["replicas_scraped"] == len(REPLICAS)
        assert [r["url"] for r in root["replicas"]] == [t.url for t in pair.tapes]
        for path in ("/healthcheck", "/slo", "/slo?refresh=1", "/heat", "/heat?top=2&refresh=1", "/costs",
                     "/costs?refresh=1", "/history", "/history?series=gordo_server_requests_total",
                     "/events", "/events?type=models.load&limit=2", "/incidents", "/incidents?threshold=0.5",
                     "/drift?refresh=1", "/traces?n=2", "/traces"):
            await pair.same(path)
        # JAX's status codes and bodies for query values that do not parse
        for path in ("/traces?n=0", "/traces?n=x", "/events?limit=x", "/history?since=x", "/heat?top=x",
                     "/incidents?margin=x"):
            status, _, _ = await pair.same(path)
            assert status == 400
        # the clock moves: every age on both, the cached rollup re-rendered
        pair.clock.advance(45.0)
        await pair.same("/metrics", raw=True)
        _, _, table = await pair.same("/routing")
        assert table["version"] == 1
    finally:
        await _close(pair)


async def test_faults_degrade_both_watchmen_alike(fleet):
    pair = await _pair(fleet, refresh_interval=0.0)
    try:
        await pair.same("/routing")
        await pair.same("/metrics", raw=True)
        # the states directly: at refresh_interval 0, GET / would start
        # background refreshes that race the armed faults
        jax_state, port_state = pair.client.app["state"], pair.port.state
        await jax_state.snapshot()
        pair.port.app.run(port_state.snapshot())
        # watchman.scrape: the rollup keeps its last good numbers, stamped
        for reg in (jax_resilience, port_resilience):
            reg.arm("watchman.scrape", times=len(REPLICAS))
        pair.clock.advance(5.0)
        jax_agg = await jax_state.fleet_metrics()
        port_agg = pair.port.app.run(port_state.fleet_metrics())
        assert jax_agg["replicas_scraped"] == port_agg["replicas_scraped"] == 0
        assert jax_agg["sums"] == port_agg["sums"]
        assert jax_wm.render_fleet_metrics(jax_agg, pair.clock.monotonic()) == port_wm.render_fleet_metrics(
            port_agg, pair.clock.monotonic())
        assert 'gordo_fleet_scrape_stale_seconds{replica="0"} 5' in port_wm.render_fleet_metrics(
            port_agg, pair.clock.monotonic())
        # watchman.snapshot: the last good snapshot, stamped stale
        for reg in (jax_resilience, port_resilience):
            reg.arm("watchman.snapshot", times=1)
        pair.clock.advance(1.0)
        jax_snap = await jax_state.snapshot()
        port_snap = pair.port.app.run(port_state.snapshot())
        for snap in (jax_snap, port_snap):
            assert snap["stale"] is True and "FaultInjected" in snap["refresh_error"]
            snap.pop(VERSION_KEY)
        assert jax_snap == port_snap
        # watchman.probe: every replica dark for one rebuild, then back
        for reg in (jax_resilience, port_resilience):
            reg.configure_from_env(f"watchman.probe=refuse,times={len(REPLICAS)}")
        _, _, dark = await pair.same("/routing?refresh=1")
        assert dark["version"] == 2 and not any(r["reachable"] for r in dark["replicas"])
        _, _, healed = await pair.same("/routing?refresh=1")
        assert healed["version"] == 3 and all(r["reachable"] for r in healed["replicas"])
        _, _, events = await pair.same("/events?type=mesh.replica_unreachable,mesh.replica_recovered")
        assert [e["type"] for e in events["events"]] == (
            ["mesh.replica_unreachable"] * len(REPLICAS) + ["mesh.replica_recovered"] * len(REPLICAS))
    finally:
        for reg in (jax_resilience, port_resilience):
            reg.reset()
        await _close(pair)


# ---------------------------------------------------------------------- #
# the pure functions, bitwise
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def scraped_texts(fleet):
    """``/metrics`` bodies: two of a JAX server over a meshed bank (it
    renders the shard series), before and after traffic, and one of each
    port replica (an unsharded bank: shard ``"0"`` alone)."""
    from gordo_components_tpu import serializer as jax_serializer
    from gordo_components_tpu.models import AutoEncoder, DiffBasedAnomalyDetector
    from gordo_components_tpu.server import build_app as jax_build_app

    rng = np.random.RandomState(1)
    root = fleet.dirs[0] + "-jax"
    for name in ("j-0", "j-1", "j-2"):  # three banked members on three of the mesh's shards
        model = DiffBasedAnomalyDetector(base_estimator=AutoEncoder(epochs=1, batch_size=64))
        model.fit(rng.rand(64, len(TAGS)).astype("float32"))
        jax_serializer.dump(model, os.path.join(root, name), metadata={"name": name})

    async def scrape_twice():
        client = TestClient(TestServer(jax_build_app(root)))
        await client.start_server()

        async def post(names):
            for name in names:
                X = rng.rand(8, len(TAGS)).tolist()
                resp = await client.post(f"/gordo/v0/{PROJECT}/{name}/anomaly/prediction", json={"X": X, "y": X})
                assert resp.status == 200

        try:
            await post(["j-0", "j-0", "j-2"])
            first = await (await client.get(f"/gordo/v0/{PROJECT}/metrics")).text()
            await post(["j-2", "j-2", "j-2", "j-1"])
            second = await (await client.get(f"/gordo/v0/{PROJECT}/metrics")).text()
        finally:
            await client.close()
        return first, second

    jax_first, jax_second = asyncio.run(scrape_twice())
    assert 'gordo_bank_shard_routed_rows_total{shard="0"} 16' in jax_first
    port = [_get(u)[2].decode() for u in fleet.metrics_urls()]
    for text in port:
        shards = [line for line in text.splitlines() if line.startswith("gordo_bank_shard_routed_rows_total{")]
        assert [line.split("}")[0] for line in shards] == ['gordo_bank_shard_routed_rows_total{shard="0"']
    return {"jax_first": jax_first, "jax_second": jax_second, "port": port}


def _nan_line(text):
    return text + "gordo_engine_queue_depth NaN\ngordo_fake_total{shard=\"x\"} NaN\n"


AGG_CASES = {
    # (this scrape's texts, the previous scrape's texts or None)
    "first_scrape": (lambda t: [t["jax_first"], *t["port"]], None),
    "delta_window": (lambda t: [t["jax_second"], *t["port"]], lambda t: [t["jax_first"], *t["port"]]),
    "counter_reset": (lambda t: [t["jax_first"], *t["port"]], lambda t: [t["jax_second"], *t["port"]]),
    "nan_samples": (lambda t: [_nan_line(t["jax_second"]), _nan_line(t["port"][0])], None),
    "frozen_replica": (lambda t: [None, t["jax_second"], *t["port"]], lambda t: [None, t["jax_first"], *t["port"]]),
    "mixed_window": (lambda t: [t["jax_second"], t["jax_second"]], lambda t: [t["jax_first"]]),
    "port_only": (lambda t: t["port"], lambda t: t["port"]),
    "no_replica": (lambda t: [], None),
}


@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_aggregate_and_render_are_bitwise_jax(case, scraped_texts):
    now_fn, prev_fn = AGG_CASES[case]
    texts = now_fn(scraped_texts)
    prev = {}
    for name, mod in (("jax", jax_wm), ("port", port_wm)):
        prev[name] = mod.aggregate_fleet_metrics(prev_fn(scraped_texts))["replica_shard_rows"] if prev_fn else None
    jax_agg = jax_wm.aggregate_fleet_metrics(texts, prev_shard_rows=prev["jax"])
    port_agg = port_wm.aggregate_fleet_metrics(texts, prev_shard_rows=prev["port"])
    assert repr(port_agg) == repr(jax_agg)
    if case in ("first_scrape", "delta_window", "counter_reset", "mixed_window"):
        assert port_agg["shard_skew_ratio"] is not None
    if case == "port_only":
        assert port_agg["shard_skew_ratio"] is None and port_agg["skew_window"] is None
    for agg in (jax_agg, port_agg):
        agg["replica_last_success"] = [None if t is None else 100.0 + i for i, t in enumerate(texts)]
    extra = [("gordo_fleet_routing_version", "gauge", "Routing-table version", {}, 3)]
    assert port_wm.render_fleet_metrics(port_agg, 107.25, extra) == jax_wm.render_fleet_metrics(jax_agg, 107.25, extra)
    assert port_wm.render_fleet_metrics(port_agg, 99.0) == jax_wm.render_fleet_metrics(jax_agg, 99.0)


# ---------------------------------------------------------------------- #
# each behaviour, on the port
# ---------------------------------------------------------------------- #


def _snapshot(base, **kwargs):
    state = WatchmanState(PROJECT, base, **kwargs)
    return asyncio.run(state.snapshot()), state


def test_snapshot_digests_by_default_and_full_metadata_on_request(fleet):
    body, _ = _snapshot(fleet.urls[0])
    assert [e["target"] for e in body["endpoints"]] == list(REPLICAS[0])
    for entry in body["endpoints"]:
        assert entry["healthy"] is True and entry["digest"]["name"] == entry["target"]
        assert "endpoint-metadata" not in entry and entry["endpoint"] == f"/gordo/v0/{PROJECT}/{entry['target']}/"
    full, _ = _snapshot(fleet.urls[0], full_metadata=True)
    for entry in full["endpoints"]:
        assert entry["endpoint-metadata"]["name"] == entry["target"] and "digest" not in entry


def test_snapshot_carries_bank_coverage_and_server_stats(fleet):
    body, _ = _snapshot(fleet.urls[1])
    assert set(body["bank"]["banked"]) == set(REPLICAS[1]) and body["bank"]["fallback"] == {}
    assert all(e["banked"] is True for e in body["endpoints"])
    assert body["server-stats"]["requests"] and "errors" in body["server-stats"]


def test_explicit_targets_mark_an_unknown_one(fleet):
    body, _ = _snapshot(fleet.urls[0], targets=["m-0", "ghost"])
    by_target = {e["target"]: e for e in body["endpoints"]}
    assert [e["target"] for e in body["endpoints"]] == ["m-0", "ghost"]
    assert by_target["m-0"]["banked"] is True and by_target["m-0"]["healthy"] is True
    assert by_target["ghost"]["banked"] is None and by_target["ghost"]["healthy"] is False
    assert "bank" in body


def test_an_unreachable_server_reads_unhealthy_and_degrades_the_rollup():
    body, state = _snapshot("http://127.0.0.1:1", targets=["m-1"])
    assert body["endpoints"][0]["healthy"] is False and "endpoint-metadata" not in body["endpoints"][0]
    agg = asyncio.run(state.fleet_metrics())
    assert agg["replicas_scraped"] == 0 and agg["shard_skew_ratio"] is None
    assert port_wm.render_fleet_metrics(agg).startswith("# HELP gordo_fleet_replicas")


def test_the_snapshot_is_cached_while_the_server_is_gone(fleet):
    tape = _Tape(fleet.urls[0])
    try:
        state = WatchmanState(PROJECT, tape.url, refresh_interval=300)

        async def twice():
            first = await state.snapshot()
            tape.dark = True
            return first, await state.snapshot()

        first, second = asyncio.run(twice())
        assert second is first and first["endpoints"]
    finally:
        tape.close()


class _Stub(ThreadingHTTPServer):
    """A collection server of ``n`` targets that counts its requests;
    ``batched=False`` has no ``metadata-all`` (a foreign server)."""

    daemon_threads = True

    def __init__(self, n, batched=True, metrics=None):
        self.names = [f"t-{i}" for i in range(n)]
        self.batched = batched
        self.metrics = metrics  # a list of /metrics answers, one a scrape (None: 500)
        self.count = 0
        super().__init__(("127.0.0.1", 0), _StubHandler)
        threading.Thread(target=self.serve_forever, kwargs={"poll_interval": 0.05}, daemon=True).start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.server_address[1]}"

    def close(self):
        self.shutdown()
        self.server_close()


class _StubHandler(BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def _send(self, status, body, ctype="application/json"):
        raw = body if isinstance(body, bytes) else json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def do_GET(self):
        srv = self.server
        srv.count += 1
        path = self.path.split("?")[0]
        prefix = f"/gordo/v0/{PROJECT}/"
        rest = path[len(prefix):] if path.startswith(prefix) else None
        if rest == "metadata-all" and srv.batched:
            return self._send(200, {"project": PROJECT, "targets": {
                n: {"healthy": True, "endpoint-metadata": {"name": n}} for n in srv.names}})
        if rest == "models":
            return self._send(200, {"project": PROJECT, "models": srv.names})
        if rest == "metrics" and srv.metrics:
            text = srv.metrics.pop(0) if len(srv.metrics) > 1 else srv.metrics[0]
            if text is None:
                return self._send(500, {"error": "boom"})
            return self._send(200, text.encode(), "text/plain; version=0.0.4")
        if rest and rest.count("/") == 1:
            target, endpoint = rest.split("/")
            if target in srv.names and endpoint == "healthcheck":
                return self._send(200, {})
            if target in srv.names and endpoint == "metadata":
                return self._send(200, {"endpoint-metadata": {"name": target}})
        return self._send(404, {"error": "not found"})


def test_a_snapshot_costs_two_requests_whatever_the_fleet_size():
    stub = _Stub(50)
    try:
        body, _ = _snapshot(stub.url)
    finally:
        stub.close()
    assert stub.count == 2  # metadata-all and the /stats decoration
    assert [e["target"] for e in body["endpoints"]] == sorted(stub.names)
    assert all(e["healthy"] and e["endpoint-metadata"]["name"] == e["target"] for e in body["endpoints"])


def test_a_server_without_metadata_all_is_polled_a_target_at_a_time():
    stub = _Stub(3, batched=False)
    try:
        body, _ = _snapshot(stub.url)
    finally:
        stub.close()
    by_target = {e["target"]: e for e in body["endpoints"]}
    assert set(by_target) == set(stub.names) and all(e["healthy"] for e in by_target.values())
    assert all(e["digest"]["name"] == t for t, e in by_target.items())  # digested here
    assert stub.count == 2 + 2 * len(stub.names)  # metadata-all (404), /models, two a target


def test_batched_snapshot_polls_an_explicit_unknown_target():
    stub = _Stub(2)
    try:
        body, _ = _snapshot(stub.url, targets=["t-0", "ghost"])
    finally:
        stub.close()
    assert [e["target"] for e in body["endpoints"]] == ["t-0", "ghost"]
    assert body["endpoints"][0]["healthy"] is True and body["endpoints"][1]["healthy"] is False


def test_a_missed_scrape_freezes_the_replica_and_stamps_it_stale():
    stub = _Stub(1, metrics=["gordo_engine_shed_total 42\n", None])
    clock = ReplayClock(1_780_000_000.0)
    try:
        state = WatchmanState(PROJECT, stub.url, refresh_interval=0.0, clock=clock)
        first = asyncio.run(state.fleet_metrics())
        clock.advance(7.5)
        second = asyncio.run(state.fleet_metrics())
    finally:
        stub.close()
    key = ("gordo_engine_shed_total", ())
    assert first["replicas_scraped"] == 1 and first["sums"][key] == 42.0
    assert second["replicas_scraped"] == 0 and second["sums"][key] == 42.0  # frozen, not dropped
    text = port_wm.render_fleet_metrics(second, clock.monotonic())
    assert 'gordo_fleet_scrape_stale_seconds{replica="0"} 7.5' in text


def test_http_metrics_serves_the_cache_and_snapshot_serves_last_good_under_faults(fleet):
    server = run_watchman(PROJECT, fleet.urls[0], host="127.0.0.1", port=0, refresh_interval=0.0,
                          metrics_urls=fleet.metrics_urls()[:1], background=True)
    try:
        status, _, text = _get(server.url + "/metrics")
        assert status == 200 and b"gordo_fleet_replicas_scraped 1" in text
        status, _, raw = _get(server.url + "/")
        first = json.loads(raw)
        assert status == 200 and "stale" not in first and len(first["endpoints"]) == len(REPLICAS[0])

        async def refreshed():  # the background refresh, settled
            if server.state._metrics_task is not None:
                await server.state._metrics_task

        server.app.run(refreshed())
        port_resilience.arm("watchman.scrape")
        port_resilience.arm("watchman.snapshot")
        # the cached rollup answers and a refresh starts in the background
        status, _, text = _get(server.url + "/metrics")
        assert status == 200 and b"gordo_fleet_replicas_scraped 1" in text
        server.app.run(refreshed())
        status, _, text = _get(server.url + "/metrics")
        assert status == 200
        assert b"gordo_fleet_replicas_scraped 0" in text and b"gordo_fleet_scrape_stale_seconds" in text
        assert b"gordo_server_requests_total" in text  # the last good series stay
        status, _, raw = _get(server.url + "/")
        stale = json.loads(raw)
        assert status == 200 and stale["stale"] is True and "FaultInjected" in stale["refresh_error"]
        assert stale["endpoints"] == first["endpoints"]
        port_resilience.reset()
        assert "stale" not in json.loads(_get(server.url + "/")[2])
    finally:
        port_resilience.reset()
        server.close()


def test_routing_version_steps_on_a_change_only_with_events(fleet):
    tapes = [_Tape(u) for u in fleet.urls]
    server = run_watchman(PROJECT, tapes[0].url, host="127.0.0.1", port=0, refresh_interval=300.0,
                          metrics_urls=fleet.metrics_urls([t.url for t in tapes]), background=True)
    try:
        status, headers, raw = _get(server.url + "/routing")
        table = json.loads(raw)
        assert status == 200 and table["version"] == 1 and table["migrating"] == {}
        assert set(table["members"].values()) == {0, 1, 2}
        etag = headers["ETag"]
        assert _get(server.url + "/routing?refresh=1", {"If-None-Match": etag})[0] == 304
        tapes[2].dark = True  # replica 2 goes away
        dark = json.loads(_get(server.url + "/routing?refresh=1")[2])
        assert dark["version"] == 2 and dark["replicas"][2]["status"] == "unreachable"
        assert "m-4" not in dark["members"]
        assert json.loads(_get(server.url + "/routing?refresh=1")[2])["version"] == 2  # still dark: no change
        tapes[2].dark = False
        back = json.loads(_get(server.url + "/routing?refresh=1")[2])
        assert back["version"] == 3 and back["members"] == table["members"]
        events = json.loads(_get(server.url + "/events?type=mesh.replica_unreachable,mesh.replica_recovered")[2])
        assert [(e["type"], e["attrs"]["replica_index"], e["replica"]) for e in events["events"]] == [
            ("mesh.replica_unreachable", 2, "watchman"), ("mesh.replica_recovered", 2, "watchman")]
        assert events["events"][0]["severity"] == "error"
        root = json.loads(_get(server.url + "/")[2])
        assert [r["url"] for r in root["replicas"]] == [t.url for t in tapes]
        assert PortClient.replicas_from_watchman(root) == [t.url for t in tapes]
        assert root["routing"] == {"version": 3, "age_s": root["routing"]["age_s"], "stale": False,
                                   "members": 5, "migrating": 0}
    finally:
        server.close()
        for t in tapes:
            t.close()


def test_a_member_on_two_replicas_resolves_by_name_and_reads_migrating(fleet):
    # replica 0 twice: every member of it is observed on replicas 0 and 1
    urls = fleet.metrics_urls([fleet.urls[0], fleet.urls[0]])
    state = WatchmanState(PROJECT, fleet.urls[0], metrics_urls=urls)
    table = asyncio.run(state.routing())
    jax_table = asyncio.run(jax_wm.WatchmanState(PROJECT, fleet.urls[0], metrics_urls=urls).routing())
    assert table["migrating"] == {n: [0, 1] for n in REPLICAS[0]}
    assert table["members"] == jax_table["members"] and table["migrating"] == jax_table["migrating"]


def test_an_empty_fleet_is_a_version_0_table():
    server = run_watchman(PROJECT, "http://127.0.0.1:1", host="127.0.0.1", port=0, refresh_interval=0.1,
                          metrics_urls=["http://127.0.0.1:1/gordo/v0/proj/metrics"], background=True)
    try:
        status, headers, raw = _get(server.url + "/routing")
        table = json.loads(raw)
        assert status == 200 and table["members"] == {}
        (rep,) = table["replicas"]
        assert rep["reachable"] is False and rep["status"] == "unreachable"
        assert json.loads(_get(server.url + "/healthcheck")[2]) == {VERSION_KEY: port_wm.__version__}
    finally:
        server.close()


# the write side's first answer over one dark replica: no replica reached, a
# destination the table does not have, fewer than two replicas to plan over
WRITE_FIRST = {
    "/rebalance": (200, lambda b: b["applied"] == 0 and [(r["replica"], r["reached"]) for r in b["replicas"]]
                   == [(0, False)]),
    "/migrate": (409, lambda b: b == {"moved": False, "member": "m-0", "error": "unknown destination replica 1"}),
    "/fleet-rebalance": (200, lambda b: b["applied"] == 0 and b["plan"]["reason"]
                         == "fewer than two replicas (nothing to move between)"),
}


@pytest.mark.parametrize("path", ["/rebalance", "/migrate", "/fleet-rebalance"])
def test_write_routes_answer_a_post_405_to_a_get_and_404_elsewhere(path):
    """Once answered 501; each write route now answers a POST (its first
    answer over a dark replica), 405 to a GET, and an unknown path 404."""
    server = run_watchman(PROJECT, "http://127.0.0.1:1", host="127.0.0.1", port=0, background=True)
    try:
        status, _, raw = _get(server.url + path, method="POST", data=b'{"member": "m-0", "to": 1}')
        want_status, check = WRITE_FIRST[path]
        assert status == want_status and check(json.loads(raw)), (status, raw)
        assert _get(server.url + path)[0] == 405
        assert _get(server.url + "/nowhere")[0] == 404
    finally:
        server.close()


def test_a_routed_client_answers_as_each_owner_does_directly(fleet):
    server = run_watchman(PROJECT, fleet.urls[0], host="127.0.0.1", port=0,
                          metrics_urls=fleet.metrics_urls(), background=True)
    span = ("2020-01-01T00:00:00Z", "2020-01-01T12:00:00Z")
    try:
        routed = PortClient(PROJECT, base_url=fleet.urls[0], routing_url=server.url, batch_size=30)
        results = {r.name: r for r in routed.predict(*span)}
        assert routed.routing_version == 1 and routed.transport_used == "tcp"
        assert sorted(results) == sorted(n for members in REPLICAS for n in members)
        for base, members in zip(fleet.urls, REPLICAS):
            direct = PortClient(PROJECT, base_url=base, batch_size=30, use_tensor=routed.use_tensor,
                                transport="tcp")
            for r in direct.predict(*span, targets=list(members)):
                got = results[r.name]
                assert r.ok and got.ok, (r.error_messages, got.error_messages)
                np.testing.assert_array_equal(got.predictions.values, r.predictions.values)
                np.testing.assert_array_equal(got.predictions.index, r.predictions.index)
    finally:
        server.close()


def test_run_watchman_options_are_the_jax_clis():
    import click

    from gordo_components_torch.cli.cli import _parser
    from gordo_components_tpu.cli.cli import gordo

    jax = {}
    for p in gordo.commands["run-watchman"].params:
        if isinstance(p, click.Option):
            jax[p.opts[0]] = (p.envvar, p.default, p.is_flag, p.required)
    sub = next(a for a in _parser()._actions if a.dest == "command").choices["run-watchman"]
    env = {"--project": "PROJECT_NAME", "--server-base-url": "SERVER_BASE_URL", "--targets": "TARGET_NAMES",
           "--gang-state-dir": "GANG_STATE_DIR", "--full-metadata": "WATCHMAN_FULL_METADATA"}
    port = {a.option_strings[0] for a in sub._actions if a.option_strings and a.dest != "help"}
    assert port == set(jax)
    for opt, (envvar, default, is_flag, required) in jax.items():
        assert env.get(opt) == envvar, opt
        action = next(a for a in sub._actions if opt in a.option_strings)
        if not envvar:
            assert action.default == default, opt
        assert (action.nargs == 0) == is_flag, opt
    before = _set_env({"PROJECT_NAME": "p", "SERVER_BASE_URL": "http://x", "TARGET_NAMES": '["a"]',
                       "WATCHMAN_FULL_METADATA": "1", "GANG_STATE_DIR": "/g"})
    try:
        args = _parser().parse_args(["run-watchman"])
    finally:
        _restore_env(before)
    assert (args.project, args.server_base_url, args.targets, args.full_metadata, args.gang_state_dir,
            args.host, args.port) == ("p", "http://x", '["a"]', True, "/g", "0.0.0.0", 5556)


def test_run_watchman_cli_serves_and_stops_on_sigterm(fleet):
    import signal
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PROJECT_NAME=PROJECT, SERVER_BASE_URL=fleet.urls[0], TARGET_NAMES='["m-0", "ghost"]')
    proc = subprocess.Popen([sys.executable, "-m", "gordo_components_torch.cli", "run-watchman", "--host",
                             "127.0.0.1", "--port", str(port)], cwd=repo, env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        for _ in range(600):  # the interpreter's start: until it answers, or it exits
            try:
                status, _, raw = _get(f"http://127.0.0.1:{port}/healthcheck")
                break
            except OSError:
                assert proc.poll() is None, proc.returncode
                threading.Event().wait(0.1)
        assert status == 200 and VERSION_KEY in json.loads(raw)
        body = json.loads(_get(f"http://127.0.0.1:{port}/")[2])
        assert [(e["target"], e["healthy"]) for e in body["endpoints"]] == [("m-0", True), ("ghost", False)]
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0


async def test_full_metadata_explicit_targets_and_gangs_answer_as_jax(fleet, tmp_path, monkeypatch):
    import types

    import gordo_components_torch.workflow.gang_state as port_gangs
    import gordo_components_tpu.workflow.gang_state as jax_gangs

    still = types.SimpleNamespace(time=lambda: 1_780_000_100.0)  # one wall clock for both readers' ages
    monkeypatch.setattr(port_gangs, "time", still)
    monkeypatch.setattr(jax_gangs, "time", still)
    gangs = tmp_path / "gangs"
    gangs.mkdir()
    for gang, phase, ts in (("g-0", "training", 1_780_000_000.0), ("g-1", "done", 1_779_990_000.0),
                            ("g-2", "loading", 1_779_999_000.0)):
        (gangs / f"{gang}.json").write_text(json.dumps({"gang": gang, "phase": phase, "ts": ts, "epoch": 2}))
    (gangs / "broken.json").write_text("{not json")
    pair = await _pair(fleet, targets=["m-1", "ghost", "m-0"], full_metadata=True, gang_state_dir=str(gangs))
    try:
        _, _, root = await pair.same("/")
        assert [e["target"] for e in root["endpoints"]] == ["m-1", "ghost", "m-0"]
        assert root["endpoints"][1]["healthy"] is False and root["endpoints"][1]["banked"] is None
        assert root["endpoints"][0]["endpoint-metadata"]["name"] == "m-1"
        assert [(g["gang"], g["stale"]) for g in root["gangs"]] == [("g-0", False), ("g-1", False), ("g-2", True)]
    finally:
        await _close(pair)


def test_a_hung_replica_never_holds_up_the_snapshot_or_a_cached_rollup(fleet):
    live, hung = _Tape(fleet.urls[0]), _Tape(fleet.urls[1])
    hung.gate = threading.Event()
    clock = ReplayClock(1_780_000_000.0)
    server = run_watchman(PROJECT, live.url, host="127.0.0.1", port=0, metrics_urls=fleet.metrics_urls(
        [live.url, hung.url]), clock=clock, background=True)

    async def settled():  # the background refreshes, done
        for task in (server.state._metrics_task, server.state._routing_task, server.state._drift_task):
            if task is not None:
                await task

    try:
        # the snapshot reads the live base; the rollups start in the background
        status, _, raw = _get(server.url + "/")
        body = json.loads(raw)
        assert status == 200 and not hung.gate.is_set()  # answered while the hung replica holds its requests
        assert [e["target"] for e in body["endpoints"]] == list(REPLICAS[0])
        assert body["replicas"] == [{"replica": 0, "url": live.url}, {"replica": 1, "url": hung.url}]
        assert "fleet-metrics" not in body and "routing" not in body
        hung.gate.set()
        server.app.run(settled())
        assert b"gordo_fleet_replicas_scraped 2" in _get(server.url + "/metrics")[2]
        # a cached rollup answers at once while its refresh waits on the hung replica
        hung.gate = threading.Event()
        clock.advance(30.0)
        status, _, text = _get(server.url + "/metrics")
        assert status == 200 and b"gordo_fleet_replicas_scraped 2" in text and not hung.gate.is_set()
        body = json.loads(_get(server.url + "/")[2])
        assert body["routing"]["version"] == 1 and body["fleet-metrics"]["replicas_scraped"] == 2
        assert not hung.gate.is_set()
    finally:
        hung.gate.set()
        server.close()
        live.close()
        hung.close()
