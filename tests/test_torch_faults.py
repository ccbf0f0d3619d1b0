"""The port's fault points (``resilience/faults.py`` and the sites threaded
through the builder and the server) against the JAX package's, on the CPU.

- **Registry.** The mechanics of JAX ``tests/test_chaos.py:144-246``
  (raise N times, seeded probability, latency, the context-manager and
  decorator forms, the ``GORDO_FAULTS`` grammar and the transport kinds),
  each on both registries; the disarmed ``fire()`` reads one slot. The
  port registers every site of the JAX package (the watchman's three,
  ``watchman.probe``, ``watchman.scrape`` and ``watchman.snapshot``, are
  driven in tests/test_torch_watchman.py).
- **Build under faults.** ``fleet_build.group=error,times=1`` through
  ``GORDO_FAULTS`` gives a full build with ``group_retries == 1``, and a
  group poisoned past its retries a partial manifest and exit 84, in both
  CLIs.
- **Serving under faults.** The same armed spec on the JAX server and the
  port's, over two JAX-fitted detectors (the port's converted by
  ``tools/jax_artifact_to_torch.py``): ``model_io.load`` serves the healthy
  subset and recovers on ``/reload``; ``bank.finalize`` serves per model
  with ``/healthz`` degraded; ``bank.score`` quarantines and answers 410;
  ``engine.queue`` degrades and recovers. The port's ``/events`` lists each
  ``fault.fired`` (the JAX server installs its listener at start-up, after
  it loaded the collection, so its log holds the request-time fires only).
- **Transport.** ``server.connection`` drops the connection unanswered:
  ``reset`` with an RST, ``refuse`` and ``blackhole`` with a close.
"""

import asyncio
import contextlib
import http.client
import importlib.util
import json
import os
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer
from click.testing import CliRunner

import gordo_components_tpu.resilience as jax_resilience
from gordo_components_torch import resilience as port_resilience
from gordo_components_torch.cli import main
from gordo_components_torch.resilience import faults as port_faults
from gordo_components_torch.server import run_server
from gordo_components_tpu import serializer as jax_serializer
from gordo_components_tpu.cli.cli import gordo
from gordo_components_tpu.models import AutoEncoder, DiffBasedAnomalyDetector
from gordo_components_tpu.resilience.faults import FaultSpec as JaxFaultSpec
from gordo_components_tpu.server import build_app as jax_build_app

REGISTRIES = {"jax": jax_resilience, "port": port_resilience}
# the JAX package's sites that wait for the port of their modules: none
WAITING = set()
PORT_SITES = {"bank.finalize", "bank.quantize", "bank.score", "bank.swap", "checkpoint.read", "checkpoint.write",
              "engine.queue", "fleet_build.group", "model_io.load", "server.connection", "stream.ingest",
              "stream.refit", "watchman.probe", "watchman.scrape", "watchman.snapshot", "workflow.canary"}
_SPEC = importlib.util.spec_from_file_location(
    "jax_artifact_to_torch",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools", "jax_artifact_to_torch.py"))
TOOL = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(TOOL)


@pytest.fixture(autouse=True)
def _clean_faults():
    """No armed site leaks into the next test, or into another file on this
    worker; both registries."""
    for r in REGISTRIES.values():
        r.reset()
    yield
    for r in REGISTRIES.values():
        r.reset()


# ---------------------------------------------------------------------- #
# the registry, on both packages
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("pkg", sorted(REGISTRIES))
def test_raise_n_times_then_passes(pkg):
    r = REGISTRIES[pkg]
    point = r.faultpoint("chaos.test.n")
    r.arm("chaos.test.n", times=2, exc=OSError)
    for _ in range(2):
        with pytest.raises(OSError):
            point.fire()
    point.fire()
    assert r.fault_stats()["chaos.test.n"]["fired"] == 2


def _decisions(spec_cls, seed):
    spec = spec_cls(p=0.5, seed=seed)
    out = []
    for _ in range(32):
        try:
            spec.fire("chaos.test.p")
            out.append(False)
        except Exception:
            out.append(True)
    return out


def test_probabilistic_raise_is_seeded_and_the_same_in_both():
    port = [_decisions(port_faults.FaultSpec, s) for s in (7, 7, 8)]
    assert port[0] == port[1] != port[2] and any(port[0]) and not all(port[0])
    assert port[0] == _decisions(JaxFaultSpec, 7)


@pytest.mark.parametrize("pkg", sorted(REGISTRIES))
def test_latency_delays_without_raising(pkg):
    r = REGISTRIES[pkg]
    point = r.faultpoint("chaos.test.latency")
    r.arm("chaos.test.latency", delay_s=0.03, exc=None)
    t0 = time.perf_counter()
    point.fire()
    assert time.perf_counter() - t0 >= 0.025


@pytest.mark.parametrize("pkg", sorted(REGISTRIES))
def test_context_and_decorator_forms(pkg):
    r = REGISTRIES[pkg]
    point = r.faultpoint("chaos.test.forms")
    r.arm("chaos.test.forms", times=2)
    with pytest.raises(r.FaultInjected):
        with point:
            pass

    @point
    def work():
        return "done"

    with pytest.raises(r.FaultInjected):
        work()
    assert work() == "done"


@pytest.mark.parametrize("pkg", sorted(REGISTRIES))
def test_env_grammar_and_pre_registration(pkg):
    r = REGISTRIES[pkg]
    assert r.configure_from_env("chaos.test.env=error:OSError,times=3;chaos.test.lat=latency:0.001") == 2
    stats = r.fault_stats()
    assert stats["chaos.test.env"]["exception"] == "OSError" and stats["chaos.test.env"]["times"] == 3
    assert stats["chaos.test.lat"]["delay_s"] == 0.001
    r.arm("chaos.test.notyet", times=1)  # parked until the site registers
    with pytest.raises(r.FaultInjected):
        r.faultpoint("chaos.test.notyet").fire()
    for bad in ("chaos.test.bad=explode", "chaos.test.bad=error:os.system", "chaos.test.bad",
                "chaos.test.bad=error,when=now", "chaos.test.bad=refuse:x", "chaos.test.bad=reset:9"):
        with pytest.raises(ValueError):
            r.configure_from_env(bad)


@pytest.mark.parametrize("pkg", sorted(REGISTRIES))
def test_transport_fault_kinds(pkg):
    r = REGISTRIES[pkg]
    assert r.configure_from_env("chaos.test.refuse=refuse,times=1;chaos.test.reset=reset,times=1;"
                                "chaos.test.hole=blackhole:0.05,times=1") == 3
    with pytest.raises(ConnectionRefusedError):
        r.faultpoint("chaos.test.refuse").fire()
    with pytest.raises(ConnectionResetError):
        r.faultpoint("chaos.test.reset").fire()
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        r.faultpoint("chaos.test.hole").fire()
    assert time.perf_counter() - t0 >= 0.04
    for site in ("chaos.test.refuse", "chaos.test.reset", "chaos.test.hole"):
        r.faultpoint(site).fire()


def test_the_fire_listener_sees_armed_fires_only_and_the_registries_are_apart():
    seen = []
    prev = port_faults.set_fire_listener(lambda site, spec: seen.append((site, spec.fired)))
    try:
        point = port_faults.faultpoint("chaos.test.listen")
        point.fire()
        jax_resilience.arm("chaos.test.listen", times=1)  # the JAX registry's site
        point.fire()
        port_resilience.arm("chaos.test.listen", times=1, exc=None)
        point.fire()
        point.fire()
    finally:
        port_faults.set_fire_listener(prev)
    assert seen == [("chaos.test.listen", 1)]
    assert point.__slots__ == ("site", "_spec") and point._spec is not None


def test_the_port_registers_the_jax_sites_less_those_that_wait():
    import gordo_components_torch.builder.fleet_build  # noqa: F401
    import gordo_components_torch.parallel.checkpoint  # noqa: F401
    import gordo_components_torch.server  # noqa: F401
    import gordo_components_torch.watchman.server  # noqa: F401
    import gordo_components_torch.workflow.canary  # noqa: F401
    import gordo_components_tpu.builder.fleet_build  # noqa: F401
    import gordo_components_tpu.parallel.checkpoint  # noqa: F401
    import gordo_components_tpu.placement.swap  # noqa: F401
    import gordo_components_tpu.server.bank  # noqa: F401
    import gordo_components_tpu.server.model_io  # noqa: F401
    import gordo_components_tpu.streaming  # noqa: F401
    import gordo_components_tpu.watchman.server  # noqa: F401
    import gordo_components_tpu.workflow.canary  # noqa: F401

    port = {s for s in port_resilience.registered_sites() if not s.startswith("chaos.test.")}
    jax = {s for s in jax_resilience.registered_sites() if not s.startswith("chaos.test.")}
    assert port == PORT_SITES
    assert jax - port == WAITING


# ---------------------------------------------------------------------- #
# the build under faults, through both CLIs
# ---------------------------------------------------------------------- #

DATA = {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00Z",
        "train_end_date": "2020-01-01T06:00:00Z"}


def _machines(pkg):
    def det(kind):  # the canonical pipeline: it trains in a fleet group
        return {f"{pkg}.models.DiffBasedAnomalyDetector": {"base_estimator": {"sklearn.pipeline.Pipeline": {
            "steps": ["sklearn.preprocessing.MinMaxScaler", {f"{pkg}.models.AutoEncoder": {
                "kind": kind, "dims": [4], "epochs": 1, "batch_size": 32}}]}}}}

    # two groups, in this order: the hourglass one trains first
    return {"machines": [
        {"name": "g1", "dataset": dict(DATA, tag_list=["g1-a", "g1-b"]), "model": det("feedforward_hourglass")},
        {"name": "g2", "dataset": dict(DATA, tag_list=["g2-a", "g2-b"]), "model": det("feedforward_symmetric")},
    ]}


@pytest.mark.parametrize("spec, rc, built, failed, retries", [
    ("fleet_build.group=error,times=1", 0, ["g1", "g2"], [], 1),
    # the first group fails its try and its retry; the second ships
    ("fleet_build.group=error:OSError,times=2", 84, ["g2"], ["g1"], 1),
], ids=["retried", "poisoned"])
def test_build_fleet_under_group_faults_matches_jax(spec, rc, built, failed, retries, tmp_path, capsys,
                                                   monkeypatch):
    manifests = {}
    for pkg, out in (("gordo_components_tpu", "j"), ("gordo_components_torch", "p")):
        path = tmp_path / f"{out}.json"
        path.write_text(json.dumps(_machines(pkg)))
        args = ["build-fleet", "--machines-file", str(path), "--output-dir", str(tmp_path / out)]
        # one gang thread on both sides: on several threads the groups race
        # for the fault's fires, and the verdict follows their order
        if out == "j":
            result = CliRunner().invoke(gordo, args, env={"GORDO_FAULTS": spec, "GORDO_GANG_WIDTH": "1"})
            got_rc, text = result.exit_code, result.stdout
        else:
            monkeypatch.setenv("GORDO_FAULTS", spec)
            monkeypatch.setenv("GORDO_GANG_WIDTH", "1")
            got_rc, text = main(["--device", "cpu", *args]), capsys.readouterr().out
            monkeypatch.delenv("GORDO_FAULTS")
        assert got_rc == rc, (pkg, text)
        manifests[out] = json.loads(text)
    for m in manifests.values():
        assert sorted(m["built"]) == built and sorted(m["failed"]) == failed
        assert m["group_retries"] == retries
    assert "OSError" in "".join(manifests["p"]["failed"].values()) or not failed


# ---------------------------------------------------------------------- #
# serving under faults, on both servers
# ---------------------------------------------------------------------- #


def _x_payload(rows=24, cols=3):
    return {"X": np.random.RandomState(7).rand(rows, cols).tolist()}


@pytest.fixture(scope="module")
def collections(tmp_path_factory):
    """Two JAX-fitted detectors as JAX artifacts and as port artifacts."""
    X = np.random.RandomState(0).rand(160, 3).astype("float32")
    jax_root, port_root = tmp_path_factory.mktemp("jax-chaos"), tmp_path_factory.mktemp("port-chaos")
    for i, name in enumerate(("chaos-a", "chaos-b")):
        det = DiffBasedAnomalyDetector(base_estimator=AutoEncoder(epochs=1, batch_size=64))
        det.fit(X + 0.01 * i)
        jax_serializer.dump(det, str(jax_root / name), metadata={"name": name})
    assert TOOL.main([str(jax_root), str(port_root)]) == 0
    return str(jax_root), str(port_root)


class _Port:
    """The port's server, driven over HTTP."""

    def __init__(self, root, **kw):
        self.server = run_server(root, host="127.0.0.1", port=0, device="cpu", background=True, **kw)

    async def call(self, method, path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(self.server.url + path, data=data, method=method,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read())

    def close(self):
        self.server.close()


class _Jax:
    def __init__(self, client):
        self.client = client

    async def call(self, method, path, body=None):
        resp = await (self.client.post(path, json=body) if method == "POST" else self.client.get(path))
        return resp.status, await resp.json()


@contextlib.asynccontextmanager
async def _serve(pkg, collections, **kw):
    if pkg == "jax":
        client = TestClient(TestServer(jax_build_app(collections[0], devices=1, **kw)))
        await client.start_server()
        try:
            yield _Jax(client)
        finally:
            await client.close()
    else:
        server = _Port(collections[1], **kw)
        try:
            yield server
        finally:
            server.close()


async def _fault_events(srv, site):
    status, body = await srv.call("GET", "/gordo/v0/proj/events?type=fault.fired")
    assert status == 200
    return [e for e in body["events"] if e["attrs"].get("site") == site]


async def _health(srv):
    status, body = await srv.call("GET", "/gordo/v0/proj/healthz")
    assert status == 200
    return body


PAYLOAD = _x_payload()


@pytest.mark.parametrize("pkg", sorted(REGISTRIES))
async def test_load_fault_serves_the_healthy_subset_and_recovers(pkg, collections):
    REGISTRIES[pkg].arm("model_io.load", times=1, exc=OSError)
    async with _serve(pkg, collections) as srv:
        body = await _health(srv)
        assert body["status"] == "degraded" and len(body["load_failures"]) == 1 and body["models"] == 1
        survivor = "chaos-" + ("b" if "chaos-a" in body["load_failures"] else "a")
        assert (await srv.call("POST", f"/gordo/v0/proj/{survivor}/prediction", PAYLOAD))[0] == 200
        assert (await srv.call("POST", "/gordo/v0/proj/reload"))[0] == 200
        body = await _health(srv)
        assert body["status"] == "ok" and body["models"] == 2
        if pkg == "port":
            (ev,) = await _fault_events(srv, "model_io.load")
            assert ev["severity"] == "warning" and ev["attrs"]["fired"] == 1


@pytest.mark.parametrize("pkg", sorted(REGISTRIES))
async def test_finalize_fault_serves_per_model_and_is_degraded(pkg, collections):
    REGISTRIES[pkg].arm("bank.finalize", times=1)
    async with _serve(pkg, collections) as srv:
        body = await _health(srv)
        assert body["status"] == "degraded" and body["bank_finalize_failures"]
        status, models = await srv.call("GET", "/gordo/v0/proj/models")
        assert models["bank"]["banked"] == []
        assert all("bucket finalize failed" in r for r in models["bank"]["fallback"].values())
        for name in ("chaos-a", "chaos-b"):
            assert (await srv.call("POST", f"/gordo/v0/proj/{name}/anomaly/prediction", PAYLOAD))[0] == 200
        if pkg == "port":
            assert len(await _fault_events(srv, "bank.finalize")) == 1


@pytest.mark.parametrize("pkg", sorted(REGISTRIES))
async def test_score_fault_quarantines_and_answers_410(pkg, collections):
    async with _serve(pkg, collections, quarantine_threshold=3) as srv:
        REGISTRIES[pkg].arm("bank.score")
        for _ in range(3):
            assert (await srv.call("POST", "/gordo/v0/proj/chaos-a/prediction", PAYLOAD))[0] == 400
        status, body = await srv.call("POST", "/gordo/v0/proj/chaos-a/prediction", PAYLOAD)
        assert status == 410 and "quarantined" in body["error"] and "FaultInjected" in body["reason"]
        health = await _health(srv)
        assert health["status"] == "degraded" and "chaos-a" in health["quarantined"]
        REGISTRIES[pkg].reset()
        assert (await srv.call("POST", "/gordo/v0/proj/chaos-b/prediction", PAYLOAD))[0] == 200
        assert len(await _fault_events(srv, "bank.score")) >= 3


@pytest.mark.parametrize("pkg", sorted(REGISTRIES))
async def test_engine_queue_fault_degrades_and_recovers(pkg, collections):
    async with _serve(pkg, collections, quarantine_threshold=3) as srv:
        REGISTRIES[pkg].arm("engine.queue")
        for _ in range(3):
            assert (await srv.call("POST", "/gordo/v0/proj/chaos-b/prediction", PAYLOAD))[0] == 400
        assert (await _health(srv))["status"] == "degraded"
        REGISTRIES[pkg].reset()
        await srv.call("POST", "/gordo/v0/proj/quarantine/clear", {})
        assert (await srv.call("POST", "/gordo/v0/proj/chaos-b/prediction", PAYLOAD))[0] == 200
        assert len(await _fault_events(srv, "engine.queue")) >= 3


def test_swap_fault_keeps_the_old_generation_serving(collections):
    srv = _Port(collections[1])
    try:
        port_resilience.arm("bank.swap", times=1)
        status, _ = asyncio.run(srv.call("POST", "/gordo/v0/proj/reload"))
        assert status >= 500
        assert srv.server.app.bank.generation == 0
        assert asyncio.run(srv.call("POST", "/gordo/v0/proj/chaos-a/prediction", PAYLOAD))[0] == 200
        assert asyncio.run(srv.call("POST", "/gordo/v0/proj/reload"))[0] == 200
        assert srv.server.app.bank.generation == 1
        types = [e["type"] for e in asyncio.run(srv.call("GET", "/gordo/v0/proj/events"))[1]["events"]]
        assert "bank.swap_failed" in types and "fault.fired" in types
    finally:
        srv.close()


# ---------------------------------------------------------------------- #
# server.connection: the connection dies unanswered
# ---------------------------------------------------------------------- #


def _raw_request(url):
    """The raw bytes answered to one POST, or the OSError that cut it."""
    host, port = url.split("//")[1].split(":")
    body = json.dumps(PAYLOAD).encode()
    with socket.create_connection((host, int(port)), timeout=10) as s:
        s.sendall(b"POST /gordo/v0/proj/chaos-a/prediction HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n" % len(body) + body)
        out = b""
        try:
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    return out
                out += chunk
                if b"\r\n\r\n" in out and out.split(b"\r\n")[0].endswith(b" 200 OK"):
                    return out
        except OSError as exc:
            return exc


@pytest.mark.parametrize("spec, want", [("reset,times=1", ConnectionResetError), ("refuse,times=1", b""),
                                        ("blackhole:0.05,times=1", b"")])
def test_connection_fault_drops_the_request_unanswered(spec, want, collections):
    srv = _Port(collections[1])
    try:
        port_resilience.configure_from_env(f"server.connection={spec}")
        got = _raw_request(srv.server.url)
        if isinstance(want, type):
            assert isinstance(got, want), got
        else:
            assert got == want
        assert _raw_request(srv.server.url).split(b"\r\n")[0].endswith(b" 200 OK")
        with pytest.raises((http.client.HTTPException, OSError)):
            port_resilience.arm("server.connection", times=1, exc=ConnectionResetError)
            urllib.request.urlopen(srv.server.url + "/gordo/v0/proj/healthz", timeout=10)
        (ev, _ev2) = [e for e in srv.server.app.events.events(types=["fault.fired"])]
        assert ev["attrs"]["site"] == "server.connection"
    finally:
        srv.close()
