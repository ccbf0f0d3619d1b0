"""The port's QoS against the JAX package's, on the CPU: the weighted-fair
queue, the admission controller, the engine's classes, and the served
routes of the server's second observability half.

- The fair queue: one sequence of puts and pops (classes, deadlines,
  weights, idle gaps between bursts), made from a numpy seed, gives the
  JAX queue and the port's the same pop order and equal ``snapshot()``s
  after every pop; the starvation bound, FIFO in one class, deadline order
  and the idle-credit rule of ``tests/test_qos.py``; eight threads putting
  at once lose nothing and never overfill the bound.
- Admission: one request sequence under a fake clock gives both
  controllers the same admits, refusals, reasons, ``Retry-After`` and
  snapshots, the goodput-burn rule with ``burn_for`` stubbed;
  ``parse_tenants`` and ``_parse_fractions`` agree, malformed input too.
- The engine dequeues by class through the fair queue and counts each
  class's requests, sheds and expiries.
- HTTP: the JAX app and the port's app take one request sequence (a
  tenant over its rate, a ``best_effort`` POST under queue pressure, a
  quarantine's enter and clear, a reload); both answer the same statuses,
  429 bodies and ``Retry-After``, the same keys and integers in ``/qos``,
  ``/heat``, ``/events`` and ``/history``, the same event types in the same
  order, and the same disabled answers. Both apps' admission runs on one
  clock that stands still, so the 429s do not depend on the wall clock.
"""

import asyncio
import importlib.util
import json
import os
import queue
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
from aiohttp.test_utils import TestClient, TestServer

from gordo_components_torch.qos import admission as port_admission
from gordo_components_torch.qos import fair as port_fair
from gordo_components_torch.qos.classify import RequestClass as PortRequestClass
from gordo_components_torch.server import run_server
from gordo_components_torch.server.engine import BatchingEngine, EngineOverloaded
from gordo_components_torch.resilience.deadline import Deadline
from gordo_components_tpu import serializer as jax_serializer
from gordo_components_tpu.models import AutoEncoder, DiffBasedAnomalyDetector
from gordo_components_tpu.qos import admission as jax_admission
from gordo_components_tpu.qos import fair as jax_fair
from gordo_components_tpu.qos.classify import RequestClass as JaxRequestClass
from gordo_components_tpu.server import build_app as jax_build_app

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = importlib.util.spec_from_file_location(
    "jax_artifact_to_torch", os.path.join(REPO, "tools", "jax_artifact_to_torch.py"))
TOOL = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(TOOL)

CLASSES = ("interactive", "batch", "best_effort")


def _pending(cls, deadline=None, i=None):
    return SimpleNamespace(qos_class=cls, deadline=deadline, i=i)


# ------------------------------------------------------------------ #
# the weighted-fair queue
# ------------------------------------------------------------------ #


def _wfq_ops(seed):
    """A seeded sequence of ("put", class, expires or None) and ("pop",)
    ops: bursts of puts, some classes idle for a while, pops between."""
    rng = np.random.default_rng(seed)
    ops, i = [], 0
    for burst in range(12):
        live = [c for c in CLASSES if rng.random() < 0.7] or ["batch"]
        for _ in range(int(rng.integers(1, 12))):
            cls = str(rng.choice(live + ["martian"] * (burst == 3)))
            expires = None if rng.random() < 0.4 else float(rng.integers(0, 20))
            ops.append(("put", cls, expires, i))
            i += 1
        ops += [("pop",)] * int(rng.integers(0, 14))
    return ops


@pytest.mark.parametrize("seed,weights", [
    (0, None), (1, None), (2, {"interactive": 3.0, "batch": 3.0, "best_effort": 0.5}),
    (3, {"batch": 7.0}), (4, {"interactive": 1.0, "best_effort": 1.0}),
])
def test_fair_queue_pops_in_the_jax_order(seed, weights):
    jq, pq = jax_fair.WeightedFairQueue(weights), port_fair.WeightedFairQueue(weights)
    got, want = [], []
    for op in _wfq_ops(seed):
        if op[0] == "put":
            _, cls, expires, i = op
            for q in (jq, pq):
                q.put_nowait(_pending(cls, None if expires is None else SimpleNamespace(expires_at=expires), i))
        elif pq.qsize():
            want.append(jq.get_nowait().i)
            got.append(pq.get_nowait().i)
            assert pq.snapshot() == jq.snapshot()
        assert pq.qsize() == jq.qsize() and pq.depths() == jq.depths()
    while pq.qsize():
        want.append(jq.get_nowait().i)
        got.append(pq.get_nowait().i)
    assert got == want and len(got) > 50
    assert pq.snapshot() == jq.snapshot() and pq.empty()


def test_fair_queue_starvation_bound_under_a_best_effort_backlog():
    q = port_fair.WeightedFairQueue()
    for _ in range(100):
        q.put_nowait(_pending("best_effort"))
    for _ in range(16):
        q.put_nowait(_pending("interactive"))
    order = [q.get_nowait().qos_class for _ in range(30)]
    assert order[:18].count("interactive") == 16 and order[:18].count("best_effort") == 2
    assert q.dequeued["interactive"] == 16


def test_fair_queue_is_fifo_in_one_class_and_by_deadline_inside_a_class():
    q = port_fair.WeightedFairQueue()
    items = [_pending("interactive") for _ in range(5)]
    for it in items:
        q.put_nowait(it)
    assert [q.get_nowait() for _ in range(5)] == items
    late = _pending("batch", SimpleNamespace(expires_at=30.0))
    soon = _pending("batch", SimpleNamespace(expires_at=10.0))
    none = _pending("batch", None)
    for it in (late, none, soon):
        q.put_nowait(it)
    assert [q.get_nowait() for _ in range(3)] == [soon, late, none]


def test_fair_queue_idle_class_banks_no_credit_and_unknown_is_interactive():
    q = port_fair.WeightedFairQueue()
    for _ in range(50):
        q.put_nowait(_pending("best_effort"))
    for _ in range(40):
        q.get_nowait()
    q.put_nowait(_pending("interactive"))
    assert q._vtime["interactive"] >= q._vtime["best_effort"]
    q.put_nowait(SimpleNamespace(qos_class="martian"))
    assert q.depths()["interactive"] == 2


@pytest.mark.parametrize("spec", ["", "interactive=-3,junk,batch=abc", "best-effort=4", "batch=0,interactive=2.5"])
def test_parse_weights_matches_jax(spec, monkeypatch):
    assert port_fair.parse_weights(spec) == jax_fair.parse_weights(spec)
    monkeypatch.setenv("GORDO_QOS_WEIGHTS", spec)
    assert port_fair.parse_weights() == jax_fair.parse_weights()


def test_fair_queue_surface_and_bound():
    q = port_fair.WeightedFairQueue(maxsize=2)
    assert q.empty() and q.qsize() == 0
    with pytest.raises(queue.Empty):
        q.get_nowait()
    with pytest.raises(queue.Empty):
        q.get(timeout=0.01)
    q.put_nowait(_pending("batch"))
    q.put_nowait(_pending("interactive"))
    with pytest.raises(queue.Full):
        q.put_nowait(_pending("interactive"))
    assert q.get(timeout=1).qos_class == "interactive" and q.qsize() == 1
    # a waiting get wakes on a put from another thread
    q.get_nowait()
    got = []
    waiter = threading.Thread(target=lambda: got.append(q.get(timeout=10)))
    waiter.start()
    item = _pending("best_effort")
    q.put_nowait(item)
    waiter.join(10)
    assert got == [item]


def test_fair_queue_loses_nothing_under_eight_threads_and_holds_its_bound():
    bound, per_thread = 300, 200
    q = port_fair.WeightedFairQueue(maxsize=bound)
    accepted, full, popped, peak = [], [0], [], [0]
    lock = threading.Lock()
    start = threading.Barrier(9)

    def producer(t):
        start.wait()
        for i in range(per_thread):
            item = _pending(CLASSES[(t + i) % 3], i=(t, i))
            try:
                q.put_nowait(item)
            except queue.Full:
                with lock:
                    full[0] += 1
                continue
            depth = q.qsize()
            with lock:
                accepted.append(item.i)
                peak[0] = max(peak[0], depth)

    produced = threading.Event()

    def consumer():
        start.wait()
        while not (produced.is_set() and q.empty()):
            try:
                item = q.get(timeout=0.05)
            except queue.Empty:
                continue
            peak[0] = max(peak[0], q.qsize())
            popped.append(item.i)

    producers = [threading.Thread(target=producer, args=(t,)) for t in range(8)]
    drain = threading.Thread(target=consumer)
    old = os.sys.getswitchinterval()
    os.sys.setswitchinterval(1e-6)
    try:
        for th in producers + [drain]:
            th.start()
        for th in producers:
            th.join(60)
        produced.set()
        drain.join(60)
    finally:
        os.sys.setswitchinterval(old)
    assert len(accepted) + full[0] == 8 * per_thread
    assert sorted(popped) == sorted(accepted) and q.empty()
    assert peak[0] <= bound and sum(q.dequeued.values()) == len(accepted)


# ------------------------------------------------------------------ #
# admission
# ------------------------------------------------------------------ #


def _decide(ctl, rc, depth, max_queue, drain, shed_type):
    try:
        return ("admit", ctl.admit(rc, queue_depth=depth, max_queue=max_queue, drain_s=drain))
    except shed_type as exc:
        return ("shed", exc.reason, round(exc.retry_after_s, 12), exc.tenant, exc.qos_class, str(exc))


def _controllers(now, tenants, fractions=None, burn_shed=2.0):
    made = []
    for mod in (jax_admission, port_admission):
        env = {"GORDO_QOS_TENANTS": tenants, "GORDO_QOS_SHED_FRACTIONS": fractions or "",
               "GORDO_QOS_BURN_SHED": str(burn_shed)}
        made.append(mod.AdmissionController.from_env(env, clock=lambda: now[0]))
    return made


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_decides_as_jax_under_one_clock(seed):
    rng = np.random.default_rng(seed)
    now = [100.0]
    tenants = json.dumps({"acme": {"rate": 4.0, "burst": 3}, "slow": {"rate": 0.5}})
    jctl, pctl = _controllers(now, tenants, "batch=0.6")
    burns = {"interactive": 0.0, "batch": 3.0, "best_effort": 1.0}
    if seed == 2:
        jctl.burn_for = pctl.burn_for = burns.get
    outcomes = []
    for _ in range(200):
        now[0] += float(rng.choice([0.0, 0.05, 0.3, 2.0]))
        tenant = str(rng.choice(["acme", "slow", "default", "rando"]))
        cls = str(rng.choice(CLASSES))
        depth, max_queue = int(rng.integers(0, 40)), int(rng.choice([0, 32]))
        drain = float(rng.choice([0.01, 0.3]))
        want = _decide(jctl, JaxRequestClass(tenant, cls), depth, max_queue, drain, jax_admission.QosShed)
        got = _decide(pctl, PortRequestClass(tenant, cls), depth, max_queue, drain, port_admission.QosShed)
        assert got == want
        outcomes.append(got[:2])
        assert pctl.snapshot() == jctl.snapshot()
    reasons = {o[1] for o in outcomes if o[0] == "shed"}
    assert {"tenant_rate", "queue_pressure"} <= reasons and ("admit", "other") in outcomes
    assert ("goodput_burn" in reasons) == (seed == 2)


def test_admission_rules_as_in_the_jax_suite():
    now = [0.0]
    ctl = port_admission.AdmissionController(
        tenants={"acme": port_admission.TokenBucket(4.0, 2.0, clock=lambda: now[0])}, clock=lambda: now[0])
    rc = PortRequestClass("acme", "batch")
    assert ctl.admit(rc) == "acme"
    ctl.admit(rc)
    with pytest.raises(port_admission.QosShed) as exc:
        ctl.admit(rc)
    assert (exc.value.reason, exc.value.tenant, exc.value.qos_class) == ("tenant_rate", "acme", "batch")
    assert exc.value.retry_after_s == pytest.approx(0.25)
    ctl = port_admission.AdmissionController()
    with pytest.raises(port_admission.QosShed) as exc:
        ctl.admit(PortRequestClass(qos_class="best_effort"), queue_depth=16, max_queue=32, drain_s=0.3)
    assert exc.value.reason == "queue_pressure" and exc.value.retry_after_s == pytest.approx(0.3)
    ctl.admit(PortRequestClass(qos_class="batch"), 16, 32)
    with pytest.raises(port_admission.QosShed):
        ctl.admit(PortRequestClass(qos_class="interactive"), 32, 32)
    burns = {"interactive": 0.0, "batch": 9.0, "best_effort": 1.0}
    ctl.burn_for = burns.get
    with pytest.raises(port_admission.QosShed) as exc:
        ctl.admit(PortRequestClass(qos_class="batch"), 17, 32, drain_s=0.2)
    assert exc.value.reason == "goodput_burn"
    burns["interactive"] = 99.0
    ctl.admit(PortRequestClass(qos_class="interactive"), 17, 32)  # never burn-shed
    ctl.burn_for = lambda cls: None  # no evidence is not a burn
    ctl.admit(PortRequestClass(qos_class="batch"), 17, 32)


@pytest.mark.parametrize("spec", [
    None, "", "{not json", '["a-list"]', '{"t": {"burst": 5}}', '{"t": {"rate": -1}}', '{"t": {"rate": "x"}}',
    '{"acme": {"rate": 5, "burst": 9}, "b": {"rate": 0.5}}', json.dumps({"x" * 80: {"rate": 2}}),
])
def test_parse_tenants_matches_jax(spec):
    got, want = port_admission.parse_tenants(spec), jax_admission.parse_tenants(spec)
    assert {t: (b.rate, b.burst) for t, b in got.items()} == {t: (b.rate, b.burst) for t, b in want.items()}


@pytest.mark.parametrize("spec", [None, "", "batch=0.6", "best-effort=0.2,junk,interactive=abc",
                                  "batch=0,best_effort=1.5", "interactive=0.9,batch=1.0"])
def test_parse_fractions_matches_jax(spec):
    assert port_admission._parse_fractions(spec) == jax_admission._parse_fractions(spec)


def test_admission_renders_its_counters_as_jax():
    from gordo_components_torch.observability.metrics import MetricsRegistry as PortRegistry
    from gordo_components_tpu.observability import MetricsRegistry as JaxRegistry

    now = [0.0]
    jctl, pctl = _controllers(now, json.dumps({"acme": {"rate": 1.0, "burst": 1}}))
    jreg, preg = JaxRegistry(), PortRegistry()
    jctl.install_collector(jreg)
    pctl.install_collector(preg)
    for tenant, cls, depth in (("acme", "batch", 0), ("acme", "batch", 0), ("x", "best_effort", 30), ("default", "interactive", 0)):
        for ctl, rc, err in ((jctl, JaxRequestClass, jax_admission.QosShed), (pctl, PortRequestClass, port_admission.QosShed)):
            try:
                ctl.admit(rc(tenant, cls), depth, 32)
            except err:
                pass
    assert preg.render() == jreg.render()


# ------------------------------------------------------------------ #
# the engine's classes
# ------------------------------------------------------------------ #


class _GatedBank:
    """A bank whose first call waits on ``gate``; records each call's
    names. Uninstrumented."""

    registry = None
    _index, _buckets = {}, {}

    def __init__(self):
        self.gate = threading.Event()
        self.calls = []

    def score_many(self, requests, deadline=None, return_exceptions=False):
        self.gate.wait(30)
        self.calls.append([name for name, _X, _y in requests])
        return [name for name, _X, _y in requests]


def test_the_engine_dequeues_by_class_and_counts_each_class():
    bank = _GatedBank()
    engine = BatchingEngine(bank, max_batch=1, flush_ms=0.0, max_queue=40)
    engine.start()
    try:
        first = engine.submit("first", None, qos_class="batch")
        while not engine._queue.empty():  # the worker holds "first" at the gate
            threading.Event().wait(0.001)
        futures = [engine.submit(f"be-{i}", None, qos_class="best_effort") for i in range(20)]
        futures += [engine.submit(f"int-{i}", None, qos_class="interactive") for i in range(8)]
        futures += [engine.submit(f"late-{i}", None, qos_class="batch",
                                  deadline=Deadline.after_ms(1)) for i in range(2)]
        threading.Event().wait(0.05)
        bank.gate.set()
        assert first.result(30) == "first"
        done = [f.exception(30) is None and f.result() for f in futures]
    finally:
        engine.stop()
    order = [c[0] for c in bank.calls[1:]]
    ref = jax_fair.WeightedFairQueue()
    for name in [f"be-{i}" for i in range(20)] + [f"int-{i}" for i in range(8)]:
        ref.put_nowait(_pending("interactive" if name.startswith("int") else "best_effort", i=name))
    assert order == [ref.get_nowait().i for _ in range(28)]
    assert order[:9].count("int-7") == 1  # every interactive request in the first nine
    assert done.count(False) == 2  # the two expired in the queue
    classes = engine.class_stats_snapshot()
    assert classes == {"interactive": {"requests": 8, "shed": 0, "deadline_expired": 0},
                       "batch": {"requests": 3, "shed": 0, "deadline_expired": 2},
                       "best_effort": {"requests": 20, "shed": 0, "deadline_expired": 0}}
    snap = engine.qos_snapshot()
    assert snap["classes"] == classes and snap["max_queue"] == 40 and snap["feature_widths"] == {}
    assert snap["queue"]["dequeued"] == {"interactive": 8, "batch": 3, "best_effort": 20}


def test_the_engine_sheds_at_its_bound_by_class():
    bank = _GatedBank()
    engine = BatchingEngine(bank, max_batch=1, flush_ms=0.0, max_queue=3)
    engine.start()
    try:
        engine.submit("first", None)
        while not engine._queue.empty():
            threading.Event().wait(0.001)
        for i in range(3):
            engine.submit(f"q-{i}", None, qos_class="batch")
        with pytest.raises(EngineOverloaded):
            engine.submit("over", None, qos_class="best_effort")
        assert engine.class_stats_snapshot()["best_effort"]["shed"] == 1
        assert engine.stats_snapshot()["shed"] == 1
    finally:
        bank.gate.set()
        engine.stop()


# ------------------------------------------------------------------ #
# HTTP: both servers, one request sequence
# ------------------------------------------------------------------ #

P = "/gordo/v0/proj"
TAGS = ["tag-0", "tag-1", "tag-2"]
X_BODY = json.dumps({"X": np.random.RandomState(1).rand(20, 3).astype("float32").tolist()}).encode()
JSON = {"Content-Type": "application/json"}
QOS_ENV = {
    "GORDO_QOS_TENANTS": json.dumps({"acme": {"rate": 0.001, "burst": 2}}),
    "GORDO_HISTORY": "1", "GORDO_HISTORY_INTERVAL_S": "3600",
    "GORDO_SLO_SAMPLE_S": "3600", "GORDO_HEAT_SAMPLE_S": "3600",
}
OFF_ENV = {"GORDO_HEAT": "0", "GORDO_HISTORY": "0"}


def _pressure(on):
    """Hold the engine's queue depth at half its bound (admission reads
    it): ``best_effort``'s shed fraction, below everyone else's."""

    def hook(app, engine):
        if on:
            engine._queue.qsize = lambda: engine.max_queue // 2
        else:
            del engine._queue.qsize

    return hook


def _sample_history(app, engine):
    (app["history"] if hasattr(app, "__getitem__") else app.history).sample()


def _post(path, **headers):
    return ("POST", path, X_BODY, {**JSON, **headers})


STEPS = [
    ("a_default", *_post(f"{P}/machine-a/anomaly/prediction")),
    ("acme_1", *_post(f"{P}/machine-a/anomaly/prediction", **{"X-Gordo-Tenant": "acme"})),
    ("acme_2", *_post(f"{P}/machine-a/prediction", **{"X-Gordo-Tenant": "acme", "X-Gordo-Priority": "batch"})),
    ("acme_429", *_post(f"{P}/machine-a/anomaly/prediction", **{"X-Gordo-Tenant": "acme"})),
    ("pressure_on", _pressure(True)),
    ("be_429", *_post(f"{P}/machine-a/anomaly/prediction", **{"X-Gordo-Priority": "best_effort"})),
    ("int_pressure", *_post(f"{P}/machine-a/anomaly/prediction", **{"X-Gordo-Priority": "interactive",
                                                                      "X-Gordo-Tenant": "rando"})),
    ("pressure_off", _pressure(False)),
    ("b_per_model", *_post(f"{P}/machine-b/prediction", **{"X-Gordo-Tenant": "rando", "X-Gordo-Priority": "bulk"})),
    ("be_ok", *_post(f"{P}/machine-a/anomaly/prediction", **{"X-Gordo-Priority": "best-effort"})),
    ("nan_1", *_post(f"{P}/machine-nan/anomaly/prediction")),
    ("nan_2", *_post(f"{P}/machine-nan/anomaly/prediction")),
    ("nan_3", *_post(f"{P}/machine-nan/anomaly/prediction")),
    ("nan_410", *_post(f"{P}/machine-nan/anomaly/prediction")),
    ("clear", "POST", f"{P}/quarantine/clear", json.dumps({"targets": ["machine-nan"]}).encode(), JSON),
    ("clear_none", "POST", f"{P}/quarantine/clear", json.dumps({"targets": ["machine-nan"]}).encode(), JSON),
    ("reload", "POST", f"{P}/reload", b"", JSON),
    ("a_after", *_post(f"{P}/machine-a/anomaly/prediction")),
    ("sample", _sample_history),
    ("qos", "GET", f"{P}/qos", None, {}),
    ("heat", "GET", f"{P}/heat?refresh=1&top=5", None, {}),
    ("events", "GET", f"{P}/events", None, {}),
    ("events_filtered", "GET", f"{P}/events?type=bank.swap,models.reload&limit=1&since=1", None, {}),
    ("events_bad", "GET", f"{P}/events?limit=x", None, {}),
    ("history", "GET", f"{P}/history", None, {}),
    ("history_series", "GET", f"{P}/history?series=gordo_server_requests_total,gordo_engine_queue_depth", None, {}),
    ("stats", "GET", f"{P}/stats", None, {}),
    ("metrics", "GET", f"{P}/metrics", None, {}),
]
OFF_STEPS = [s for s in STEPS if s[0] in ("a_default", "qos", "heat", "events", "history", "stats")]


async def _jax_answers(root, steps):
    client = TestClient(TestServer(jax_build_app(root)))
    await client.start_server()
    try:
        out = {}
        for key, *step in steps:
            app = client.server.app
            if callable(step[0]):
                step[0](app, app["bank_engine"])
                continue
            method, path, raw, headers = step
            resp = await client.request(method, path, data=raw, headers=headers)
            text = await resp.read()
            body = json.loads(text) if resp.content_type == "application/json" else text.decode()
            out[key] = resp.status, dict(resp.headers), body
        return out, client.server.app
    finally:
        await client.close()


def _call(server, method, path, raw=None, headers=None):
    req = urllib.request.Request(server.url + path, data=raw, headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            status, hdrs, data = resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        status, hdrs, data = exc.code, dict(exc.headers), exc.read()
    if hdrs["Content-Type"] == "application/json":
        return status, hdrs, json.loads(data)
    return status, hdrs, data.decode()


def _port_answers(root, steps):
    server = run_server(root, host="127.0.0.1", port=0, device="cpu", background=True)
    try:
        out = {}
        for key, *step in steps:
            if callable(step[0]):
                step[0](server.app, server.app.engine)
                continue
            out[key] = _call(server, *step)
        return out, server.app
    finally:
        server.close()


def _with_env(env, fn, *args):
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn(*args)
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _still_admission_clock(mp):
    """Build both apps' admission controllers on one clock that stands
    still while the steps run. The tenant's bucket refills at 0.001/s, so
    on the wall clock a second between ``acme_1`` and ``acme_429`` (a slow
    first POST under load) moves ``Retry-After`` off 1000 on one server."""

    def still():
        return 1000.0

    for cls in (port_admission.AdmissionController, jax_admission.AdmissionController):
        from_env = cls.from_env.__func__
        mp.setattr(cls, "from_env", classmethod(
            lambda c, env=os, clock=still, _from_env=from_env: _from_env(c, env, clock=clock)))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    rng = np.random.RandomState(0)
    Xv = rng.rand(200, 3).astype("float32")
    jax_root, port_root = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    frame = pd.DataFrame(Xv, columns=TAGS)
    models = {
        "machine-a": DiffBasedAnomalyDetector(base_estimator=AutoEncoder(epochs=1, batch_size=64)).fit(frame),
        "machine-b": AutoEncoder(epochs=1, batch_size=64).fit(Xv),
        "machine-nan": DiffBasedAnomalyDetector(base_estimator=AutoEncoder(epochs=1, batch_size=64)).fit(frame),
    }
    est = models["machine-nan"].base_estimator
    params = {k: dict(v) for k, v in est.params_["params"].items()}
    params["Dense_0"]["kernel"] = np.full_like(np.asarray(params["Dense_0"]["kernel"]), np.nan)
    est.params_ = {"params": params}
    for name, model in models.items():
        jax_serializer.dump(model, str(jax_root / name), metadata={"name": name})
    assert TOOL.main([str(jax_root), str(port_root)]) == 0
    with pytest.MonkeyPatch.context() as mp:
        _still_admission_clock(mp)
        jax, jax_app = _with_env(QOS_ENV, lambda: asyncio.run(_jax_answers(str(jax_root), STEPS)))
        port, port_app = _with_env(QOS_ENV, _port_answers, str(port_root), STEPS)
        jax_off = _with_env(OFF_ENV, lambda: asyncio.run(_jax_answers(str(jax_root), OFF_STEPS)))[0]
        port_off = _with_env(OFF_ENV, _port_answers, str(port_root), OFF_STEPS)[0]
    return jax, port, jax_off, port_off, jax_app, port_app


def test_http_statuses_and_429s_match_jax(served):
    jax, port = served[:2]
    assert {k: v[0] for k, v in port.items()} == {k: v[0] for k, v in jax.items()}
    assert [k for k, v in port.items() if v[0] == 429] == ["acme_429", "be_429"]
    for key, reason in (("acme_429", "tenant_rate"), ("be_429", "queue_pressure")):
        (_, headers, body), (_, jax_headers, jax_body) = port[key], jax[key]
        assert sorted(body) == sorted(jax_body) == ["class", "error", "reason", "retry_after_s", "tenant"]
        assert headers["Retry-After"] == jax_headers["Retry-After"], key
        assert body["reason"] == jax_body["reason"] == reason
        assert (body["tenant"], body["class"]) == (jax_body["tenant"], jax_body["class"])
    # a refill rate of 0.001/s: about 1,000 s to the next token on both
    assert 999 < port["acme_429"][2]["retry_after_s"] <= 1000 and port["acme_429"][1]["Retry-After"] == "1000"
    assert port["be_429"][2]["error"] == jax["be_429"][2]["error"]
    assert port["int_pressure"][0] == 200  # interactive sheds only at the full queue


def _ints(body):
    """The integer and string leaves of a JSON body, by path."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        elif isinstance(node, (bool, int, str)) or node is None:
            out[path] = node

    walk(body, ())
    return out


def test_qos_view_matches_jax(served):
    jax, port = served[:2]
    got, want = port["qos"][2], jax["qos"][2]
    assert sorted(got) == sorted(want) == ["admission", "enabled", "engine"]
    for body in (got, want):
        for bucket in body["admission"]["tenants"].values():
            bucket.pop("tokens")  # the refill since the last take, a clock reading
    assert got["admission"] == want["admission"]
    assert got["admission"]["admitted"] == {"acme|batch": 1, "acme|interactive": 1, "default|best_effort": 1,
                                            "default|interactive": 5, "other|batch": 1, "other|interactive": 1}
    assert got["admission"]["shed"] == {"acme|interactive|tenant_rate": 1, "default|best_effort|queue_pressure": 1}
    assert got["engine"] == want["engine"]
    assert got["engine"]["queue"]["dequeued"]["best_effort"] == 1


def test_heat_view_matches_jax(served):
    jax, port = served[:2]
    got, want = port["heat"][2], jax["heat"][2]
    assert sorted(got) == sorted(want)
    for key in ("halflife_s", "hot_rate", "warm_rate", "members_tracked", "members_total", "tiers", "per_bucket",
                "top"):
        assert got[key] == want[key], key
    assert [e["member"] for e in got["hottest"]] == [e["member"] for e in want["hottest"]]
    assert [e["bucket"] for e in got["hottest"]] == [e["bucket"] for e in want["hottest"]]
    # machine-a took 6 banked requests of 20 rows, machine-nan 3 (the 410 is not scored)
    assert [e["member"] for e in got["hottest"]] == ["machine-a", "machine-nan"]
    for g, w in zip(got["hottest"], want["hottest"]):
        assert g["rate"] == pytest.approx(w["rate"], rel=1e-2)


def test_events_match_jax(served):
    jax, port = served[:2]
    got, want = port["events"][2], jax["events"][2]
    assert sorted(got) == sorted(want)
    types = [e["type"] for e in got["events"]]
    assert types == [e["type"] for e in want["events"]] == [
        "quarantine.enter", "quarantine.clear", "bank.swap", "models.reload"]
    for g, w in zip(got["events"], want["events"]):
        assert sorted(g) == sorted(w)
        assert (g["seq"], g["severity"], g["generation"], g["replica"], g["trace_id"]) == \
            (w["seq"], w["severity"], w["generation"], w["replica"], w["trace_id"])
        attrs, jax_attrs = dict(g["attrs"]), dict(w["attrs"])
        attrs.pop("pause_ms", None), jax_attrs.pop("pause_ms", None)
        assert attrs == jax_attrs
    assert [e["generation"] for e in got["events"]] == [0, 0, 1, 1]
    for key in ("capacity", "retained", "emitted", "dropped", "last_seq", "by_type"):
        assert got[key] == want[key], key
    assert [e["type"] for e in port["events_filtered"][2]["events"]] == \
        [e["type"] for e in jax["events_filtered"][2]["events"]] == ["models.reload"]
    assert port["events_bad"][0] == jax["events_bad"][0] == 400


def test_history_matches_jax(served):
    jax, port, _, _, jax_app, port_app = served
    got, want = port["history"][2], jax["history"][2]
    assert sorted(got) == sorted(want)
    for key in ("enabled", "interval_s", "max_bytes", "max_series", "samples", "dropped_series", "tiers"):
        assert got[key] == want[key], key
    assert got["samples"] == 2  # the baseline and the one taken in the sequence
    # the port's series are the JAX server's but for the families it does not render yet
    assert set(got["names"]) <= set(want["names"])
    series = port["history_series"][2]["series"]
    assert sorted(series) == sorted(jax["history_series"][2]["series"])
    # a counter rates from its second sample on (its values are per
    # second of each server's own clock); the depth gauge is raw
    shape = {k: [p[1] is None for p in v["points"]] for k, v in series.items()}
    assert shape == {k: [p[1] is None for p in v["points"]] for k, v in jax["history_series"][2]["series"].items()}
    # the baseline sample precedes the engine, as on the JAX server
    assert [p[1] for p in series["gordo_engine_queue_depth"]["points"]] == [None, 0.0]
    assert port_app.history.memory_bytes() <= port_app.history.max_bytes


def test_stats_and_metrics_carry_the_classes_and_heat(served):
    from gordo_components_torch.observability.metrics import parse_prometheus_text

    jax, port = served[:2]
    got, want = port["stats"][2], jax["stats"][2]
    assert got["bank_engine"]["by_class"] == want["bank_engine"]["by_class"]
    assert sorted(got["heat"]) == sorted(want["heat"])
    _, samples = parse_prometheus_text(port["metrics"][2])
    _, jax_samples = parse_prometheus_text(jax["metrics"][2])
    prefixes = ("gordo_qos_", "gordo_engine_class_", "gordo_events_total", "gordo_history_samples_total",
                "gordo_history_dropped_series_total")
    pick = lambda rows: sorted((n, sorted(lb.items()), v) for n, lb, v in rows if n.startswith(prefixes))  # noqa: E731
    assert pick(samples) == pick(jax_samples) and len(pick(samples)) > 20
    values = {(n, tuple(sorted(lb.items()))): v for n, lb, v in samples}
    qos = port["qos"][2]
    for key, n in qos["admission"]["admitted"].items():
        tenant, cls = key.split("|")
        assert values[("gordo_qos_admitted_total", (("class", cls), ("tenant", tenant)))] == n
    for cls, cell in qos["engine"]["classes"].items():
        assert values[("gordo_engine_class_requests_total", (("class", cls),))] == cell["requests"]


def test_disabled_answers_match_jax(served):
    jax_off, port_off = served[2:4]
    for key in ("heat", "history"):
        assert port_off[key][2] == jax_off[key][2] == {"enabled": False}, key
    assert port_off["qos"][2]["enabled"] is jax_off["qos"][2]["enabled"] is True
    assert port_off["events"][2]["events"] == jax_off["events"][2]["events"] == []
    assert "heat" not in port_off["stats"][2] and "heat" not in jax_off["stats"][2]
