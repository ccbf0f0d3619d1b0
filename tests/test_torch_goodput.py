"""The port's goodput ledger and SLO tracker against the JAX package's, on
the CPU.

The same calls go into a JAX ledger and a port ledger, each rendering
through its package's registry, under one fake clock: equal
``snapshot()``s and byte-equal Prometheus text. ``attribute_trace`` of one
summary, the burn rates of an ``SLOTracker`` over those ledgers under a
fake clock (objectives, per-(tenant, class) windows, caching between
samples, the registry's gauges), ``parse_objectives`` and
``parse_windows`` with their errors, ``merge_slo_snapshots``, and the
ledger's request classification equal the JAX package's. A bank with a
ledger books each group's device window and gives each result its share.
"""

import numpy as np
import pytest

from gordo_components_torch.observability import goodput as port_goodput
from gordo_components_torch.observability import slo as port_slo
from gordo_components_torch.observability.metrics import MetricsRegistry as PortRegistry
from gordo_components_torch.qos.classify import RequestClass, classify_headers
from gordo_components_tpu.observability import goodput as jax_goodput
from gordo_components_tpu.observability import slo as jax_slo
from gordo_components_tpu.observability.metrics import MetricsRegistry as JaxRegistry
from gordo_components_tpu.qos import classify as jax_classify

SIDES = {"jax": (jax_goodput, jax_slo, JaxRegistry), "port": (port_goodput, port_slo, PortRegistry)}


class _Clock:
    def __init__(self, now=1000.0):
        self.now = now

    def monotonic(self):
        return self.now


@pytest.fixture
def clocked(monkeypatch):
    """Both ledger modules on one fake clock."""
    clock = _Clock()
    for goodput, _slo, _reg in SIDES.values():
        monkeypatch.setattr(goodput, "time", clock)
    return clock


# (method, args, kwargs): the calls both ledgers get
CALLS = [
    ("record_queue_wait", (0.0021,), {}),
    ("account_group", ("AutoEncoder:ff:f3:l1", 0.040, 0.030, 0.010, True),
     dict(coalesce_s=0.001, pad_s=0.002, postprocess_s=0.003, shard_rows=[("0", 300, 100)])),
    ("account_group", ("LSTMAutoEncoder:lstm:f3:l8", 0.020, 0.015, 0.005, False), dict(shard_rows=[("0", 48, 16)])),
    ("finish_request", (200, 0.010, 0.004), {}),
    ("finish_request", (200, 0.020, 0.006), dict(scores_finite=False)),
    ("finish_request", (504, 0.030, 0.0), dict(tenant="acme", qos_class="batch")),
    ("finish_request", (500, 0.040, 0.002), dict(tenant="other", qos_class="best_effort")),
    ("finish_request", (429, 0.001, 0.0), {}),
    ("finish_request", (200, 0.2, 0.1), dict(tenant="acme", qos_class="batch")),
    ("record_queue_wait", (0.0005,), {}),
]


def _ledgers(clock, calls=CALLS):
    out = {}
    for side, (goodput, _slo, Registry) in SIDES.items():
        registry = Registry()
        led = goodput.GoodputLedger(registry=registry)
        for name, args, kwargs in calls:
            getattr(led, name)(*args, **kwargs)
        out[side] = led, registry
    clock.now += 12.5
    return out


def test_ledger_snapshot_and_series_match_jax(clocked):
    ledgers = _ledgers(clocked)
    (jled, jreg), (pled, preg) = ledgers["jax"], ledgers["port"]
    assert pled.snapshot() == jled.snapshot()
    assert preg.render() == jreg.render()
    snap = pled.snapshot()
    assert snap["requests"] == {"goodput": 2, "wasted": 3, "expired": 1}
    assert snap["tenants"]["acme|batch"] == {"goodput": 1, "wasted": 0, "expired": 1}
    assert snap["per_bucket"]["LSTMAutoEncoder:lstm:f3:l8"]["failed_s"] == 0.015
    assert snap["per_shard"]["0"] == {"routed_rows": 348, "padded_rows": 116, "padded_ratio": 0.25}
    assert (pled.goodput_ratio(), pled.errors_5xx) == (jled.goodput_ratio(), jled.errors_5xx)


def test_an_empty_ledger_renders_as_jax(clocked):
    ledgers = _ledgers(clocked, calls=[])
    assert ledgers["port"][1].render() == ledgers["jax"][1].render()
    assert ledgers["port"][0].snapshot() == ledgers["jax"][0].snapshot()


def test_tenant_cells_are_bounded_as_jax(clocked):
    calls = [("finish_request", (200, 0.01, 0.0), dict(tenant=f"t{i}", qos_class="batch")) for i in range(300)]
    ledgers = _ledgers(clocked, calls)
    cells = {side: led.tenant_cells for side, (led, _r) in ledgers.items()}
    assert cells["port"] == cells["jax"] and len(cells["port"]) == 257
    assert cells["port"][("other", "batch")] == [44, 0, 0]


def test_from_env(monkeypatch):
    monkeypatch.setenv("GORDO_SLO", "0")
    assert port_goodput.GoodputLedger.from_env() is None
    monkeypatch.setenv("GORDO_SLO", "1")
    assert isinstance(port_goodput.GoodputLedger.from_env(), port_goodput.GoodputLedger)


def _span(name, start_ms, dur_ms, children=()):
    return {"name": name, "start_ms": start_ms, "duration_ms": dur_ms, "children": list(children)}


@pytest.mark.parametrize("trace", [
    {"duration_ms": 10.0, "spans": _span("anomaly", 0.0, 10.0, [
        _span("parse", 0.0, 0.5), _span("queue_wait", 0.5, 2.0), _span("coalesce", 2.5, 0.2),
        _span("pad", 2.7, 0.3), _span("device_execute", 3.0, 4.0, [_span("postprocess", 6.5, 1.0)]),
        _span("postprocess", 7.0, 2.0), _span("postprocess", 8.0, 1.5)])},
    {"duration_ms": 5.0, "spans": _span("anomaly", 0.0, 5.0, [
        _span("device_execute", -1.0, 9.0), _span("queue_wait", 4.0, 3.0)])},
    {"spans": _span("prediction", 0.0, 2.0, [_span("device_execute", 0.5, 0.0)])},
    {"duration_ms": 0.0, "spans": {}},
])
def test_attribute_trace_matches_jax(trace):
    assert port_goodput.attribute_trace(trace) == jax_goodput.attribute_trace(trace)


def test_attribute_trace_of_a_port_trace():
    import time

    from gordo_components_torch.observability.tracing import Tracer

    trace = Tracer(sample=1.0).start_trace("anomaly")
    t0 = trace.root.start
    trace.add_span("queue_wait", t0, t0 + 0.001)
    trace.add_span("device_execute", t0 + 0.001, t0 + 0.003)
    time.sleep(0.005)  # the root outlasts its spans
    trace.finish()
    got = port_goodput.attribute_trace(trace)
    assert got == jax_goodput.attribute_trace(trace.summary())
    assert got["stages_ms"]["device_execute"] == pytest.approx(2.0, abs=2e-3)


# --------------------------------------------------------------------- #
# SLOs
# --------------------------------------------------------------------- #


def _trackers(clock, **kwargs):
    out = {}
    for side, (goodput, slo, Registry) in SIDES.items():
        registry = Registry()
        led = goodput.GoodputLedger()
        out[side] = led, slo.SLOTracker(led, registry=registry, clock=clock.monotonic, **kwargs), registry
    return out


def _drive(trackers, clock, calls):
    for led, _tracker, _reg in trackers.values():
        for status, elapsed, tenant, cls in calls:
            led.finish_request(status, elapsed, 0.0, tenant=tenant, qos_class=cls)


def test_burn_rates_match_jax_under_a_fake_clock(clocked):
    trackers = _trackers(clocked, objectives=[
        {"name": "availability", "target": 0.99}, {"name": "p99_latency_ms", "target": 50.0},
        {"name": "goodput_ratio", "target": 0.9}], windows=[("10s", 10.0), ("1m", 60.0)], sample_interval_s=1.0)
    _drive(trackers, clocked, [(200, 0.005, "default", "interactive")] * 90)
    for _led, tracker, _reg in trackers.values():
        tracker.sample(force=True)
    clocked.now += 5.0
    _drive(trackers, clocked, [(500, 0.005, "acme", "batch")] * 5 + [(200, 0.2, "default", "interactive")] * 5
           + [(504, 0.3, "acme", "batch")] * 2)
    snaps = {}
    for side, (_led, tracker, registry) in trackers.items():
        tracker.sample(force=True)
        snaps[side] = tracker.snapshot(), registry.render()
    assert snaps["port"][0] == snaps["jax"][0]
    assert snaps["port"][1] == snaps["jax"][1]
    avail = snaps["port"][0]["objectives"][0]["windows"]["10s"]
    assert (avail["good"], avail["total"], avail["burn_rate"]) == (5.0, 12.0, 58.3333)
    assert snaps["port"][0]["classes"]["acme|batch"]["fast_burn"] is True
    # the errors age out of the fast window; the cache holds between samples
    clocked.now += 100.0
    _drive(trackers, clocked, [(200, 0.005, "default", "interactive")] * 20)
    for side, (_led, tracker, _reg) in trackers.items():
        tracker.sample(force=True)
        first = tracker.snapshot()
        assert tracker.snapshot() is first
        snaps[side] = first
    assert snaps["port"] == snaps["jax"]
    assert snaps["port"]["objectives"][0]["windows"]["10s"]["burn_rate"] == 0.0
    assert trackers["port"][1].class_burn("batch") == trackers["jax"][1].class_burn("batch")


def test_one_sample_renders_as_jax(clocked):
    trackers = _trackers(clocked)
    for _led, tracker, _reg in trackers.values():
        tracker.sample(force=True)
    assert trackers["port"][2].render() == trackers["jax"][2].render()
    assert "gordo_slo_objective_ratio" not in trackers["port"][2].render()


def test_the_sampler_thread_samples_and_stops():
    import time

    led = port_goodput.GoodputLedger()
    tracker = port_slo.SLOTracker(led, sample_interval_s=0.01)
    tracker.start()
    try:
        led.finish_request(200, 0.01)
        deadline = time.monotonic() + 10
        while tracker.snapshot()["n_samples"] < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        tracker.stop()
    assert tracker.snapshot()["n_samples"] >= 3 and tracker._thread is None


@pytest.mark.parametrize("raw", [
    "", '[{"name": "availability", "target": 0.995}]', '[{"name": "p95_latency_ms", "target": 20}]',
    '[{"name": "p99_latency_ms", "target": 20, "quantile": 0.999}]', "not json", '{"name": "availability"}',
    '[{"name": "availability"}]', '[{"name": "availability", "target": 1.5}]',
    '[{"name": "p99_latency_ms", "target": -1}]', '[{"name": "throughput", "target": 0.5}]',
    '[{"name": "availability", "target": 0.9}, {"name": "availability", "target": 0.99}]',
])
def test_parse_objectives_as_jax(raw):
    def parse(mod):
        try:
            return [o.describe() for o in mod.parse_objectives(raw)]
        except ValueError as exc:
            return f"ValueError: {exc}"

    assert parse(port_slo) == parse(jax_slo)


@pytest.mark.parametrize("raw", ["", "5m,1h,6h", "30s,2m", "1h,5m", "1.5m", "5 minutes", ",", "5m,,10s"])
def test_parse_windows_as_jax(raw):
    def parse(mod):
        try:
            return mod.parse_windows(raw)
        except ValueError as exc:
            return f"ValueError: {exc}"

    assert parse(port_slo) == parse(jax_slo)


def _body(err, total, burn, classes=None):
    out = {"enabled": True, "objectives": [{"name": "availability", "target": 0.99, "budget": 0.01, "windows": {
        "5m": {"good": total - err, "total": total, "ratio": (total - err) / total, "burn_rate": burn}}}]}
    if classes:
        out["classes"] = classes
    return out


@pytest.mark.parametrize("bodies", [
    [_body(0, 100, 0.0), _body(10, 100, 10.0), None, {"enabled": False}],
    [None, None],
    [_body(1, 10, 10.0, {"acme|batch": {"budget": 0.001, "windows": {"5m": {"good": 9, "total": 10}}}}),
     _body(0, 0.0 + 1, 0.0, {"acme|batch": {"budget": 0.001, "windows": {"5m": {"good": 0, "total": 0}}}})],
    [{"enabled": True, "objectives": "bad"}, {"enabled": True, "objectives": [{"windows": {}}]}],
])
def test_merge_slo_snapshots_matches_jax(bodies):
    assert port_slo.merge_slo_snapshots(bodies) == jax_slo.merge_slo_snapshots(bodies)


@pytest.mark.parametrize("headers", [
    {}, {"X-Gordo-Tenant": "acme"}, {"X-Gordo-Priority": "Bulk"}, {"X-Gordo-Priority": "best-effort"},
    {"X-Gordo-Tenant": " a|b ", "X-Gordo-Priority": "nonsense"}, {"X-Gordo-Tenant": "x" * 100},
    {"X-Gordo-Tenant": "   ", "X-Gordo-Priority": "online"},
])
def test_request_class_matches_jax(headers):
    got, want = classify_headers(headers), jax_classify.classify_headers(headers)
    assert (got.tenant, got.qos_class) == (want.tenant, want.qos_class)
    for known in (None, set(), {"acme"}, {got.tenant}):
        assert got.label_tenant(known) == want.label_tenant(known)
    assert RequestClass() == classify_headers({})


def test_a_bank_books_its_groups_and_each_result_its_share():
    import dataclasses

    from gordo_components_torch.convert import entry_from_numpy
    from gordo_components_torch.server import ModelBank

    rng = np.random.RandomState(0)
    F = 3
    params = {"params": {f"Dense_{i}": {"kernel": rng.rand(a, b).astype("f4"), "bias": rng.rand(b).astype("f4")}
                         for i, (a, b) in enumerate([(F, 2), (2, F)])}}
    entry = entry_from_numpy("m", "AutoEncoder", "feedforward_model", {"encoding_dim": (2,), "decoding_dim": ()},
                             F, params, np.zeros(F), np.ones(F), np.zeros(F), np.ones(F))
    led = port_goodput.GoodputLedger()
    bank = ModelBank.from_entries([entry, dataclasses.replace(entry, name="n")], device="cpu", ledger=led)
    X = rng.rand(24, F).astype("f4")
    results = bank.score_many([("m", X, None), ("n", X[:8], None)])
    snap = led.snapshot()
    (cell,) = snap["per_bucket"].values()
    assert (cell["routed_rows"], cell["padded_rows"]) == (32, 2 * 32 - 32)
    assert cell["padded_s"] == pytest.approx(cell["useful_s"], rel=1e-3)  # half the rows are pad
    assert results[0].device_s == pytest.approx(3 * results[1].device_s)
    assert results[0].device_s + results[1].device_s == pytest.approx(cell["useful_s"], abs=2e-6)
    assert snap["stages_s"]["coalesce"] > 0 and snap["per_shard"]["0"]["padded_ratio"] == 0.5
