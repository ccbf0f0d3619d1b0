"""The port's metric history, event log and clock seam against the JAX
package's, on the CPU: the first fourteen tests of
``tests/test_history.py`` (tier specs, counters as rates, resets, the
downsampled tier, the memory bound, queries, the default-off gate, the
event ring's drops and filters, ``emit`` never raising, thread safety and
the process default), each run on both packages with the same inputs and
held to the same answers, plus the clock seam's steps and the app's
sampler thread.
"""

import threading
import time

import numpy as np
import pytest

from gordo_components_torch.observability import events as port_events
from gordo_components_torch.observability import timeseries as port_ts
from gordo_components_torch.observability.metrics import MetricsRegistry as PortRegistry
from gordo_components_torch.replay import clock as port_clock
from gordo_components_tpu.observability import MetricsRegistry as JaxRegistry
from gordo_components_tpu.observability import events as jax_events
from gordo_components_tpu.observability import timeseries as jax_ts
from gordo_components_tpu.replay import clock as jax_clock

SIDES = [
    pytest.param((JaxRegistry, jax_ts, jax_clock), id="jax"),
    pytest.param((PortRegistry, port_ts, port_clock), id="port"),
]
BOTH = ((JaxRegistry, jax_ts, jax_clock), (PortRegistry, port_ts, port_clock))


def _store(ts, registry, clock, interval=1.0, tiers=((1.0, 60.0),), max_mb=4.0):
    return ts.HistoryStore(registry, interval_s=interval, tiers=list(tiers), max_mb=max_mb, clock=clock)


def _on_both(run):
    """``run(Registry, timeseries, clock module)`` on each package: the
    port's answer, which must equal the JAX one's."""
    jax, port = (run(*side) for side in BOTH)
    assert port == jax
    return port


def test_parse_tiers_sorts_finest_first():
    assert port_ts.parse_tiers("1m@6h,10s@15m") == jax_ts.parse_tiers("1m@6h,10s@15m") == \
        [(10.0, 900.0), (60.0, 21600.0)]


@pytest.mark.parametrize("spec", ["", "10s", "10s@5s", "x@15m", "10s@15m,1m@10m"])
def test_parse_tiers_rejects_bad_specs(spec):
    for ts in (jax_ts, port_ts):
        with pytest.raises(ValueError):
            ts.parse_tiers(spec)


def test_counter_becomes_rate_and_gauge_stays_raw():
    def run(Registry, ts, clock_mod):
        reg, clock = Registry(), clock_mod.ReplayClock(1000.0)
        ctr, g = reg.counter("reqs_total", ""), reg.gauge("depth", "")
        h = reg.histogram("lat_seconds", "").labels()
        store = _store(ts, reg, clock)
        g.labels().set(7.0)
        ctr.labels().inc(0)
        store.sample()
        ctr.labels().inc(10)
        h.record(0.5)
        clock.advance(2.0)
        g.labels().set(9.0)
        store.sample()
        return store.query(["reqs_total:rate", "depth", "lat_seconds_count:rate", "lat_seconds_sum:rate"]), \
            store.snapshot()

    q, _ = _on_both(run)
    assert [p for p in q["reqs_total:rate"]["points"] if p[1] is not None] == [[1002.0, 5.0]]
    assert [p[1] for p in q["depth"]["points"]] == [7.0, 9.0]
    assert q["lat_seconds_sum:rate"]["points"][-1] == [1002.0, 0.25]


def test_counter_reset_never_yields_negative_rate():
    def run(Registry, ts, clock_mod):
        reg, clock = Registry(), clock_mod.ReplayClock(0.0)
        values = {"v": 0.0}
        reg.collector(lambda: [("c_total", "counter", "", {}, values["v"])], key="c")
        store = _store(ts, reg, clock)
        for v in (100.0, 200.0, 3.0, 50.0):  # 200 -> 3 is the reset
            values["v"] = v
            store.sample()
            clock.advance(1.0)
        return [p[1] for p in store.query(["c_total:rate"])["c_total:rate"]["points"] if p[1] is not None]

    assert _on_both(run) == [100.0, 3.0, 47.0]


def test_downsampled_tier_averages():
    def run(Registry, ts, clock_mod):
        reg, clock = Registry(), clock_mod.ReplayClock(0.0)
        g = reg.gauge("sig", "")
        store = _store(ts, reg, clock, tiers=[(1.0, 30.0), (4.0, 120.0)])
        raw = []
        for i in range(16):
            v = float(10 + (i % 5))
            g.labels().set(v)
            raw.append(v)
            store.sample()
            clock.advance(1.0)
        return [v for _, v in store.tiers[1].points("sig") if v == v], raw

    slots, raw = _on_both(run)
    assert slots == pytest.approx([float(np.mean(raw[i:i + 4])) for i in range(0, 16, 4)], rel=1e-9)


def test_memory_bound_is_never_exceeded():
    def run(Registry, ts, clock_mod):
        reg, clock = Registry(), clock_mod.ReplayClock(0.0)
        fam = reg.gauge("wide", "", labelnames=("i",))
        store = _store(ts, reg, clock, max_mb=0.05, tiers=[(1.0, 600.0)])
        assert store.max_series > 0
        for i in range(store.max_series + 50):
            fam.labels(str(i)).set(1.0)
        for _ in range(3):
            store.sample()
            clock.advance(1.0)
            assert store.memory_bytes() <= store.max_bytes
        return store.snapshot(), store.max_series, store.memory_bytes()

    snap, max_series, _ = _on_both(run)
    assert snap["n_series"] == max_series and snap["dropped_series"] > 0


def test_query_expands_base_metric_names():
    def run(Registry, ts, clock_mod):
        reg, clock = Registry(), clock_mod.ReplayClock(0.0)
        fam = reg.gauge("burn", "", labelnames=("w",))
        fam.labels("5m").set(1.0)
        fam.labels("1h").set(2.0)
        store = _store(ts, reg, clock)
        store.sample()
        return store.query(["burn"]), store.query(["ghost"]), store.query(['burn{w="5m"}'])

    expanded, ghost, exact = _on_both(run)
    assert set(expanded) == {'burn{w="1h"}', 'burn{w="5m"}'} and ghost["ghost"]["points"] == []
    assert exact['burn{w="5m"}']["points"] == [[0.0, 1.0]]


def test_query_picks_the_tier_covering_since():
    def run(Registry, ts, clock_mod):
        reg, clock = Registry(), clock_mod.ReplayClock(0.0)
        reg.gauge("sig", "").labels().set(1.0)
        store = _store(ts, reg, clock, tiers=[(1.0, 10.0), (5.0, 100.0)])
        for _ in range(40):
            store.sample()
            clock.advance(1.0)
        now = clock.time()
        return [store.query(["sig"], since=now - 5)["sig"]["tier"], store.query(["sig"], since=now - 35)["sig"]["tier"],
                store.query(["sig"], step=5.0), store.query(["sig"], since=now - 20, until=now - 10, step=2.0)]

    tiers = _on_both(run)
    assert tiers[:2] == [0, 1] and tiers[2]["sig"]["tier"] == 1


def test_history_from_env_default_off(monkeypatch):
    monkeypatch.delenv("GORDO_HISTORY", raising=False)
    assert port_ts.history_from_env(PortRegistry()) is None
    monkeypatch.setenv("GORDO_HISTORY", "1")
    monkeypatch.setenv("GORDO_HISTORY_INTERVAL_S", "5")
    monkeypatch.setenv("GORDO_HISTORY_TIERS", "5s@1m,1m@1h")
    monkeypatch.setenv("GORDO_HISTORY_MAX_MB", "0.5")
    store, jax_store = port_ts.history_from_env(PortRegistry()), jax_ts.history_from_env(JaxRegistry())
    assert store is not None and store.interval_s == 5.0
    assert store.snapshot() == jax_store.snapshot()
    assert [f for f in store.registry.render().splitlines() if "history" in f] == \
        [f for f in jax_store.registry.render().splitlines() if "history" in f]


def _logs(**kwargs):
    return [mod.EventLog(**kwargs, clock=clock.ReplayClock(100.0)) for mod, clock in
            ((jax_events, jax_clock), (port_events, port_clock))]


def test_event_log_ring_drops_oldest_and_counts():
    out = []
    for log in _logs(capacity=4, replica="r0"):
        for i in range(10):
            log.emit("tick", i=i)
        out.append((log.snapshot(), log.events()))
    assert out[1] == out[0]
    snap, evs = out[1]
    assert (snap["retained"], snap["emitted"], snap["dropped"], snap["by_type"]) == (4, 10, 6, {"tick": 10})
    assert [e["attrs"]["i"] for e in evs] == [6, 7, 8, 9] and all(e["replica"] == "r0" for e in evs)


def test_event_log_filters_and_limit():
    out = []
    for log in _logs(capacity=64):
        log.emit("a")
        log.clock.advance(10.0)
        log.emit("b", severity="error")
        log.emit("a")
        ev = log.emit("c", severity="shrug")
        out.append([[e["type"] for e in log.events(types=["a"])], [e["type"] for e in log.events(since_wall=105.0)],
                    [e["type"] for e in log.events(limit=1)], [e["type"] for e in log.events(since_seq=2)],
                    [e["type"] for e in log.events(limit=0)], ev.severity, log.events()])
    assert out[1] == out[0]
    assert out[1][:6] == [["a", "a"], ["b", "a", "c"], ["c"], ["a", "c"], ["a", "b", "a", "c"], "info"]


def test_event_log_emit_never_raises():
    class Boom:
        def time(self):
            raise RuntimeError("clock down")

        def monotonic(self):
            raise RuntimeError("clock down")

    assert port_events.EventLog(capacity=4, clock=Boom()).emit("x") is None
    assert port_events.EventLog(capacity=4).emit("ok", payload=object()) is not None
    with pytest.raises(ValueError):
        port_events.EventLog(capacity=0)


def test_event_log_thread_safety_under_concurrent_emit():
    log = port_events.EventLog(capacity=10_000)
    n, threads = 500, 4

    def hammer(tid):
        for i in range(n):
            log.emit("t", tid=tid, i=i)

    ts = [threading.Thread(target=hammer, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert log.snapshot()["emitted"] == n * threads
    seqs = [e["seq"] for e in log.events()]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)


def test_process_default_event_log_swappable(monkeypatch):
    mine = port_events.EventLog(capacity=8)
    prev = port_events.set_event_log(mine)
    try:
        port_events.get_event_log().emit("hello")
        assert mine.snapshot()["by_type"] == {"hello": 1}
    finally:
        port_events.set_event_log(prev)
    monkeypatch.setenv("GORDO_EVENTS_CAPACITY", "7")
    prev = port_events.set_event_log(None)
    try:
        assert port_events.get_event_log().capacity == 7
    finally:
        port_events.set_event_log(prev)


def test_events_render_and_stamp_the_trace_as_jax():
    from gordo_components_torch.observability.tracing import Tracer, use_trace

    regs = (JaxRegistry(), PortRegistry())
    logs = _logs(capacity=16)
    for log, reg in zip(logs, regs):
        log.attach_registry(reg)
        log.emit("bank.swap", generation=1, models=3)
        log.emit("quarantine.enter", severity="error", generation=1, target="m")
        log.emit("bank.swap", generation=2)
    assert regs[1].render() == regs[0].render()
    tracer = Tracer(sample=1.0)
    trace = tracer.start_trace("reload")
    with use_trace(trace):
        ev = logs[1].emit("models.reload")
    assert ev.trace_id == trace.trace_id and logs[1].emit("x").trace_id is None


def test_replay_clock_steps_as_jax():
    out = []
    for mod in (jax_clock, port_clock):
        clock = mod.ReplayClock(500.0, speed=50.0)
        steps = [clock.time(), clock.monotonic(), clock.advance(2.5), clock.advance_to(400.0),
                 clock.advance_to(510.0), clock.time(), clock.monotonic(), clock.timescale]
        with pytest.raises(ValueError):
            clock.advance(-1)
        with pytest.raises(ValueError):
            mod.ReplayClock(0.0, speed=0)
        out.append(steps)
    assert out[1] == out[0] == [500.0, 1000.0, 502.5, 502.5, 510.0, 510.0, 1010.0, 50.0]
    assert port_clock.SYSTEM_CLOCK.timescale == 1.0
    assert abs(port_clock.SYSTEM_CLOCK.time() - time.time()) < 1.0


def test_the_app_samples_history_on_its_thread_and_stops_it(tmp_path, monkeypatch):
    from gordo_components_torch import serializer
    from gordo_components_torch.convert import entry_from_numpy
    from gordo_components_torch.server import build_app

    rng = np.random.default_rng(0)
    params = {"params": {"Dense_0": {"kernel": rng.standard_normal((3, 3)).astype(np.float32),
                                     "bias": np.zeros(3, np.float32)}}}
    serializer.dump(entry_from_numpy("m", "AutoEncoder", "feedforward_model", {"encoding_dim": [], "decoding_dim": []},
                                     3, params, in_shift=np.zeros(3), in_scale=np.ones(3), err_shift=np.zeros(3),
                                     err_scale=np.ones(3)), str(tmp_path / "m"))
    monkeypatch.setenv("GORDO_HISTORY", "1")
    monkeypatch.setenv("GORDO_HISTORY_INTERVAL_S", "0.02")
    clock = port_clock.ReplayClock(1000.0, speed=2.0)
    app = build_app(str(tmp_path), device="cpu", clock=clock)
    try:
        assert app.history.clock is clock and app.events.clock is clock and app.slo._clock == clock.monotonic
        deadline = time.monotonic() + 10
        while app.history.samples_taken < 5 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert app.history.samples_taken >= 5
    finally:
        app.close()
    taken = app.history.samples_taken
    time.sleep(0.1)
    assert app.history.samples_taken == taken and app._history_thread is None
