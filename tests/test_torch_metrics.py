"""The port's metrics registry, latency histogram, deadlines and quarantine
breaker against the JAX package's, on the CPU; no server.

- Seeded values go into JAX's ``Histogram``/``LatencyHistogram`` and the
  port's: ``snapshot()``, ``summary()``, ``buckets()``, ``percentile(q)``,
  ``count_le`` and ``bucket_le`` are equal.
- One sequence of counter, gauge, histogram, label, ``set_function``,
  collector and series-cap calls, with labels that need escaping and NaN
  and +-inf values, goes into both registries: ``render()`` is byte-equal,
  ``snapshot()`` equal, and ``parse_prometheus_text`` of the text equal
  across the two packages, as is ``render_samples`` of the parsed samples.
- ``parse_deadline_ms`` and ``default_deadline_ms`` (raising cases too)
  answer alike; ``QuarantineSet`` snapshots after the same
  ``record_failure``/``record_success``/``clear``/``drop`` sequence are
  equal (``time.time`` patched for ``since``).
- Threads: the port records from many threads (the JAX server from one
  event loop), and 32 threads recording 10,000 values each into one port
  histogram and one counter lose no count.
"""

import sys
import threading
import time

import numpy as np
import pytest

from gordo_components_torch.observability import metrics as port
from gordo_components_torch.resilience import deadline as port_deadline
from gordo_components_torch.resilience import quarantine as port_quarantine
from gordo_components_torch.server.stats import LatencyHistogram as PortLatency
from gordo_components_tpu.observability import metrics as ref
from gordo_components_tpu.resilience import deadline as ref_deadline
from gordo_components_tpu.resilience import quarantine as ref_quarantine
from gordo_components_tpu.server.stats import LatencyHistogram as RefLatency

QS = [0.0, 0.5, 0.9, 0.99, 1.0]
HISTOGRAMS = {
    "default": lambda m: m.Histogram(),
    "latency": lambda m: (PortLatency if m is port else RefLatency)(),
    "batch_size": lambda m: m.Histogram(lo=1.0, hi=1e5),
    "coarse": lambda m: m.Histogram(lo=1e-3, hi=10.0, bins_per_decade=3),
}


def _values(seed: int) -> np.ndarray:
    """Log-uniform values over 1e-6..1e3 (below lo, in range and in the
    overflow bin), some zeros and negatives, and the bin edges themselves."""
    rng = np.random.default_rng(seed)
    v = 10 ** rng.uniform(-6, 3, 2000)
    edges = [5e-5, 1.0, 10.0, 100.0, 1e5, 0.0, -1.0]
    return np.concatenate([v, edges, rng.integers(1, 200, 300).astype(float)])


@pytest.mark.parametrize("kind", sorted(HISTOGRAMS))
@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_matches_jax(kind, seed):
    got, want = HISTOGRAMS[kind](port), HISTOGRAMS[kind](ref)
    values = _values(seed)
    for v in values:
        got.record(float(v))
        want.record(float(v))
    assert got.snapshot() == want.snapshot()
    assert got.summary() == want.summary()
    assert got.buckets() == want.buckets()
    assert [got.percentile(q) for q in QS] == [want.percentile(q) for q in QS]
    probes = list(values[::37]) + [0.0, 5e-5, 1e-9, 1e9]
    assert [got.count_le(v) for v in probes] == [want.count_le(v) for v in probes]
    assert [got.bucket_le(v) for v in probes] == [want.bucket_le(v) for v in probes]


def test_empty_histogram_matches_jax():
    got, want = port.Histogram(), ref.Histogram()
    assert (got.snapshot(), got.summary(), got.percentile(0.5), got.buckets()) == (
        want.snapshot(), want.summary(), want.percentile(0.5), want.buckets())
    with pytest.raises(ValueError):
        port.Histogram(lo=1.0, hi=1.0)


def _drive(m):
    """One sequence of registry calls on module ``m``'s registry."""
    reg = m.MetricsRegistry(max_series_per_metric=3)
    c = reg.counter("gordo_test_requests_total", 'Requests "quoted"\nand \\ escaped', ("kind", "path"))
    c.labels("anomaly", 'a"b').inc()
    c.labels(kind="prediction", path="c\\d\ne").inc(2.5)
    c.labels("anomaly", 'a"b').inc(3)
    for i in range(5):  # two past the cap: dropped
        reg.counter("gordo_test_capped_total", "", ("i",)).labels(i).inc(i)
    g = reg.gauge("gordo_test_gauge", "A gauge", ("state",))
    g.labels("nan").set(float("nan"))
    g.labels("pinf").set(float("inf"))
    g.labels("ninf").set(float("-inf"))
    g.labels("big").set(1e17)
    g.labels("frac").set(0.1234567891234)
    g.labels("int").set(7.0)
    reg.gauge("gordo_test_fn", "read through").labels().set_function(lambda: 42)
    reg.gauge("gordo_test_dead_fn", "a dead closure").labels().set_function(lambda: 1 / 0)
    reg.gauge("gordo_test_unlabeled").set(-3)
    h = reg.histogram("gordo_test_seconds", "Latency", ("kind",))
    for v in _values(3)[:400]:
        h.labels("a").record(float(v))
    h.labels("empty")
    reg.histogram("gordo_test_batch", "batches", lo=1.0, hi=1e5).record(17.0)
    reg.counter("gordo_test_never")  # a family with no series: HELP/TYPE only
    side = m.Histogram()
    side.record(0.25)

    def collect():
        yield ("gordo_test_collected", "gauge", "from a collector", {"x": "1"}, 5)
        yield ("gordo_test_collected", "gauge", "from a collector", {"x": "2"}, float("nan"))
        yield ("gordo_test_requests_total", "counter", "", {"kind": "other", "path": "/"}, 4)
        yield ("gordo_test_side_seconds", "histogram", "a collected histogram", {}, side)

    def broken():
        raise RuntimeError("a broken collector must not take down the scrape")
        yield  # pragma: no cover

    reg.collector(collect, key="a")
    reg.collector(broken, key="b")
    reg.collector(lambda: iter(()), key="b")  # the same key replaces it
    with pytest.raises(ValueError):
        reg.gauge("gordo_test_requests_total", "", ("kind", "path"))  # another type
    with pytest.raises(ValueError):
        reg.counter("bad name")
    with pytest.raises(ValueError):
        c.labels("only-one")
    return reg


def test_registry_render_and_snapshot_match_jax_byte_for_byte():
    got, want = _drive(port), _drive(ref)
    text = got.render()
    assert text == want.render()
    assert "gordo_metrics_dropped_series_total" in text and "NaN" in text and "+Inf" in text
    assert got.snapshot() == want.snapshot()
    parsed, parsed_ref = port.parse_prometheus_text(text), ref.parse_prometheus_text(text)
    assert repr(parsed) == repr(parsed_ref)  # NaN values: equal by repr
    types, samples = parsed
    assert repr(port.render_samples(samples, types, {"gordo_test_gauge": "h"})) == repr(
        ref.render_samples(samples, types, {"gordo_test_gauge": "h"}))


def test_parse_prometheus_text_matches_jax_on_odd_lines():
    text = "\n".join([
        "# HELP x y", "# TYPE x counter", "x 1", 'x{a="b\\\\nc",d="e\\"f"} 2 1700000000',
        "malformed line here", "y{a=\"1\"} notanumber", "z +Inf", "w NaN", "", "   ",
    ])
    assert repr(port.parse_prometheus_text(text)) == repr(ref.parse_prometheus_text(text))


@pytest.mark.parametrize("raw", ["", "abc", "nan", "inf", "-1", "0", "0.5", "1e30", " 25 ", None])
def test_parse_deadline_ms_matches_jax(raw):
    assert port_deadline.parse_deadline_ms(raw) == ref_deadline.parse_deadline_ms(raw)


@pytest.mark.parametrize("env", [None, "", "abc", "nan", "inf", "-1", "0", "0.5", "1e30", " 25 "])
def test_default_deadline_ms_matches_jax(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("GORDO_DEFAULT_DEADLINE_MS", raising=False)
    else:
        monkeypatch.setenv("GORDO_DEFAULT_DEADLINE_MS", env)

    def answer(fn):
        try:
            return "value", fn()
        except ValueError as exc:
            return "raises", str(exc)

    assert answer(port_deadline.default_deadline_ms) == answer(ref_deadline.default_deadline_ms)


def test_deadline_matches_jax_semantics():
    assert port_deadline.DEADLINE_HEADER == ref_deadline.DEADLINE_HEADER
    assert port_deadline.MAX_DEADLINE_MS == ref_deadline.MAX_DEADLINE_MS
    assert issubclass(port_deadline.DeadlineExceeded, TimeoutError)
    assert issubclass(ref_deadline.DeadlineExceeded, TimeoutError)
    d = port_deadline.Deadline.after_ms(50)
    assert d.budget_s == 0.05 and not d.expired() and 0 < d.remaining_ms() <= 50
    assert d.expired(d.expires_at) and not d.expired(d.expires_at - 1e-3)
    gone = port_deadline.Deadline(-1)
    assert gone.budget_s == 0.0 and gone.expired() and gone.remaining_s() == 0.0


def _quarantine_sequence(mod, threshold):
    q = mod.QuarantineSet(threshold=threshold)
    trail = []
    for step in [("f", "a", "nan"), ("f", "a", "nan"), ("s", "a"), ("f", "a", "x"), ("f", "b", "boom"),
                 ("f", "a", "y"), ("f", "a", "z"), ("f", "a", "again"), ("f", "c", "1"),
                 ("f", "c", "2"), ("f", "c", "3"), ("snap",), ("clear", ["c", "ghost"]),
                 ("f", "b", "boom2"), ("f", "b", "boom3"), ("drop", "a"), ("snap",), ("clear", None),
                 ("f", "d", "1")]:
        if step[0] == "f":
            trail.append(q.record_failure(step[1], step[2]))
        elif step[0] == "s":
            q.record_success(step[1])
        elif step[0] == "clear":
            trail.append(q.clear(step[1]))
        elif step[0] == "drop":
            q.drop(step[1])
        trail.append((q.snapshot(), q.names(), len(q), "a" in q, q.reason("a"), q.reason("b")))
    return trail


@pytest.mark.parametrize("threshold", [3, 1, 0, -1])
def test_quarantine_matches_jax(threshold, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.5)
    assert port_quarantine.DEFAULT_THRESHOLD == ref_quarantine.DEFAULT_THRESHOLD
    assert _quarantine_sequence(port_quarantine, threshold) == _quarantine_sequence(ref_quarantine, threshold)


def _run_threads(threads, timeout=120):
    """Start and join ``threads`` with the interpreter switching threads
    every microsecond, so that a lost update would show; each must end."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)


def test_quarantine_counts_every_racing_failure():
    """Failures from many threads at once are all counted: at the
    threshold the model is quarantined exactly once."""
    q = port_quarantine.QuarantineSet(threshold=64)
    barrier = threading.Barrier(64)
    newly = []

    def fail():
        barrier.wait(10)
        newly.append(q.record_failure("m", "nan"))

    _run_threads([threading.Thread(target=fail) for _ in range(64)])
    assert newly.count(True) == 1 and q.reason("m")["failures"] == 64


def test_threads_lose_no_count():
    reg = port.MetricsRegistry()
    hist = reg.histogram("gordo_test_seconds", "", ("kind",)).labels("a")
    counter = reg.counter("gordo_test_total").labels()
    alone = PortLatency()
    n_threads, n_values = 32, 10_000
    barrier = threading.Barrier(n_threads)

    def work(i):
        barrier.wait(10)
        for j in range(n_values):
            v = (i * n_values + j) % 997 * 1e-4
            hist.record(v)
            alone.record(v)
            counter.inc()

    _run_threads([threading.Thread(target=work, args=(i,)) for i in range(n_threads)])
    total = n_threads * n_values
    assert hist.count == alone.count == sum(hist.counts) == sum(alone.counts) == total
    assert counter.get() == total
    _, samples = port.parse_prometheus_text(reg.render())
    values = {(n, tuple(sorted(lb.items()))): v for n, lb, v in samples}
    assert values[("gordo_test_total", ())] == total
    assert values[("gordo_test_seconds_count", (("kind", "a"),))] == total
