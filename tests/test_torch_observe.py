"""The port's served observability and resilience against the JAX server's,
on the CPU.

A JAX collection is fitted on seeded rows and written as JAX artifacts: a
dense detector (``machine-a``, banked), a bare ``AutoEncoder``
(``machine-b``, the per-model path), an LSTM detector (``machine-l``,
banked in a second bucket) and a copy of a dense detector whose first
kernel is NaN (``machine-nan``, banked). The JAX server serves the
directory (aiohttp test client); ``tools/jax_artifact_to_torch.py``
converts it and the port serves the result. Both get one request sequence:
scoring POSTs (JSON and parquet), 404s and a 405, three POSTs to the NaN
member and a fourth, the quarantine routes (the two 400s of ``clear``
too), 504s on the bank and the per-model path, ``metadata-all?digest=1``
with gzip, ``/metrics`` and ``/stats``. Then:

- ``/stats`` has equal ``requests``, ``errors``, ``models`` and ``wire``,
  and the engine equal ``requests`` and ``deadline_expired``;
- ``/metrics``, parsed, has the port's families as a subset of the JAX
  server's, the missing ones exactly ``NOT_RENDERED`` (each named in
  ``ROADMAP.md``), and the counters the same integers as ``/stats``;
- the 410 body, ``/healthz``'s degraded body and ``/quarantine`` are equal
  but for ``since``, and ``quarantine/clear``'s answers equal;
- the 504s' body keys and the request id echo are equal;
- the gzipped digest body decompresses to the JAX body.

``ModelBank.score_many`` with a patched clock: a deadline that passes
between the dense and the LSTM group fails the LSTM group alone, and with
``return_exceptions`` the dense group's results stand bitwise. The
batching engine drops a request that expires in its queue before any
bank call.
"""

import asyncio
import gzip
import importlib.util
import json
import math
import os
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest
from aiohttp.test_utils import TestClient, TestServer
from jax import device_count as jax_device_count

from gordo_components_torch.observability.metrics import parse_prometheus_text
from gordo_components_torch.resilience import deadline as port_deadline
from gordo_components_torch.server import run_server
from gordo_components_torch.server.engine import BatchingEngine
from gordo_components_tpu import serializer as jax_serializer
from gordo_components_tpu.client.client import Client
from gordo_components_tpu.models import AutoEncoder, DiffBasedAnomalyDetector, LSTMAutoEncoder
from gordo_components_tpu.server import build_app as jax_build_app

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = importlib.util.spec_from_file_location(
    "jax_artifact_to_torch", os.path.join(REPO, "tools", "jax_artifact_to_torch.py"))
TOOL = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(TOOL)

P = "/gordo/v0/proj"
INDEX = [f"2020-01-01T00:{m:02d}:00Z" for m in range(20)]
X = np.random.RandomState(1).rand(20, 3).astype("float32")
X_BODY = {"X": X.tolist(), "index": INDEX}
PARQUET = Client._encode_parquet(
    pd.DataFrame(X, columns=["tag-0", "tag-1", "tag-2"], index=pd.to_datetime(INDEX, utc=True)), None)
JSON = {"Content-Type": "application/json"}
CLEAR = f"{P}/quarantine/clear"


def _post(path, body=X_BODY, **headers):
    raw = body if isinstance(body, bytes) else json.dumps(body).encode()
    return "POST", path, raw, {**JSON, **headers}


# (key, method, path, body bytes or None, headers); both servers get them in order
STEPS = [
    ("healthz_ok", "GET", "/healthz", None, {}),
    ("a_json_1", *_post(f"{P}/machine-a/anomaly/prediction")),
    ("a_json_2", *_post(f"{P}/machine-a/anomaly/prediction")),
    ("a_parquet", *_post(f"{P}/machine-a/anomaly/prediction", PARQUET, **{"Content-Type": "application/x-parquet"})),
    ("l_json", *_post(f"{P}/machine-l/anomaly/prediction")),
    ("b_prediction", *_post(f"{P}/machine-b/prediction")),
    ("route_404", "GET", f"{P}/nowhere/at/all", None, {}),
    ("target_404", *_post(f"{P}/ghost/anomaly/prediction")),
    ("method_405", "GET", f"{P}/machine-a/prediction", None, {}),
    ("nan_1", *_post(f"{P}/machine-nan/anomaly/prediction")),
    ("nan_2", *_post(f"{P}/machine-nan/anomaly/prediction")),
    ("nan_3", *_post(f"{P}/machine-nan/anomaly/prediction")),
    ("nan_410", *_post(f"{P}/machine-nan/anomaly/prediction")),
    ("nan_prediction_410", *_post(f"{P}/machine-nan/prediction")),
    ("healthz_degraded", "GET", "/healthz", None, {}),
    ("quarantine", "GET", f"{P}/quarantine", None, {}),
    ("metrics_quarantined", "GET", f"{P}/metrics", None, {}),
    ("clear_not_json", *_post(CLEAR, b"not json")),
    ("clear_not_list", *_post(CLEAR, {"targets": "machine-nan"})),
    ("a_504", *_post(f"{P}/machine-a/anomaly/prediction",
                     **{"X-Gordo-Deadline-Ms": "0.001", "X-Gordo-Request-Id": "rid-bank"})),
    ("b_504", *_post(f"{P}/machine-b/prediction",
                     **{"X-Gordo-Deadline-Ms": "0.001", "X-Gordo-Request-Id": "rid-per-model"})),
    ("a_long_rid", *_post(f"{P}/machine-a/anomaly/prediction", **{"X-Gordo-Request-Id": "r" * 200})),
    ("clear", *_post(CLEAR, {"targets": ["machine-nan"]})),
    ("quarantine_after", "GET", f"{P}/quarantine", None, {}),
    ("nan_after_clear", *_post(f"{P}/machine-nan/anomaly/prediction")),
    ("digest_gzip", "GET", f"{P}/metadata-all?digest=1", None, {"Accept-Encoding": "gzip"}),
    ("metrics", "GET", f"{P}/metrics", None, {}),
    ("stats", "GET", f"{P}/stats", None, {}),
]

# families the JAX server renders and the port does not yet, by the item of
# ROADMAP.md's queue A that brings them (each is named there): none since
# the sharded bank and the placement controller came
NOT_RENDERED = set()


def _nan_detector(fitted: DiffBasedAnomalyDetector) -> DiffBasedAnomalyDetector:
    """``fitted`` with its first kernel set to NaN."""
    est = fitted.base_estimator
    params = {k: dict(v) for k, v in est.params_["params"].items()}
    params["Dense_0"]["kernel"] = np.full_like(np.asarray(params["Dense_0"]["kernel"]), np.nan)
    est.params_ = {"params": params}
    return fitted


async def _jax_answers(root, steps=STEPS, then=None):
    """(status, headers, body) of every step from the JAX server;
    ``then(app)`` runs after the last step."""
    client = TestClient(TestServer(jax_build_app(root)))
    await client.start_server()
    try:
        out = {}
        for key, method, path, raw, headers in steps:
            if then is not None and key == "metrics":
                then(client.server.app)
            resp = await client.request(method, path, data=raw, headers=headers)
            text = await resp.read()
            body = json.loads(text) if resp.content_type == "application/json" else text.decode()
            out[key] = resp.status, dict(resp.headers), body
        return out
    finally:
        await client.close()


def call(server, method, path, raw=None, headers=None):
    """(status, headers, body) of one request to the port; the body JSON,
    gunzipped JSON, or text."""
    req = urllib.request.Request(server.url + path, data=raw, headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            status, hdrs, data = resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        status, hdrs, data = exc.code, dict(exc.headers), exc.read()
    if hdrs.get("Content-Encoding") == "gzip":
        data = gzip.decompress(data)
    if hdrs["Content-Type"] == "application/json":
        return status, hdrs, json.loads(data)
    return status, hdrs, data.decode()


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """(JAX root, port root) of the collection, written once."""
    rng = np.random.RandomState(0)
    Xv = rng.rand(200, 3).astype("float32")
    jax_root, port_root = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    models = {
        "machine-a": DiffBasedAnomalyDetector(base_estimator=AutoEncoder(epochs=1, batch_size=64)),
        "machine-b": AutoEncoder(epochs=1, batch_size=64),
        "machine-l": DiffBasedAnomalyDetector(base_estimator=LSTMAutoEncoder(
            kind="lstm_model", dims=(4,), lookback_window=8, epochs=1, batch_size=64)),
        "machine-nan": DiffBasedAnomalyDetector(base_estimator=AutoEncoder(epochs=1, batch_size=64)),
    }
    for name, model in models.items():
        model.fit(pd.DataFrame(Xv, columns=["tag-0", "tag-1", "tag-2"]) if name != "machine-b" else Xv)
    _nan_detector(models["machine-nan"])
    for name, model in models.items():
        jax_serializer.dump(model, str(jax_root / name), metadata={"name": name})
    assert TOOL.main([str(jax_root), str(port_root)]) == 0
    return str(jax_root), str(port_root)


@pytest.fixture(scope="module")
def served(roots):
    jax_root, port_root = roots
    # on both servers: one SLO sample for the whole sequence, however long
    # it takes (a second one would render gordo_slo_objective_ratio), and
    # every trace kept (head sampling would drop random kinds' exemplars)
    pinned = {"GORDO_SLO_SAMPLE_S": "3600", "GORDO_TRACE_SAMPLE": "1"}
    env = {k: os.environ.get(k) for k in pinned}
    os.environ.update(pinned)
    try:
        jax = asyncio.run(_jax_answers(jax_root))
        server = run_server(port_root, host="127.0.0.1", port=0, device="cpu", background=True)
    finally:
        for k, v in env.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    try:
        port = {key: call(server, method, path, raw, headers) for key, method, path, raw, headers in STEPS}
        yield server, jax, port
    finally:
        server.close()


def _without_since(body):
    if isinstance(body, dict):
        return {k: _without_since(v) for k, v in body.items() if k != "since"}
    return body


def test_the_sequence_answers_the_same_statuses(served):
    _, jax, port = served
    assert {k: v[0] for k, v in port.items()} == {k: v[0] for k, v in jax.items()}
    assert port["nan_410"][0] == 410 and port["a_504"][0] == port["b_504"][0] == 504


def test_stats_counters_match_jax(served):
    _, jax, port = served
    got, want = port["stats"][2], jax["stats"][2]
    for key in ("requests", "errors", "models", "wire"):
        assert got[key] == want[key], key
    assert got["requests"]["anomaly"] == 12 and got["requests"]["other"] == 2
    assert got["wire"]["requests"] == {"json": 14, "parquet": 1}
    for key in ("requests", "deadline_expired", "shed"):
        assert got["bank_engine"][key] == want["bank_engine"][key], key
    assert got["bank_engine"]["deadline_expired"] == 2  # the bank's 504 and the per-model one
    assert got["bank_models"] == want["bank_models"] == 3
    # exemplars: the same kinds, each naming a trace the port retained
    assert sorted(got["exemplars"]) == sorted(want["exemplars"]) and got["workers"] == {}
    for edges in got["exemplars"].values():
        assert all(len(ex["trace_id"]) == 32 for ex in edges.values())
    assert _without_since(got["quarantine"]) == _without_since(want["quarantine"])
    assert got["load_failures"] == want["load_failures"] == {"current": {}, "total": 0}
    assert sorted(got["latency"]) == sorted(want["latency"])
    assert all(got["latency"][k]["count"] == want["latency"][k]["count"] for k in got["latency"])


def _families(text):
    types, samples = parse_prometheus_text(text)
    return types, {(n, tuple(sorted(lb.items()))): v for n, lb, v in samples}


def test_metrics_families_are_the_jax_servers_but_the_listed_ones(served):
    _, jax, port = served
    status, headers, text = port["metrics"]
    assert status == 200 and headers["Content-Type"] == "text/plain; version=0.0.4; charset=utf-8"
    got, _ = _families(text)
    want, _ = _families(jax["metrics"][2])
    assert set(got) <= set(want), set(got) - set(want)
    assert set(want) - set(got) == NOT_RENDERED
    for name in got:
        assert got[name] == want[name], name
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        roadmap = f.read()
    assert [n for n in sorted(NOT_RENDERED) if n not in roadmap] == []


def test_metrics_counters_are_the_stats_integers(served):
    _, _, port = served
    _, values = _families(port["metrics"][2])
    stats = port["stats"][2]
    # /metrics was read one request before /stats, its first
    requests = {k: n for k, n in stats["requests"].items() if k != "stats"}
    for kind, n in requests.items():
        assert values[("gordo_server_requests_total", (("kind", kind),))] == n, kind
    for enc, n in stats["wire"]["requests"].items():
        assert values[("gordo_server_requests_total", (("encoding", enc),))] == n
        assert values[("gordo_server_request_bytes_total", (("encoding", enc),))] == stats["wire"]["bytes"][enc]
    assert values[("gordo_server_errors_total", ())] == stats["errors"]
    engine = stats["bank_engine"]
    assert values[("gordo_engine_requests_total", ())] == engine["requests"]
    assert values[("gordo_engine_batches_total", ())] == engine["batches"]
    assert values[("gordo_engine_deadline_expired_total", ())] == engine["deadline_expired"]
    calls = {lb[0][1]: v for (n, lb), v in values.items() if n == "gordo_bank_bucket_calls_total"}
    assert len(calls) == 2 and sum(calls.values()) == engine["batches"]
    assert values[("gordo_quarantined_models", ())] == 0  # machine-nan was cleared
    assert _families(port["metrics_quarantined"][2])[1][("gordo_quarantined_models", ())] == 1
    assert values[("gordo_bank_models", ())] == 3
    assert not any(n.startswith("gordo_device_hbm") for n, _ in values)  # the CPU reports none


def test_the_quarantine_answers_match_jax(served):
    _, jax, port = served
    for key in ("nan_1", "nan_2", "nan_3"):
        for answers in (port, jax):
            status, _, body = answers[key]
            assert status == 200
            assert all(math.isnan(v) for v in body["data"]["total-anomaly-scaled"]), key
    for key in ("nan_410", "nan_prediction_410", "healthz_degraded", "quarantine", "clear_not_json",
                "clear_not_list", "clear", "quarantine_after"):
        assert _without_since(port[key][2]) == _without_since(jax[key][2]), key
    body = port["nan_410"][2]
    assert body["failures"] == 3 and body["reason"] == "non-finite scores in model output"
    assert isinstance(body["since"], float)
    assert port["healthz_degraded"][2]["status"] == "degraded"
    assert list(port["healthz_degraded"][2]["quarantined"]) == ["machine-nan"]
    assert port["clear"][2] == {"enabled": True, "cleared": ["machine-nan"]}
    assert port["nan_after_clear"][0] == 200  # re-admitted, and failing again


def test_the_504_answers_and_request_ids_match_jax(served):
    _, jax, port = served
    for key, rid in (("a_504", "rid-bank"), ("b_504", "rid-per-model")):
        (status, headers, body), (_, jax_headers, jax_body) = port[key], jax[key]
        assert status == 504 and sorted(body) == sorted(jax_body) == ["error", "request_id"]
        assert body["request_id"] == jax_body["request_id"] == rid
        assert headers["X-Gordo-Request-Id"] == jax_headers["X-Gordo-Request-Id"] == rid
        # traced, as on the JAX server: X-Request-Id is the trace id
        assert "Retry-After" not in headers and headers["X-Request-Id"] != rid
        assert len(headers["X-Request-Id"]) == len(jax_headers["X-Request-Id"]) == 32
    assert port["a_long_rid"][1]["X-Gordo-Request-Id"] == jax["a_long_rid"][1]["X-Gordo-Request-Id"] == "r" * 128
    made = port["healthz_ok"][1]["X-Gordo-Request-Id"]
    assert made.startswith("srv-") and int(made[4:], 16) > 0


def test_gzipped_digest_matches_jax(served):
    server, jax, port = served
    status, headers, body = port["digest_gzip"]
    want = jax["digest_gzip"][2]
    assert want["bank"]["devices"] == jax_device_count()  # the JAX bank shards over the test mesh
    want["bank"]["devices"] = 1
    assert status == 200 and headers["Content-Encoding"] == "gzip" and body == want
    plain = call(server, "GET", f"{P}/metadata-all?digest=1")
    assert "Content-Encoding" not in plain[1] and plain[2] == want


def test_a_nan_member_does_not_leak_into_its_neighbours(served):
    bank = served[0].app.bank
    alone = bank.score_many([("machine-a", X, None), ("machine-l", X, None)])
    mixed = bank.score_many([("machine-nan", X, None), ("machine-a", X, None), ("machine-nan", X[:9], None),
                             ("machine-l", X, None)])
    assert np.isnan(mixed[0].total_scaled).all() and np.isnan(mixed[2].total_scaled).all()
    for got, want in zip(mixed[1::2], alone):
        for key, value in want.to_arrays().items():
            np.testing.assert_array_equal(got.to_arrays()[key], value)


class _Clock:
    """``time`` for the deadline module: ``monotonic`` reads ``now``."""

    now = 0.0

    @classmethod
    def monotonic(cls):
        return cls.now


def test_score_many_stops_between_bucket_groups(served, monkeypatch):
    bank = served[0].app.bank
    requests = [("machine-a", X, None), ("machine-l", X, None), ("machine-a", X[:7], None)]
    alone = bank.score_many([requests[0], requests[2]])
    monkeypatch.setattr(port_deadline, "time", _Clock)
    _Clock.now = 0.0
    deadline = port_deadline.Deadline(1.0)
    dispatch = bank._dispatch

    def then_late(run):
        dispatch(run)
        _Clock.now = 2.0  # the deadline passes after the first group

    monkeypatch.setattr(bank, "_dispatch", then_late)
    results = bank.score_many(requests, deadline=deadline, return_exceptions=True)
    assert isinstance(results[1], port_deadline.DeadlineExceeded)
    for got, want in zip((results[0], results[2]), alone):
        for key, value in want.to_arrays().items():
            np.testing.assert_array_equal(got.to_arrays()[key], value)
    _Clock.now = 0.0
    with pytest.raises(port_deadline.DeadlineExceeded):
        bank.score_many(requests, deadline=deadline)


def test_engine_drops_a_request_that_expires_in_its_queue(served):
    bank = served[0].app.bank
    calls = []

    class Counting:
        registry = None  # an uninstrumented bank's

        def score_many(self, requests, deadline=None, return_exceptions=False):
            calls.append(len(requests))
            return bank.score_many(requests, deadline, return_exceptions)

        def score(self, name, X, y=None):
            calls.append(1)
            return bank.score(name, X, y)

    engine = BatchingEngine(Counting(), max_batch=8, flush_ms=200.0)
    engine.start()
    try:
        with pytest.raises(port_deadline.DeadlineExceeded, match="admission"):
            engine.submit("machine-a", X, deadline=port_deadline.Deadline(0.0))
        late = engine.submit("machine-a", X, deadline=port_deadline.Deadline.after_ms(20))
        with pytest.raises(port_deadline.DeadlineExceeded, match="in scoring queue"):
            late.result(30)
        assert calls == []
        assert engine.score_blocking("machine-a", X, timeout=30, deadline=port_deadline.Deadline(30.0))
    finally:
        engine.stop()
    stats = engine.stats_snapshot()
    assert (stats["deadline_expired"], stats["requests"], calls) == (2, 2, [1])
    assert engine.service.count == engine.queue_wait.count == 2


def test_concurrent_requests_lose_no_count(served):
    """The server answers each connection on its own thread: 16 threads of
    8 requests each, with the interpreter switching threads every
    microsecond, are all counted, in ``requests``, the latency histogram
    and ``errors``."""
    server = served[0]

    def counts():
        stats = call(server, "GET", f"{P}/stats")[2]
        return stats["requests"].get("ready", 0), stats["latency"].get("ready", {}).get("count", 0), \
            stats["errors"]

    before = counts()

    def work():
        for i in range(8):
            call(server, "GET", f"{P}/ready" if i % 2 else f"{P}/nowhere/else")

    threads = [threading.Thread(target=work) for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    after = counts()
    assert (after[0] - before[0], after[1] - before[1], after[2] - before[2]) == (64, 64, 64)


# history on, a tenant limited to two requests: the third is shed
HISTORY_ENV = {"GORDO_HISTORY": "1", "GORDO_HISTORY_INTERVAL_S": "3600", "GORDO_SLO_SAMPLE_S": "3600",
               "GORDO_QOS_TENANTS": json.dumps({"acme": {"rate": 0.001, "burst": 2}})}
HISTORY_STEPS = [
    (f"acme_{i}", *_post(f"{P}/machine-a/anomaly/prediction", **{"X-Gordo-Tenant": "acme"})) for i in range(3)
] + [("metrics", "GET", f"{P}/metrics", None, {})]
HISTORY_FAMILIES = ("gordo_qos_shed_total", "gordo_history_series", "gordo_history_samples_total",
                    "gordo_history_dropped_series_total")


def _family_lines(text, name):
    return [line for line in text.splitlines() if line.split("{")[0].split(" ")[0] == name
            or line.startswith((f"# HELP {name} ", f"# TYPE {name} "))]


def test_history_and_a_shed_render_as_jax(roots):
    """With ``GORDO_HISTORY=1`` and one shed request, ``gordo_qos_shed_total``
    and the three ``gordo_history_*`` families render as the JAX server
    renders them; ``gordo_history_series`` counts each store's series,
    whose families differ only by those the port does not render yet."""
    jax_root, port_root = roots
    stores = {}
    env = {k: os.environ.get(k) for k in HISTORY_ENV}
    os.environ.update(HISTORY_ENV)
    try:
        def sample_jax(app):
            stores["jax"] = app["history"]
            app["history"].sample()

        jax = asyncio.run(_jax_answers(jax_root, HISTORY_STEPS, then=sample_jax))
        server = run_server(port_root, host="127.0.0.1", port=0, device="cpu", background=True)
    finally:
        for k, v in env.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    try:
        port = {}
        for key, method, path, raw, headers in HISTORY_STEPS:
            if key == "metrics":
                server.app.history.sample()
            port[key] = call(server, method, path, raw, headers)
        stores["port"] = server.app.history
    finally:
        server.close()
    assert [port[f"acme_{i}"][0] for i in range(3)] == [jax[f"acme_{i}"][0] for i in range(3)] == [200, 200, 429]
    text, jax_text = port["metrics"][2], jax["metrics"][2]
    for name in HISTORY_FAMILIES[:1] + HISTORY_FAMILIES[2:]:
        assert _family_lines(text, name) == _family_lines(jax_text, name) != [], name
    assert _family_lines(text, "gordo_qos_shed_total")[-1] == \
        'gordo_qos_shed_total{class="interactive",reason="tenant_rate",tenant="acme"} 1'
    assert _family_lines(text, "gordo_history_samples_total")[-1] == "gordo_history_samples_total 2"
    series, jax_series = _family_lines(text, "gordo_history_series"), _family_lines(jax_text, "gordo_history_series")
    assert series[:2] == jax_series[:2]
    names, jax_names = stores["port"].series_names(), stores["jax"].series_names()
    assert series[2] == f"gordo_history_series {len(names)}" and jax_series[2] == f"gordo_history_series {len(jax_names)}"
    # the families the stores hold: the JAX server's but the ones the port
    # does not render yet (a histogram's _count and _sum rate under its name)
    def families(keys):
        return {k.split("{")[0].split(":")[0].removesuffix("_count").removesuffix("_sum") for k in keys}

    assert families(names) <= families(jax_names)
    assert families(jax_names) - families(names) <= NOT_RENDERED
