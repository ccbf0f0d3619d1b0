"""The port's request tracing against the JAX package's, on the CPU.

``traceparent`` headers, malformed ones included, parse and format alike;
the same spans recorded under the same clock and ids give the same span
tree, summary and Chrome export; the ring and the slow reservoir keep the
same traces under the same sequence. Then both servers, on one collection
(a banked dense detector and a bare ``AutoEncoder`` on the per-model
path), get one request sequence with every request traced: the same
``X-Request-Id`` and ``traceparent`` echo, the same stage spans, and the
same keys and integer fields in ``/traces``, ``/traces/slow``, the Chrome
export, ``/slo``, ``/costs`` and ``/stats``' new sections; and with
``GORDO_TRACE_SAMPLE=0``, ``GORDO_SLO=0`` and ``GORDO_COST=0`` the same
disabled answers.
"""

import asyncio
import importlib.util
import itertools
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from gordo_components_torch.observability import tracing as port_tracing
from gordo_components_torch.server import run_server
from gordo_components_tpu import serializer as jax_serializer
from gordo_components_tpu.models import AutoEncoder, DiffBasedAnomalyDetector
from gordo_components_tpu.observability import tracing as jax_tracing
from gordo_components_tpu.server import build_app as jax_build_app

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = importlib.util.spec_from_file_location(
    "jax_artifact_to_torch", os.path.join(REPO, "tools", "jax_artifact_to_torch.py"))
TOOL = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(TOOL)

MODULES = {"jax": jax_tracing, "port": port_tracing}
TID, SID = "ab" * 16, "cd" * 8


# --------------------------------------------------------------------- #
# traceparent
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("header", [
    f"00-{TID}-{SID}-01", f"00-{TID}-{SID}-00", f"00-{TID}-{SID}-03", f" 00-{TID.upper()}-{SID}-01 ",
    None, "", "garbage", f"ff-{TID}-{SID}-01", f"00-{'0' * 32}-{SID}-01", f"00-{TID}-{'0' * 16}-01",
    f"00-{TID[:-2]}-{SID}-01", f"00-{TID}-{SID}-XX", f"00-{TID}-{SID}-01-extra",
])
def test_traceparent_parses_as_jax(header):
    got = port_tracing.parse_traceparent(header)
    assert got == jax_tracing.parse_traceparent(header)
    if got is not None:
        for sampled in (True, False):
            text = port_tracing.format_traceparent(got[0], got[1], sampled)
            assert text == jax_tracing.format_traceparent(got[0], got[1], sampled)
            assert port_tracing.parse_traceparent(text) == (got[0], got[1], sampled)


# --------------------------------------------------------------------- #
# spans, trees and exports under one clock and one id sequence
# --------------------------------------------------------------------- #


class _Clock:
    """``time`` for a tracing module: both clocks read ``now``."""

    def __init__(self):
        self.now = 100.0

    def monotonic(self):
        return self.now

    def time(self):
        return 1.7e9 + self.now


@pytest.fixture
def fixed(monkeypatch):
    """Both modules on one fake clock, span ids from one counter each."""
    clocks = {}
    for name, mod in MODULES.items():
        clocks[name] = _Clock()
        monkeypatch.setattr(mod, "time", clocks[name])
        seq = itertools.count(1)
        monkeypatch.setattr(mod, "_new_span_id", lambda seq=seq: f"{next(seq):016x}")
    return clocks


def _record(mod, clock, tracer=None):
    """One trace with nested, explicit, erroring and abandoned spans."""
    trace = mod.Trace(tracer, "anomaly", trace_id=TID, request_id="rid-1")
    clock.now += 0.001
    trace.add_span("queue_wait", clock.now - 0.001, clock.now, batch=4)
    outer = trace.start_span("device_execute", bucket="b0")
    clock.now += 0.002
    with pytest.raises(RuntimeError):
        with trace.span("postprocess", parent=outer, stage="to_arrays"):
            clock.now += 0.0005
            raise RuntimeError("boom")
    outer.close()
    trace.start_span("abandoned")
    trace.add_span("orphan", clock.now, clock.now + 1.0, parent=mod.Span("x", "f" * 16, None, 0.0))
    clock.now += 0.003
    trace.finish(status=200)
    return trace


def test_span_tree_summary_and_chrome_export_match_jax(fixed):
    traces = {name: _record(mod, fixed[name]) for name, mod in MODULES.items()}
    assert traces["port"].summary() == traces["jax"].summary()
    assert traces["port"].tree() == traces["jax"].tree()
    assert port_tracing.chrome_trace([traces["port"]]) == jax_tracing.chrome_trace([traces["jax"]])
    tree = traces["port"].tree()
    assert [c["name"] for c in tree["children"]][:2] == ["queue_wait", "device_execute"]
    assert traces["port"].error and traces["port"].finished


def test_ring_and_reservoir_keep_the_same_traces(fixed):
    tracers = {name: mod.Tracer(sample=1.0, ring=3, slow_keep=2) for name, mod in MODULES.items()}
    durations = [0.004, 0.001, 0.009, 0.002, 0.007, 0.003]
    for i, d in enumerate(durations):
        for name, mod in MODULES.items():
            trace = tracers[name].start_trace("k", traceparent=f"00-{i + 1:032x}-{SID}-00")
            fixed[name].now += d
            trace.finish()
    ids = {name: ([t.trace_id for t in tr.recent()], [t.trace_id for t in tr.slow()],
                  [t.trace_id for t in tr.recent(2)], [t.trace_id for t in tr.find(f"{3:032x}")])
           for name, tr in tracers.items()}
    assert ids["port"] == ids["jax"]
    assert ids["port"][1] == [f"{3:032x}", f"{5:032x}"]  # the two slowest
    assert tracers["port"].inflight == 0 and tracers["port"].started == len(durations)


def test_sampling_and_a_disabled_tracer_as_jax():
    for mod in MODULES.values():
        assert mod.Tracer(sample=0.0).start_trace("k") is None
        tracer = mod.Tracer(sample=1e-12, ring=8, slow_keep=1)
        # sampled upstream or forced: kept in the ring whatever the head sample
        kept = tracer.start_trace("k", traceparent=f"00-{TID}-{SID}-01")
        forced = tracer.start_trace("k", force=True)
        dropped = tracer.start_trace("k", traceparent=f"00-{'ef' * 16}-{SID}-00")
        for t in (kept, forced, dropped):
            t.finish()
        assert [t.trace_id for t in tracer.recent()] == [forced.trace_id, kept.trace_id]
        assert dropped.retained is False or dropped in tracer.slow()


def test_current_trace_and_use_trace():
    assert port_tracing.current_trace() is None
    trace = port_tracing.Trace(None, "build")
    with port_tracing.use_trace(trace):
        assert port_tracing.current_trace() is trace
    assert port_tracing.current_trace() is None


def test_env_knobs_as_jax(monkeypatch):
    monkeypatch.setenv("GORDO_TRACE_SAMPLE", "0.25")
    monkeypatch.setenv("GORDO_TRACE_RING", "7")
    monkeypatch.setenv("GORDO_TRACE_SLOW_KEEP", "3")
    for mod in MODULES.values():
        tracer = mod.Tracer()
        assert (tracer.sample, tracer._recent.maxlen, tracer.slow_keep) == (0.25, 7, 3)
    monkeypatch.setenv("GORDO_TRACE_SAMPLE", "often")
    with pytest.raises(ValueError, match="GORDO_TRACE_SAMPLE"):
        port_tracing.Tracer()


# --------------------------------------------------------------------- #
# both servers under one request sequence
# --------------------------------------------------------------------- #

P = "/gordo/v0/proj"
X = np.random.RandomState(3).rand(20, 3).astype("float32")
BODY = json.dumps({"X": X.tolist()}).encode()
JSON = {"Content-Type": "application/json"}
T_BANK, T_MODEL = "1f" * 16, "2e" * 16


def _tp(trace_id):
    return {"traceparent": f"00-{trace_id}-{SID}-01"}


# (key, method, path, body, headers)
STEPS = [
    ("bank", "POST", f"{P}/machine-a/anomaly/prediction", BODY, {**JSON, **_tp(T_BANK)}),
    ("per_model", "POST", f"{P}/machine-b/prediction", BODY, {**JSON, **_tp(T_MODEL)}),
    ("expired", "POST", f"{P}/machine-a/anomaly/prediction", BODY, {**JSON, "X-Gordo-Deadline-Ms": "0.001"}),
    ("untraced_rid", "GET", f"{P}/models", None, {"X-Gordo-Request-Id": "rid-7"}),
    ("trace_bank", "GET", f"{P}/traces?id={T_BANK}", None, {}),
    ("trace_model", "GET", f"{P}/traces?id={T_MODEL}", None, {}),
    ("recent", "GET", f"{P}/traces?n=3", None, {}),
    ("bad_n", "GET", f"{P}/traces?n=-1", None, {}),
    ("chrome", "GET", f"{P}/traces?id={T_BANK}&format=chrome", None, {}),
    ("slow", "GET", f"{P}/traces/slow", None, {}),
    ("slo", "GET", f"{P}/slo?refresh=1", None, {}),
    ("costs", "GET", f"{P}/costs?refresh=1", None, {}),
    ("stats", "GET", f"{P}/stats", None, {}),
]
DISABLED_STEPS = [s for s in STEPS if s[0] in ("bank", "recent", "slow", "slo", "costs", "stats")]
ON = {"GORDO_TRACE_SAMPLE": "1", "GORDO_SLO_SAMPLE_S": "3600"}
OFF = {"GORDO_TRACE_SAMPLE": "0", "GORDO_SLO": "0", "GORDO_COST": "0"}


async def _jax_answers(root, steps):
    client = TestClient(TestServer(jax_build_app(root, devices=1)))
    await client.start_server()
    try:
        out = {}
        for key, method, path, raw, headers in steps:
            resp = await client.request(method, path, data=raw, headers=headers)
            out[key] = resp.status, dict(resp.headers), json.loads(await resp.read())
        return out
    finally:
        await client.close()


def _port_answers(root, steps):
    server = run_server(root, host="127.0.0.1", port=0, device="cpu", background=True)
    try:
        out = {}
        for key, method, path, raw, headers in steps:
            req = urllib.request.Request(server.url + path, data=raw, headers=headers, method=method)
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    out[key] = resp.status, dict(resp.headers), json.loads(resp.read())
            except urllib.error.HTTPError as exc:
                out[key] = exc.code, dict(exc.headers), json.loads(exc.read())
        return out
    finally:
        server.close()


def _answers(jax_root, port_root, steps, env):
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return asyncio.run(_jax_answers(jax_root, steps)), _port_answers(port_root, steps)
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def answered(tmp_path_factory):
    rng = np.random.RandomState(0)
    Xv = rng.rand(160, 3).astype("float32")
    jax_root, port_root = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    models = {
        "machine-a": DiffBasedAnomalyDetector(base_estimator=AutoEncoder(epochs=1, batch_size=64)),
        "machine-b": AutoEncoder(epochs=1, batch_size=64),
    }
    for name, model in models.items():
        model.fit(Xv)
        jax_serializer.dump(model, str(jax_root / name), metadata={"name": name})
    assert TOOL.main([str(jax_root), str(port_root)]) == 0
    on = _answers(str(jax_root), str(port_root), STEPS, ON)
    off = _answers(str(jax_root), str(port_root), DISABLED_STEPS, OFF)
    return on, off


def _shape(value):
    """The keys of a JSON body, recursively, with its integers (bools and
    None too) and strings' types: what both servers must share."""
    if isinstance(value, dict):
        return {k: _shape(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_shape(v) for v in value]
    if isinstance(value, float):
        return "float"
    return value


def _keys(value):
    if isinstance(value, dict):
        return {k: _keys(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_keys(v) for v in value[:1]]
    return None


def _span_names(node):
    return [node["name"]] + [n for c in node.get("children", ()) for n in _span_names(c)]


def test_statuses_and_the_id_echo_match_jax(answered):
    (jax, port), _ = answered
    assert {k: v[0] for k, v in port.items()} == {k: v[0] for k, v in jax.items()}
    assert port["bad_n"][0] == 400 and port["expired"][0] == 504
    for key, tid in (("bank", T_BANK), ("per_model", T_MODEL)):
        for answers in (jax, port):
            headers = answers[key][1]
            assert headers["X-Request-Id"] == tid
            assert headers["traceparent"].startswith(f"00-{tid}-") and headers["traceparent"].endswith("-01")
    assert port["untraced_rid"][1]["X-Gordo-Request-Id"] == jax["untraced_rid"][1]["X-Gordo-Request-Id"] == "rid-7"
    # every request is traced, so X-Request-Id is a trace id on both
    assert len(port["untraced_rid"][1]["X-Request-Id"]) == len(jax["untraced_rid"][1]["X-Request-Id"]) == 32


def test_traces_carry_the_jax_stage_spans(answered):
    (jax, port), _ = answered
    for key in ("trace_bank", "trace_model"):
        (got,), (want,) = port[key][2]["traces"], jax[key][2]["traces"]
        assert _keys(got) == _keys(want)
        assert sorted(_span_names(got["spans"])) == sorted(_span_names(want["spans"]))
        assert got["trace_id"] == want["trace_id"] and got["n_spans"] == want["n_spans"]
    names = _span_names(port["trace_bank"][2]["traces"][0]["spans"])
    for stage in ("parse", "queue_wait", "coalesce", "pad", "device_execute", "postprocess"):
        assert stage in names
    per_model = port["trace_model"][2]["traces"][0]["spans"]["children"]
    assert [c["attributes"] for c in per_model if c["name"] == "device_execute"] == [{"path": "per-model"}]
    for key in ("recent", "slow"):
        got, want = port[key][2], jax[key][2]
        assert got["enabled"] is want["enabled"] is True
        # the reservoir orders by duration, which the two servers do not share
        assert sorted(t["name"] for t in got["traces"]) == sorted(t["name"] for t in want["traces"]), key
    assert port["bad_n"][2] == jax["bad_n"][2]
    got, want = port["chrome"][2], jax["chrome"][2]
    assert sorted(got) == sorted(want) == ["displayTimeUnit", "traceEvents"]
    assert sorted(e["name"] for e in got["traceEvents"]) == sorted(e["name"] for e in want["traceEvents"])


def test_slo_costs_and_stats_sections_match_jax(answered):
    (jax, port), _ = answered
    got, want = port["slo"][2], jax["slo"][2]
    assert _keys(got) == _keys(want) and got["n_samples"] == want["n_samples"]
    # request counts are the same; the seconds (window_s, latencies) are not
    def counted(windows):
        return {w: {k: v for k, v in cell.items() if k != "window_s"} for w, cell in windows.items()}

    for g, w in zip(got["objectives"], want["objectives"]):
        if g["name"] == "availability":
            assert counted(g["windows"]) == counted(w["windows"]) and g["fast_burn"] == w["fast_burn"]
    assert {k: counted(c["windows"]) for k, c in got["classes"].items()} == \
        {k: counted(c["windows"]) for k, c in want["classes"].items()}
    assert got["goodput"]["requests"] == want["goodput"]["requests"]
    got, want = port["costs"][2], jax["costs"][2]
    assert _keys(got) == _keys(want)
    assert got["peak_source"] == want["peak_source"] == "assumed"
    # one bucket each, the same rows routed and padded, the same FLOPs a row
    (g,), (w,) = got["buckets"].values(), want["buckets"].values()
    for field in ("flops_per_row", "routed_rows", "padded_rows", "members", "live", "kind", "flops_method"):
        assert g[field] == w[field], field
    stats, jstats = port["stats"][2], jax["stats"][2]
    assert sorted(stats["exemplars"]) == sorted(jstats["exemplars"])
    for kind, edges in stats["exemplars"].items():
        assert all(sorted(ex) == ["at", "trace_id", "value_ms"] for ex in edges.values()), kind
    assert _shape(stats["goodput"]["requests"]) == _shape(jstats["goodput"]["requests"]) == {
        "goodput": 2, "wasted": 0, "expired": 1}
    assert stats["goodput"]["tenants"] == jstats["goodput"]["tenants"]
    for section in ("goodput", "slo", "costs", "bank_pipeline"):
        assert _keys(stats[section]) == _keys(jstats[section]), section
    for key in ("inflight_window",):
        assert stats["bank_pipeline"][key] == jstats["bank_pipeline"][key] == 2
    assert _shape(stats["bank_pipeline"]["overlap"]) == _shape(jstats["bank_pipeline"]["overlap"])


def test_disabled_planes_answer_as_jax(answered):
    _, (jax, port) = answered
    for key in ("recent", "slow", "slo", "costs"):
        assert port[key][0] == 200 and port[key][2] == jax[key][2], key
    assert port["slo"][2] == {"enabled": False} and port["recent"][2] == {"enabled": False, "traces": []}
    for section in ("goodput", "slo", "costs"):
        assert section not in port["stats"][2] and section not in jax["stats"][2]
    assert port["stats"][2]["exemplars"] == jax["stats"][2]["exemplars"] == {}
    for answers in (port, jax):
        headers = answers["bank"][1]
        assert headers["X-Request-Id"] == headers["X-Gordo-Request-Id"] and "traceparent" not in headers
