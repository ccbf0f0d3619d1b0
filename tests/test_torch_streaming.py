"""The port's streaming plane against the JAX package's, on the CPU.

Detectors are fitted once with the JAX package at tests/test_streaming.py's
size (``SimulatedLiveProvider`` frames of 240 rows, 3 epochs; four members
of 3 tags and two of 5, two bank buckets), written as JAX artifacts and
converted with ``tools/jax_artifact_to_torch.py``. Both servers run with
``GORDO_STREAM=1`` and ``GORDO_BANK_DTYPE=int8`` and get one sequence of
requests: healthy windows over JSON (epoch seconds and ISO 8601 stamps,
late rows, a re-send, ``null`` cells) and the tensor wire, the 400s and
404s of ``/ingest``, a ``/drift`` sweep, a mean shift in two members'
windows and a second sweep, ``/adapt``'s 400s and a recalibration, then
``/stats``, ``/metrics`` and ``/events``.

- the ``/ingest`` answers are equal (the watermark of a stamp-less tensor
  body is each server's clock, left out), and so are ``/stats``'
  ``requests``, ``wire`` and ``bank_capacity`` (its ``kernel`` names each
  side's route);
- ``/drift`` within rtol 1e-5 with equal ``drifted`` lists and counts; the
  recalibrated thresholds within the bank's band; the events and the
  stream, drift and ``bank_capacity`` series families equal;
- ``stream.ingest`` and ``stream.refit`` armed once: the same statuses,
  counters and generation untouched on both;
- with ``GORDO_STREAM=0`` the 404 bodies naming the knob and ``/drift``'s
  ``{"enabled": false}`` are equal and no stream, drift or push series
  render;
- the port alone: a refit at ``learning_rate=0`` keeps the warm weights
  bitwise, one with the trainer's rate is ``incremental-refit`` at the
  next generation; a flagged member's ``drift:<name>`` span;
  ``Client.ingest`` in JSON and tensor against both servers;
- the window buffers, the ingestor and the provider bitwise against the
  JAX modules; the three documented divergences (threads for the asyncio
  loops under ``app.reload_lock``, ISO stamps read by ``times.to_ns``,
  see also tests/test_torch_quantize.py for the bytes of variational and
  bfloat16-compute buckets).
"""

import asyncio
import contextlib
import importlib.util
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest
from aiohttp.test_utils import TestClient, TestServer

import gordo_components_tpu.resilience as jax_resilience
from gordo_components_torch import resilience as port_resilience
from gordo_components_torch.client import Client as PortClient
from gordo_components_torch.dataset.data_provider.streaming import SimulatedLiveProvider as PortProvider
from gordo_components_torch.dataset.times import to_ns
from gordo_components_torch.observability.metrics import parse_prometheus_text
from gordo_components_torch.parallel import fleet as port_fleet
from gordo_components_torch.server import run_server
from gordo_components_torch.streaming.ingest import StreamIngestor as PortIngestor
from gordo_components_torch.streaming.ingest import WindowBuffer as PortBuffer
from gordo_components_torch.utils.wire import TENSOR_CONTENT_TYPE, pack_frames
from gordo_components_tpu import serializer as jax_serializer
from gordo_components_tpu.dataset.data_provider.streaming import SimulatedLiveProvider as JaxProvider
from gordo_components_tpu.models import AutoEncoder, DiffBasedAnomalyDetector
from gordo_components_tpu.server import build_app as jax_build_app
from gordo_components_tpu.streaming.ingest import StreamIngestor as JaxIngestor
from gordo_components_tpu.streaming.ingest import WindowBuffer as JaxBuffer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = importlib.util.spec_from_file_location(
    "jax_artifact_to_torch", os.path.join(REPO, "tools", "jax_artifact_to_torch.py"))
TOOL = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(TOOL)

P = "/gordo/v0/p"
TAGS3 = [f"tag-{i}" for i in range(3)]
TAGS5 = [f"tag-{i}" for i in range(5)]
MEMBERS = {"m3-0": TAGS3, "m3-1": TAGS3, "m3-2": TAGS3, "m3-3": TAGS3, "m5-0": TAGS5, "m5-1": TAGS5}
SHIFTED = ("m3-1", "m5-0")
T_TRAIN, T_LIVE = "2026-08-01T00:00:00Z", "2026-08-02T00:00:00Z"
BASE_TS = float(int(time.time()) - 3600)  # both servers get these event times
ENV = {"GORDO_STREAM": "1", "GORDO_SERVER_WARMUP": "0", "GORDO_STREAM_WINDOW": "128",
       "GORDO_STREAM_MIN_ROWS": "32", "GORDO_REFIT_EPOCHS": "2", "GORDO_BANK_DTYPE": "int8",
       "GORDO_TRACE_SAMPLE": "1", "GORDO_SLO_SAMPLE_S": "3600"}
DRIFT_RTOL = 1e-5
THRESHOLD_BAND = dict(rtol=1e-4, atol=1e-5)
CLOCK_KEYS = ("watermark_lag_seconds", "staleness_seconds", "last_eval_seconds")
EVENT_TYPES = "drift.flagged,drift.cleared,adapt.recalibrate,adapt.refit,adapt.rolled_back"


@contextlib.contextmanager
def env_set(values):
    before = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _rows(vals):
    return [[None if v != v else float(v) for v in row] for row in np.asarray(vals).tolist()]


def _json(path, body):
    raw = body if isinstance(body, bytes) else json.dumps(body).encode()
    return "POST", path, raw, {"Content-Type": "application/json"}


def _tensor(path, frames):
    return "POST", path, pack_frames(frames), {"Content-Type": TENSOR_CONTENT_TYPE}


def _steps():
    """(key, method, path, body, headers) of the shared sequence."""
    prov = JaxProvider(freq="10s", noise=0.1, seed=5)
    steps, t = [], [BASE_TS]

    def stamps(ts):
        out = np.asarray(ts) - ts[0] + t[0]
        t[0] = float(out[-1]) + 10.0
        return out

    for name, tags in MEMBERS.items():
        ts, vals = prov.batch(pd.Timestamp(T_LIVE), 96, tags)
        steps.append((f"ing_{name}", *_json(f"{P}/{name}/ingest", {"rows": _rows(vals),
                                                                    "timestamps": stamps(ts).tolist()})))
    ts, vals = prov.batch(pd.Timestamp(T_LIVE), 8, TAGS3)
    iso = [pd.Timestamp(s, unit="s", tz="UTC").isoformat() for s in stamps(ts)]
    steps.append(("ing_iso", *_json(f"{P}/m3-2/ingest", {"rows": _rows(vals), "timestamps": iso})))
    ts, vals = prov.batch(pd.Timestamp(T_LIVE), 8, TAGS5)
    steps.append(("ing_tensor", *_tensor(f"{P}/m5-1/ingest", [("rows", vals), ("timestamps", stamps(ts))])))
    steps.append(("ing_tensor_now", *_tensor(f"{P}/m5-1/ingest", [("rows", vals[:3])])))
    late = np.asarray([BASE_TS - 1000.0, BASE_TS - 10.0])
    steps.append(("ing_late", *_json(f"{P}/m3-3/ingest", {"rows": _rows(vals[:2, :3]), "timestamps": late.tolist()})))
    dup = steps[0][3]
    steps.append(("ing_dup", "POST", f"{P}/m3-0/ingest", dup, {"Content-Type": "application/json"}))
    holes = vals[:4, :3].copy()
    holes[1, 2] = holes[3, 0] = np.nan
    steps.append(("ing_null", *_json(f"{P}/m3-3/ingest", {"rows": _rows(holes), "timestamps": stamps(ts[:4]).tolist()})))
    steps += [
        ("bad_json", *_json(f"{P}/m3-0/ingest", b"not json")),
        ("empty_rows", *_json(f"{P}/m3-0/ingest", {"rows": []})),
        ("ts_mismatch", *_json(f"{P}/m3-0/ingest", {"rows": [[1, 2, 3]] * 2, "timestamps": [1.0]})),
        ("ts_not_list", *_json(f"{P}/m3-0/ingest", {"rows": [[1, 2, 3]], "timestamps": 1.0})),
        ("bad_tensor", *_tensor(f"{P}/m3-0/ingest", [("X", vals[:2, :3])])),
        ("unknown", *_json(f"{P}/ghost/ingest", {"rows": [[1, 2, 3]]})),
        ("push_off", "GET", f"{P}/m3-0/results/stream?timeout=0", None, {}),
        ("drift_0", "GET", f"{P}/drift?refresh=1", None, {}),
    ]
    prov.inject(mean_shift=4.0)
    for k in range(2):  # 192 shifted rows displace the healthy 128-row windows
        for name in SHIFTED:
            ts, vals = prov.batch(pd.Timestamp(T_LIVE) + pd.Timedelta(f"{k + 1}h"), 96, MEMBERS[name])
            steps.append((f"shift_{k}_{name}", *_json(f"{P}/{name}/ingest", {
                "rows": _rows(vals), "timestamps": stamps(ts).tolist()})))
    steps += [
        ("drift_1", "GET", f"{P}/drift?refresh=1", None, {}),
        ("adapt_bad_mode", *_json(f"{P}/adapt", {"mode": "retrain"})),
        ("adapt_bad_targets", *_json(f"{P}/adapt", {"targets": "m3-1"})),
        ("adapt_not_object", *_json(f"{P}/adapt", [1])),
        ("adapt_recal", *_json(f"{P}/adapt", {})),
        ("adapt_none", *_json(f"{P}/adapt", {})),
        ("drift_2", "GET", f"{P}/drift", None, {}),
        ("stats", "GET", f"{P}/stats", None, {}),
        ("metrics", "GET", f"{P}/metrics", None, {}),
        ("events", "GET", f"{P}/events?type={EVENT_TYPES}", None, {}),
    ]
    return steps


STEPS = _steps()


async def _jax_run(root, steps, then=None):
    """(status, body) of every step from the JAX server, and what ``then``
    returns of its app after them."""
    client = TestClient(TestServer(jax_build_app(root, devices=1)))
    await client.start_server()
    try:
        out = {}
        for key, method, path, raw, headers in steps:
            resp = await client.request(method, path, data=raw, headers=headers)
            text = await resp.read()
            out[key] = resp.status, (json.loads(text) if resp.content_type == "application/json" else text.decode())
        extra = await then(client) if then is not None else None
        return out, extra
    finally:
        await client.close()


def call(url, method, path, raw=None, headers=None):
    req = urllib.request.Request(url + path, data=raw, headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, ctype, data = resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as exc:
        status, ctype, data = exc.code, exc.headers["Content-Type"], exc.read()
    return status, (json.loads(data) if ctype == "application/json" else data.decode())


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """(JAX root, port root): detectors trained on the generator the stream
    uses, so healthy streamed rows match their training distribution."""
    prov = JaxProvider(freq="10s", noise=0.1, seed=5)
    jax_root, port_root = tmp_path_factory.mktemp("jax-stream"), tmp_path_factory.mktemp("port-stream")
    for name, tags in MEMBERS.items():
        det = DiffBasedAnomalyDetector(base_estimator=AutoEncoder(epochs=3, batch_size=64))
        det.fit(prov.frame(pd.Timestamp(T_TRAIN), 240, tags))
        jax_serializer.dump(det, str(jax_root / name), metadata={"name": name})
    assert TOOL.main([str(jax_root), str(port_root)]) == 0
    return str(jax_root), str(port_root)


def _thresholds(models):
    return {n: (float(models[n].total_threshold_), np.asarray(models[n].feature_thresholds_, np.float64),
                models[n].threshold_method_) for n in SHIFTED}


@pytest.fixture(scope="module")
def served(roots):
    """Both servers over the sequence; the port server stays up for the
    port-only checks."""
    jax_root, port_root = roots

    async def jax_then(client):
        return _thresholds(client.server.app["collection"].models)

    with env_set(ENV):
        jax, jax_th = asyncio.run(_jax_run(jax_root, STEPS, jax_then))
        server = run_server(port_root, host="127.0.0.1", port=0, device="cpu", background=True)
    try:
        port = {key: call(server.url, m, path, raw, h) for key, m, path, raw, h in STEPS}
        port_th = _thresholds(server.app.collection.models)
        yield server, jax, port, jax_th, port_th
    finally:
        server.close()


def _without(body, keys):
    if isinstance(body, dict):
        return {k: _without(v, keys) for k, v in body.items() if k not in keys}
    return body


# ---------------------------------------------------------------------- #
# both servers over one sequence
# ---------------------------------------------------------------------- #


def test_ingest_answers_match_jax(served):
    _, jax, port, _, _ = served
    keys = [k for k, *_ in STEPS if k.startswith(("ing_", "shift_", "bad_", "empty_", "ts_", "unknown", "push_"))]
    assert {k: port[k][0] for k in keys} == {k: jax[k][0] for k in keys}
    for key in keys:
        drop = ("watermark",) if key == "ing_tensor_now" else ()
        assert _without(port[key][1], drop) == _without(jax[key][1], drop), key
    assert port["ing_late"][1]["dropped"] == 2 and port["ing_dup"][1]["duplicates"] > 0
    assert port["push_off"] == (404, {"error": "push mode not enabled (GORDO_PUSH=0)"})
    assert port["unknown"][0] == 404 and port["bad_tensor"][0] == port["ts_mismatch"][0] == 400


def test_drift_matches_jax(served):
    _, jax, port, _, _ = served
    assert port["drift_0"][1]["drifted"] == jax["drift_0"][1]["drifted"] == []
    assert port["drift_1"][1]["drifted"] == jax["drift_1"][1]["drifted"] == sorted(SHIFTED)
    for key in ("drift_0", "drift_1", "drift_2"):
        got, want = port[key][1], jax[key][1]
        assert sorted(got) == sorted(want)
        for name, w in want["members"].items():
            g = got["members"][name]
            for k, v in w.items():
                if k in CLOCK_KEYS:
                    continue
                if isinstance(v, float) and k != "drift_score":
                    np.testing.assert_allclose(g[k], v, rtol=DRIFT_RTOL, err_msg=f"{key} {name} {k}")
                elif k == "drift_score" and v is not None:
                    np.testing.assert_allclose(g[k], v, rtol=DRIFT_RTOL, err_msg=f"{key} {name}")
                else:
                    assert g[k] == v, (key, name, k)
        assert _without(got, ("members", *CLOCK_KEYS)) == _without(want, ("members", *CLOCK_KEYS)), key


def test_adapt_answers_and_recalibrated_thresholds_match_jax(served):
    _, jax, port, jax_th, port_th = served
    for key in ("adapt_bad_mode", "adapt_bad_targets", "adapt_not_object", "adapt_none"):
        assert port[key] == jax[key], key
    status, body = port["adapt_recal"]
    assert status == 200 and _without(body, ("swap",)) == _without(jax["adapt_recal"][1], ("swap",))
    assert body["swap"]["generation"] == jax["adapt_recal"][1]["swap"]["generation"] == 1
    for name in SHIFTED:
        (gt, gf, gm), (wt, wf, wm) = port_th[name], jax_th[name]
        assert gm == wm == "recalibrated-ewma"
        np.testing.assert_allclose(gt, wt, **THRESHOLD_BAND)
        np.testing.assert_allclose(gf, wf, **THRESHOLD_BAND)
    # the adapted members start afresh: not flagged until the next sweep
    assert port["drift_2"][1]["drifted"] == jax["drift_2"][1]["drifted"] == []


def test_stats_wire_and_bank_capacity_match_jax(served):
    _, jax, port, _, _ = served
    got, want = port["stats"][1], jax["stats"][1]
    for key in ("requests", "errors", "wire"):
        assert got[key] == want[key], key
    assert got["wire"]["requests"]["tensor"] == 3 and got["requests"]["ingest"] > 0
    assert _without(got["bank_capacity"], ("kernel",)) == _without(want["bank_capacity"], ("kernel",))
    assert got["bank_capacity"]["dtype"] == "int8" and got["bank_capacity"]["quantize_fallbacks"] == {}


def test_events_and_series_families_match_jax(served):
    _, jax, port, _, _ = served
    strip = ("seq", "wall", "mono", "trace_id", "replica")
    got = [_without(e, strip) for e in port["events"][1]["events"]]
    want = [_without(e, strip) for e in jax["events"][1]["events"]]
    assert got == want and [e["type"] for e in got] == ["drift.flagged", "drift.flagged", "adapt.recalibrate"]
    types, samples = parse_prometheus_text(port["metrics"][1])
    jax_types, jax_samples = parse_prometheus_text(jax["metrics"][1])
    fams = {n: t for n, t in types.items() if n.startswith(("gordo_stream_", "gordo_drift_", "gordo_model_stale",
                                                            "gordo_bank_weight", "gordo_bank_models_per",
                                                            "gordo_bank_quantize"))}
    jax_fams = {n: t for n, t in jax_types.items() if n in fams or n.startswith(("gordo_stream_", "gordo_drift_"))}
    assert fams == jax_fams and "gordo_push_published_total" not in types
    capacity = ("gordo_bank_weight_bytes", "gordo_bank_models_per_gb", "gordo_bank_quantize_fallback_total")
    assert sorted((n, lb, v) for n, lb, v in samples if n in capacity) == \
        sorted((n, lb, v) for n, lb, v in jax_samples if n in capacity)
    counters = {(n, tuple(sorted(lb.items()))): v for n, lb, v in samples
                if n.startswith("gordo_stream_") and types[n] == "counter"}
    jax_counters = {(n, tuple(sorted(lb.items()))): v for n, lb, v in jax_samples
                    if n.startswith("gordo_stream_") and jax_types[n] == "counter"}
    assert counters == jax_counters


# ---------------------------------------------------------------------- #
# fault points, default off
# ---------------------------------------------------------------------- #

FAULT_STEPS = [
    ("before", "GET", f"{P}/drift", None, {}),
    ("ingest_fault", *_json(f"{P}/m3-0/ingest", {"rows": [[0.1, 0.2, 0.3]], "timestamps": [BASE_TS + 9e4]})),
    ("refit_fault", *_json(f"{P}/adapt", {"mode": "refit", "targets": ["m3-0"]})),
    ("after", "GET", f"{P}/drift", None, {}),
]


@contextlib.contextmanager
def _armed(registry):
    registry.reset()
    registry.arm("stream.ingest", times=1)
    registry.arm("stream.refit", times=1)
    try:
        yield
    finally:
        registry.reset()


def test_fault_points_leave_counters_and_generation_untouched(roots):
    jax_root, port_root = roots
    with env_set(ENV):
        with _armed(jax_resilience):
            jax, _ = asyncio.run(_jax_run(jax_root, FAULT_STEPS))
        server = run_server(port_root, host="127.0.0.1", port=0, device="cpu", background=True)
    try:
        with _armed(port_resilience):
            port = {key: call(server.url, m, path, raw, h) for key, m, path, raw, h in FAULT_STEPS}
        generation = server.app.generation()
    finally:
        server.close()
    for got in (port, jax):
        assert got["ingest_fault"][0] == 500 and got["refit_fault"][0] == 500
        assert got["refit_fault"][1]["rolled_back"] is True and got["refit_fault"][1]["generation"] == 0
        # the ingest fault fired before any buffer moved: the counters stand
        assert _without(got["after"][1], ("stats", *CLOCK_KEYS)) == _without(got["before"][1], ("stats", *CLOCK_KEYS))
    assert sorted(port["refit_fault"][1]) == sorted(jax["refit_fault"][1])
    assert port["refit_fault"][1]["error"] == jax["refit_fault"][1]["error"]
    assert port["after"][1]["stats"] == jax["after"][1]["stats"] and port["after"][1]["stats"]["refit_failed"] == 1
    assert generation == 0 and port["after"][1]["rows_total"] == 0


def test_default_off_builds_nothing(roots):
    jax_root, port_root = roots
    steps = [("ingest", *_json(f"{P}/m3-0/ingest", {"rows": [[1, 2, 3]]})),
             ("adapt", *_json(f"{P}/adapt", {})),
             ("results", "GET", f"{P}/m3-0/results/stream?timeout=0", None, {}),
             ("drift", "GET", f"{P}/drift", None, {}),
             ("metrics", "GET", f"{P}/metrics", None, {})]
    off = {"GORDO_STREAM": None, "GORDO_PUSH": "1", "GORDO_SERVER_WARMUP": "0"}
    with env_set(off):
        jax, _ = asyncio.run(_jax_run(jax_root, steps))
        server = run_server(port_root, host="127.0.0.1", port=0, device="cpu", background=True)
    try:
        port = {key: call(server.url, m, path, raw, h) for key, m, path, raw, h in steps}
        assert server.app.stream is None
    finally:
        server.close()
    for key in ("ingest", "adapt", "results", "drift"):
        assert port[key] == jax[key], key
    assert port["ingest"] == (404, {"error": "streaming plane not enabled (GORDO_STREAM=0)"})
    assert port["drift"] == (200, {"enabled": False})
    for text in (port["metrics"][1], jax["metrics"][1]):
        assert not any(f in text for f in ("gordo_stream_", "gordo_drift_", "gordo_push_", "gordo_model_staleness"))


# ---------------------------------------------------------------------- #
# the port alone
# ---------------------------------------------------------------------- #


def test_refit_keeps_warm_weights_at_zero_rate_and_advances_the_generation(served, monkeypatch):
    server, *_ = served
    app = server.app
    plane = app.stream
    name = SHIFTED[0]
    before = app.collection.models[name].to_entry(name).params
    generation = app.generation()

    class ZeroRate(port_fleet.FleetTrainer):
        def __init__(self, **kwargs):
            super().__init__(**{**kwargs, "learning_rate": 0.0})

    with monkeypatch.context() as patch:
        patch.setattr(port_fleet, "FleetTrainer", ZeroRate)
        body = plane.adapt("refit", targets=[name])
    det = app.collection.models[name]
    assert body["applied"] and body["members"] == [name] and body["swap"]["generation"] == generation + 1
    assert det.threshold_method_ == "incremental-refit"
    after = det._final_estimator.params_
    assert sorted(after) == sorted(before)
    for k, v in before.items():
        assert np.asarray(after[k], np.float32).tobytes() == np.asarray(v, np.float32).tobytes(), k
    body = plane.adapt("refit", targets=[name])
    assert body["swap"]["generation"] == generation + 2 and plane.stats["refit_members"] == 2
    moved = app.collection.models[name]._final_estimator.params_
    assert any(not np.array_equal(moved[k], after[k]) for k in after)
    assert app.collection.metadata[name]["online-adaptation"]["threshold-method"] == "incremental-refit"
    assert name in app.bank  # the refit detector is banked in the new generation


def test_flagged_members_get_drift_spans(served):
    server, *_ = served
    traces = [t for t in server.app.tracer.recent(None) if t.name == "drift_eval"]
    spans = {s.name for t in traces for s in t.spans}
    assert {f"drift:{n}" for n in SHIFTED} <= spans


def test_client_ingest_json_and_tensor_against_both_servers(roots, served):
    server, *_ = served
    jax_root, _ = roots
    prov = PortProvider(freq="10s", noise=0.1, seed=6)
    frame = prov.frame(T_LIVE, 10, TAGS3)

    def stamped(tensor):
        # ahead of every watermark of the sequence: each call's rows are fresh
        ns = (BASE_TS + 1e5 * (1 + tensor)) * 1e9 + np.arange(10) * 1e10
        return type(frame)(frame.values, ns.astype("int64").astype("datetime64[ns]"), frame.columns)

    async def against_jax(client):
        url = str(client.make_url("")).rstrip("/")
        out = {}
        for tensor in (False, True):
            c = PortClient("p", base_url=url, batch_size=4)
            out[tensor] = await c.ingest_async("m3-2", stamped(tensor), tensor=tensor)
        return out

    with env_set(ENV):
        _, jax = asyncio.run(_jax_run(jax_root, [], against_jax))
    for tensor in (False, True):
        c = PortClient("p", base_url=server.url, batch_size=4)
        got = c.ingest("m3-2", stamped(tensor), tensor=tensor)
        assert got == jax[tensor] == {"accepted": 10, "late": 0, "dropped": 0, "chunks": 3}
        assert c._ingest_stats == {"rows": got["accepted"], "chunks": 3}
        assert set(c.wire_stats) == {"ingest-tensor" if tensor else "ingest-json"}


def test_window_buffer_and_ingestor_match_jax_bitwise():
    rng = np.random.default_rng(4)
    port, jax = PortBuffer(8, 2, 10.0), JaxBuffer(8, 2, 10.0)
    batches = [
        (np.arange(5.0) + 100, rng.random((5, 2))),
        (np.array([101.5]), np.full((1, 2), 7.0)),
        (np.array([50.0]), np.zeros((1, 2))),
        (np.arange(12.0) + 110, rng.random((12, 2))),
        (np.array([115.0, 115.0, 200.0]), np.array([[0.5, np.nan], [0.5, np.nan], [1.0, 2.0]])),
        (np.arange(3.0) + 119, rng.random((3, 2))),
    ]
    batches.append((batches[3][0][-2:], batches[3][1][-2:]))  # a re-send of rows in the ring
    for ts, vals in batches:
        assert port.add(ts, vals.astype(np.float32)) == jax.add(ts, vals.astype(np.float32))
        for a, b in zip(port.window() + port.clean_window(), jax.window() + jax.clean_window()):
            assert a.tobytes() == b.tobytes()
    for attr in ("rows_total", "late_rows", "dropped_rows", "duplicate_rows", "dropout_cells", "watermark"):
        assert getattr(port, attr) == getattr(jax, attr), attr
    for bad in ((np.array([np.nan]), np.zeros((1, 2))), (np.arange(2.0), np.zeros((3, 2))),
                (np.arange(2.0), np.zeros((2, 3)))):
        with pytest.raises(ValueError) as got:
            port.add(*bad)
        with pytest.raises(ValueError) as want:
            jax.add(*bad)
        assert str(got.value) == str(want.value)
    pi, ji = PortIngestor(capacity=16, lateness_s=5.0), JaxIngestor(capacity=16, lateness_s=5.0)
    for name, (ts, vals) in zip("abab", batches):
        got, want = pi.ingest(name, ts, vals), ji.ingest(name, ts, vals)
        assert got == want
    assert pi.totals() == ji.totals()


def test_concurrent_first_ingests_of_a_member_share_one_buffer(monkeypatch):
    """The port answers each request on its own thread: two first ingests
    of one member, racing through a slow buffer construction, both land in
    one buffer."""
    from gordo_components_torch.streaming import ingest as port_ingest

    class SlowBuffer(PortBuffer):
        def __init__(self, *args, **kwargs):
            time.sleep(0.05)  # both threads are past the lookup by now
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(port_ingest, "WindowBuffer", SlowBuffer)
    ingestor = PortIngestor(capacity=16, lateness_s=60.0)  # either order accepts every row
    rng = np.random.default_rng(6)
    batches = [(np.arange(4.0) + 100 + 10 * k, rng.random((4, 2)).astype(np.float32)) for k in range(2)]
    start = threading.Barrier(2)
    answers = []

    def deliver(ts, vals):
        start.wait()
        answers.append(ingestor.ingest("m", ts, vals))

    threads = [threading.Thread(target=deliver, args=b) for b in batches]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert [a["accepted"] for a in answers] == [4, 4]
    assert list(ingestor.buffers) == ["m"] and len(ingestor.buffers["m"]) == 8
    assert ingestor.totals()["rows_total"] == 8


def test_adaptation_reset_waits_for_a_sweep_in_flight():
    """An adaptation forgets its members' EWMA under the sweeps' lock: a
    sweep in flight writes first, and the reset then clears what it wrote."""
    from gordo_components_torch.streaming.drift import DriftDetector, MemberDrift

    detector = DriftDetector(app=None, ingestor=PortIngestor())
    st = detector.members["m"] = MemberDrift()
    st.ewma_total, st.drift_score, st.drifted = 5.0, 2.5, True
    with detector._eval_lock:  # a sweep in flight
        reset = threading.Thread(target=detector.reset_members, args=(["m"],))
        reset.start()
        reset.join(0.1)
        assert reset.is_alive()
        st.ewma_total, st.drift_score = 6.0, 3.0  # the sweep's write
    reset.join(10)
    assert (st.ewma_total, st.drift_score, st.drifted) == (None, None, False)
    assert detector.drifted_members() == []


@pytest.mark.parametrize("drift", [None, dict(mean_shift=2.0, var_inflation=3.0, dropout_p=0.1, late_fraction=0.2,
                                              duplicate_p=0.1, tags=["tag-1"])])
def test_simulated_provider_matches_jax_bitwise(drift):
    port, jax = PortProvider(freq="10s", noise=0.1, seed=5), JaxProvider(freq="10s", noise=0.1, seed=5)
    if drift:
        port.inject(**drift)
        jax.inject(**drift)
    for got, want in ((port.batch(T_LIVE, 60, TAGS3), jax.batch(pd.Timestamp(T_LIVE), 60, TAGS3)),):
        assert got[0].tobytes() == want[0].tobytes() and got[1].tobytes() == want[1].tobytes()
    got = list(port.stream(T_LIVE, 150, TAGS5, chunk_rows=32))
    want = list(jax.stream(pd.Timestamp(T_LIVE), 150, TAGS5, chunk_rows=32))
    assert len(got) == len(want)
    for (gt, gv), (wt, wv) in zip(got, want):
        assert gt.tobytes() == wt.tobytes() and gv.tobytes() == wv.tobytes()
    frame, jframe = port.frame(T_TRAIN, 40, TAGS3), jax.frame(pd.Timestamp(T_TRAIN), 40, TAGS3)
    assert frame.values.tobytes() == jframe.to_numpy().tobytes() and frame.columns == list(jframe.columns)
    assert np.array_equal(frame.index, jframe.index.values.astype("datetime64[ns]"))


# ---------------------------------------------------------------------- #
# documented divergences
# ---------------------------------------------------------------------- #


def test_divergence_loops_are_threads_under_the_reload_lock(roots, monkeypatch):
    """The JAX plane's auto and push loops are asyncio tasks and its
    adaptations hold an asyncio lock; the port's server is threaded: the
    loops are daemon threads with a stop event, started with the app and
    stopped by ``App.close``, and an adaptation holds ``app.reload_lock``."""
    _, port_root = roots
    for k, v in {**ENV, "GORDO_STREAM_ADAPT": "auto", "GORDO_PUSH": "1", "GORDO_STREAM_INTERVAL_S": "3600"}.items():
        monkeypatch.setenv(k, v)
    server = run_server(port_root, host="127.0.0.1", port=0, device="cpu", background=True)
    try:
        plane = server.app.stream
        threads = sorted(t.name for t in plane._threads)
        assert threads == ["gordo-stream-adapt", "gordo-stream-push"]
        assert all(t.daemon and t.is_alive() for t in plane._threads)
        done = threading.Event()
        with server.app.reload_lock:
            worker = threading.Thread(target=lambda: (plane.adapt("recalibrate", targets=["m3-0"]), done.set()))
            worker.start()
            time.sleep(0.3)
            assert not done.is_set()  # waiting on the lock /reload takes
        worker.join(30)
        assert done.is_set()
        running = list(plane._threads)
    finally:
        server.close()
    assert not any(t.is_alive() for t in running) and plane._threads == []


def test_divergence_iso_stamps_read_by_times_to_ns(roots, served):
    """ISO 8601 stamps are read with ``dataset/times.to_ns`` where the JAX
    server asks ``pd.to_datetime``: the same seconds for ISO 8601 (offsets
    and fractions too), a 400 for the free-form dates pandas also reads."""
    server, *_ = served
    # ahead of the sequence's watermarks, so the answer's is these stamps'
    stamps = ["2036-08-02T00:00:00Z", "2036-08-02 01:00:00.5+01:00", "2036-08-02T00:00:01.123456789"]
    want = pd.to_datetime(stamps, utc=True, format="ISO8601").as_unit("ns").asi8 / 1e9
    got = np.array([to_ns(s) for s in stamps], np.int64) / 1e9
    assert got.tobytes() == want.tobytes()
    status, body = call(server.url, *_json(f"{P}/m3-3/ingest", {"rows": [[0.1, 0.2, 0.3]] * 3,
                                                                 "timestamps": stamps}))
    assert status == 200 and body["watermark"] == float(want.max())
    free_form = "Aug 2 2026"
    assert pd.to_datetime([free_form], utc=True).asi8[0] > 0  # pandas reads it
    status, body = call(server.url, "POST", f"{P}/m3-3/ingest",
                        json.dumps({"rows": [[0.1, 0.2, 0.3]], "timestamps": [free_form]}).encode(),
                        {"Content-Type": "application/json"})
    assert status == 400 and body == {"error": f"not an ISO 8601 timestamp: {free_form!r}"}
