"""The port's profiler (``utils/profiling.py``) on the CPU.

- ``maybe_profile`` is free without a directory, and with one writes a
  Chrome trace under ``<dir>/<name>/``, the name made safe as the JAX
  package's ``maybe_profile`` makes it (its ``jax.profiler.trace`` stubbed
  to read the directory it was given).
- Two captures that overlap on two threads both complete; a capture
  opened inside another on one thread is recorded by the outer one.
- Under ``GORDO_PROFILE_DIR`` a gang build on two gang threads writes each
  gang's ``fleet-gang-<n>m`` capture, a single build its ``build-<name>``,
  and a served request with a sampled ``traceparent`` gets a
  ``serve-<trace id>`` capture of its bank group, named by its
  ``device_execute`` span's ``profile`` attribute.
- ``device_memory_stats`` is empty on the CPU, as the JAX package's is.
"""

import contextlib
import glob
import json
import os
import threading
import time
import urllib.request

import pytest
import torch

from gordo_components_torch.builder import build_fleet
from gordo_components_torch.server import run_server
from gordo_components_torch.utils import profiling
from gordo_components_torch.workflow import Machine
from gordo_components_tpu.utils import profiling as jax_profiling

_DET = "gordo_components_torch.models.DiffBasedAnomalyDetector"


def _machine(name, dims, lookback=None):
    est = ({"gordo_components_torch.models.LSTMAutoEncoder": {"lookback_window": lookback, "epochs": 1,
                                                              "batch_size": 16}}
           if lookback else {"gordo_components_torch.models.AutoEncoder": {
               "kind": "feedforward_symmetric", "dims": dims, "epochs": 1, "batch_size": 32}})
    return Machine(name=name, model={_DET: {"base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
        "sklearn.preprocessing.MinMaxScaler", est]}}}}, dataset={
        "type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00Z",
        "train_end_date": "2020-01-01T04:00:00Z", "tag_list": [f"{name}-a", f"{name}-b"]})


def _traces(directory):
    return sorted(glob.glob(os.path.join(directory, "*.pt.trace.json")))


def _names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_off_is_free_and_on_writes_under_the_jax_layout(tmp_path, monkeypatch):
    monkeypatch.delenv("GORDO_PROFILE_DIR", raising=False)
    with profiling.maybe_profile("nothing"):
        pass
    assert os.listdir(tmp_path) == []
    seen = []

    @contextlib.contextmanager
    def stub(out):
        seen.append(out)
        yield

    import jax

    monkeypatch.setattr(jax.profiler, "trace", stub)
    name = "fleet gang/4 m:x"
    for root in (tmp_path / "env", tmp_path / "arg"):
        if root.name == "env":
            monkeypatch.setenv("GORDO_PROFILE_DIR", str(root))
            kw = {}
        else:
            monkeypatch.delenv("GORDO_PROFILE_DIR")
            kw = {"profile_dir": str(root)}
        with jax_profiling.maybe_profile(name, **kw):
            pass
        with profiling.maybe_profile(name, **kw):
            torch.ones(8, 8) @ torch.ones(8, 8)
        assert profiling.profile_path(name, str(root)) == seen[-1] == str(root / "fleet-gang-4-m-x")
        (trace,) = _traces(seen[-1])
        assert "aten::mm" in _names(trace)


def test_overlapping_captures_on_two_threads_both_complete(tmp_path):
    results = {}

    def capture(name):
        try:
            with profiling.maybe_profile(name, str(tmp_path)):
                torch.ones(16, 16) @ torch.ones(16, 16)
            results[name] = "ok"
        except Exception as exc:  # pragma: no cover - reported below
            results[name] = repr(exc)

    def first():
        try:
            with profiling.maybe_profile("outer-a", str(tmp_path)):
                started.set()
                torch.ones(4, 4).sum()
                asked.wait(30)  # the other thread's capture asks to start meanwhile
                time.sleep(0.1)
            results["outer-a"] = "ok"
        except Exception as exc:  # pragma: no cover - reported below
            results["outer-a"] = repr(exc)

    started, asked = threading.Event(), threading.Event()
    waiter = threading.Thread(target=lambda: (started.wait(30), asked.set(), capture("b")))
    a = threading.Thread(target=first)
    waiter.start()
    a.start()
    a.join(timeout=60)
    waiter.join(timeout=60)
    assert not a.is_alive() and not waiter.is_alive()
    assert results["outer-a"] == results["b"] == "ok", results
    assert len(_traces(tmp_path / "outer-a")) == len(_traces(tmp_path / "b")) == 1
    assert "aten::mm" in _names(_traces(tmp_path / "b")[0])


def test_a_nested_capture_is_recorded_by_the_outer_one(tmp_path, caplog):
    with profiling.maybe_profile("outer", str(tmp_path)):
        with profiling.maybe_profile("inner", str(tmp_path)):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert len(_traces(tmp_path / "outer")) == 1 and not os.path.exists(tmp_path / "inner")
    assert "aten::mm" in _names(_traces(tmp_path / "outer")[0])
    assert any("recorded there" in r.getMessage() for r in caplog.records)


def test_builds_and_a_bank_group_write_their_captures(tmp_path, monkeypatch):
    prof = tmp_path / "prof"
    monkeypatch.setenv("GORDO_PROFILE_DIR", str(prof))
    monkeypatch.setenv("GORDO_GANG_WIDTH", "2")
    monkeypatch.setenv("GORDO_TRACE_SAMPLE", "1")
    machines = [_machine("d0", [4]), _machine("d1", [4]), _machine("s0", [3]), _machine("l0", None, lookback=4),
                _machine("l1", None, lookback=4)]
    # a bare pipeline builds alone: its fit is a single build's capture
    machines.append(Machine(name="single", dataset=machines[0].dataset, model={
        "sklearn.pipeline.Pipeline": {"steps": ["sklearn.preprocessing.MinMaxScaler", {
            "gordo_components_torch.models.AutoEncoder": {"kind": "feedforward_symmetric", "dims": [2],
                                                          "epochs": 1}}]}}))
    report = build_fleet(machines, str(tmp_path / "models"), device="cpu")
    assert not report.failed and report.gang_width == 2
    assert sorted(os.listdir(prof)) == ["build-single", "fleet-gang-1m", "fleet-gang-2m"]
    assert len(_traces(prof / "fleet-gang-2m")) == 2 and len(_traces(prof / "fleet-gang-1m")) == 1
    assert len(_traces(prof / "build-single")) == 1
    assert profiling.device_memory_stats(torch.device("cpu")) == {} == jax_profiling.device_memory_stats()

    server = run_server(str(tmp_path / "models"), host="127.0.0.1", port=0, device="cpu", background=True)
    try:
        trace_id = "4bf92f3577b34da6a3ce929d0e0e4736"
        body = json.dumps({"X": [[0.1, 0.2]] * 4}).encode()
        req = urllib.request.Request(
            server.url + "/gordo/v0/proj/d0/anomaly/prediction", data=body, method="POST",
            headers={"Content-Type": "application/json", "traceparent": f"00-{trace_id}-00f067aa0ba902b7-01"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
        with urllib.request.urlopen(server.url + f"/gordo/v0/proj/traces?id={trace_id}", timeout=60) as resp:
            trace = json.loads(resp.read())
    finally:
        server.close()
    (answer,) = trace["traces"]
    (execute,) = [s for s in answer["spans"]["children"] if s["name"] == "device_execute"]
    assert execute["attributes"]["profile"] == str(prof / f"serve-{trace_id}")
    assert len(_traces(execute["attributes"]["profile"])) == 1
