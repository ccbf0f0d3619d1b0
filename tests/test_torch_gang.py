"""Gang worker threads and the member-width cap of the port, on the CPU.

- ``resolve_gang_width``, ``resolve_fleet_width`` (an injected sweep and a
  temporary cache: both packages write the same JSON table and sweep once)
  and the cap's chunk split give the JAX package's answers for the same
  environment and inputs (but ``GORDO_GANG_WIDTH=auto``: the port's is 1).
- ``build_fleet`` of three small heterogeneous gangs (dense, LSTM and conv
  machines) at ``GORDO_GANG_WIDTH`` 1 and 3 writes bitwise the same
  parameters, scalers and thresholds, with torch's global generator seeded
  differently before each build, and every group has its ``fit:`` span in
  ``build_trace.json`` whichever thread trained it.
- A fault at ``fleet_build.group`` under width 3 fails exactly one group,
  which lands in ``failed`` while the others build, and a fault spec fired
  from 16 threads spends each of its ``times`` once.
"""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from gordo_components_torch import resilience
from gordo_components_torch.resilience.faults import FaultSpec
from gordo_components_torch.builder import build_fleet
from gordo_components_torch.builder import fleet_build as port_fb
from gordo_components_torch.parallel import FleetTrainer
from gordo_components_torch.parallel import autotune as port_at
from gordo_components_torch.workflow import Machine
from gordo_components_tpu.builder import fleet_build as jax_fb
from gordo_components_tpu.parallel import FleetTrainer as JaxFleetTrainer
from gordo_components_tpu.parallel import autotune as jax_at

_DET = "gordo_components_torch.models.DiffBasedAnomalyDetector"


def _model(estimator, **kw):
    return {_DET: {"base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
        "sklearn.preprocessing.MinMaxScaler", {f"gordo_components_torch.models.{estimator}": kw}]}}}}


GANGS = {
    "dense": _model("AutoEncoder", kind="feedforward_symmetric", dims=[4], epochs=2, batch_size=32),
    "lstm": _model("LSTMAutoEncoder", kind="lstm_hourglass", lookback_window=4, epochs=2, batch_size=16),
    "conv": _model("ConvAutoEncoder", lookback_window=4, epochs=2, batch_size=16),
}


def _machines():
    out = []
    for gang, model in GANGS.items():
        for i in range(2):
            name = f"{gang}-{i}"
            out.append(Machine(name=name, model=model, dataset={
                "type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00Z",
                "train_end_date": "2020-01-01T06:00:00Z", "tag_list": [f"{name}-a", f"{name}-b"]}))
    return out


@pytest.mark.parametrize("n_groups", [0, 1, 2, 3, 10])
def test_resolve_gang_width_matches_jax(n_groups, monkeypatch):
    for raw in ("1", "2", "3", "7", " 4 "):
        monkeypatch.setenv("GORDO_GANG_WIDTH", raw)
        assert port_fb.resolve_gang_width(n_groups) == jax_fb.resolve_gang_width(n_groups)
    for raw in (None, "", "auto", "AUTO"):
        if raw is None:
            monkeypatch.delenv("GORDO_GANG_WIDTH", raising=False)
        else:
            monkeypatch.setenv("GORDO_GANG_WIDTH", raw)
        # the tests' JAX has 8 virtual devices, its accelerator-host case,
        # min(4, n); the port's auto is serial on every device (its
        # threads built small gangs slower on an H100)
        assert jax_fb.resolve_gang_width(n_groups) == min(4, max(1, n_groups))
        assert port_fb.resolve_gang_width(n_groups) == 1
    for raw in ("0", "-2", "two"):
        monkeypatch.setenv("GORDO_GANG_WIDTH", raw)
        with pytest.raises(ValueError) as want:
            jax_fb.resolve_gang_width(n_groups)
        with pytest.raises(ValueError) as got:
            port_fb.resolve_gang_width(n_groups)
        assert str(got.value) == str(want.value)
    assert port_fb.GANG_SMALL_MAX == jax_fb.GANG_SMALL_MAX == 32


def test_resolve_fleet_width_matches_jax(tmp_path, monkeypatch):
    for raw, want in ((None, None), ("", None), ("off", None), ("OFF", None), ("64", 64), (" 4096 ", 4096)):
        if raw is None:
            monkeypatch.delenv("GORDO_FLEET_WIDTH", raising=False)
        else:
            monkeypatch.setenv("GORDO_FLEET_WIDTH", raw)
        assert port_at.resolve_fleet_width("a:b") == jax_at.resolve_fleet_width("a:b") == want
    for raw in ("0", "wide", "-3"):
        monkeypatch.setenv("GORDO_FLEET_WIDTH", raw)
        with pytest.raises(ValueError) as want:
            jax_at.resolve_fleet_width("a:b")
        with pytest.raises(ValueError) as got:
            port_at.resolve_fleet_width("a:b")
        assert str(got.value) == str(want.value)
    assert (port_at.SWEEP_WIDTHS, port_at.KNEE_DEFAULT) == (jax_at.SWEEP_WIDTHS, jax_at.KNEE_DEFAULT)

    # auto: one sweep, persisted in one table layout, then read back
    monkeypatch.setenv("GORDO_FLEET_WIDTH", "auto")
    tables = {}
    # the port keys its table by the device it is given, JAX by its backend's
    on = {"jax": {}, "port": {"device": "cpu"}}
    for name, mod in (("jax", jax_at), ("port", port_at)):
        monkeypatch.setattr(mod, "_process_cache", {})
        path = tmp_path / name / "fleet_width.json"
        monkeypatch.setenv("GORDO_FLEET_WIDTH_CACHE", str(path))
        sweeps = []

        def sweep(arch, sweeps=sweeps):
            sweeps.append(arch)
            return 1024, {"512": 1.5, "1024": 3.0}

        assert mod.resolve_fleet_width("LSTMAutoEncoder:lstm_hourglass", sweep=sweep, **on[name]) == 1024
        assert mod.resolve_fleet_width("LSTMAutoEncoder:lstm_hourglass", sweep=sweep, **on[name]) == 1024
        monkeypatch.setattr(mod, "_process_cache", {})  # a new process reads the file
        assert mod.resolve_fleet_width("LSTMAutoEncoder:lstm_hourglass", sweep=sweep, **on[name]) == 1024
        assert sweeps == ["LSTMAutoEncoder:lstm_hourglass"]
        tables[name] = json.loads(path.read_text())
        assert not [p for p in os.listdir(path.parent) if ".tmp." in p]
    assert tables["port"] == tables["jax"] == {
        "LSTMAutoEncoder:lstm_hourglass|cpu": {"width": 1024, "measured": {"512": 1.5, "1024": 3.0}}}

    # a corrupt table is swept over and rewritten
    monkeypatch.setattr(port_at, "_process_cache", {})
    path.write_text("{not json")
    assert port_at.resolve_fleet_width("x:y", sweep=lambda a: (512, {}), device="cpu") == 512
    assert json.loads(path.read_text())["x:y|cpu"]["width"] == 512


def test_calibrate_width_picks_by_the_jax_rules(monkeypatch):
    width, measured = port_at.calibrate_width("AutoEncoder:feedforward_hourglass", "cpu")
    assert width in port_at.SWEEP_WIDTHS and sorted(map(int, measured)) == list(port_at.SWEEP_WIDTHS)
    peak = max(measured.values())
    good = [w for w in port_at.SWEEP_WIDTHS if measured[str(w)] >= 0.9 * peak]
    assert width == (port_at.KNEE_DEFAULT if len(good) == len(port_at.SWEEP_WIDTHS) else min(good))


@pytest.mark.parametrize("n, cap", [(5, 2), (9, 4), (8, 4), (3, 8), (7, None), (1, 1)])
def test_width_cap_split_matches_jax(n, cap, monkeypatch):
    members = {f"m{i}": np.random.RandomState(i).rand(12, 3).astype("f4") for i in range(n)}
    if cap is None:
        monkeypatch.delenv("GORDO_FLEET_WIDTH", raising=False)
    else:
        monkeypatch.setenv("GORDO_FLEET_WIDTH", str(cap))
    kw = dict(kind="feedforward_symmetric", dims=(2,), epochs=1, batch_size=16)
    jax_trainer, port_trainer = JaxFleetTrainer(**kw), FleetTrainer(device="cpu", **kw)
    jax_trainer.fit(members)
    port_trainer.fit(members)
    chunks = [b["n_members"] for b in port_trainer.last_stats["buckets"]]
    assert chunks == [b["n_members"] for b in jax_trainer.last_stats["buckets"]]
    assert port_trainer.last_stats["width_cap"] == jax_trainer.last_stats["width_cap"] == cap
    assert chunks == [len(c) for c in port_at.split_widths(sorted(members), cap)]


def _artifacts(root):
    out = {}
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        if not os.path.isdir(d):
            continue
        for f in ("params.npz", "scalers.npz"):
            with np.load(os.path.join(d, f)) as z:
                out[(name, f)] = {k: z[k] for k in z.files}
        detector = json.load(open(os.path.join(d, "detector.json")))
        detector.pop("stamp")
        detector["digests"].pop("metadata.json")  # the metadata holds wall times
        out[(name, "detector.json")] = detector
    return out


def test_gang_threads_build_bitwise_the_serial_artifacts(tmp_path, monkeypatch):
    machines = _machines()
    built = {}
    for seed, width in ((0, "1"), (1, "3")):
        monkeypatch.setenv("GORDO_GANG_WIDTH", width)
        torch.manual_seed(seed)  # nothing on a group's path may draw from it
        out = tmp_path / f"w{width}"
        report = build_fleet(machines, str(out), device="cpu")
        assert sorted(report) == sorted(m.name for m in machines) and not report.failed
        assert report.gang_width == int(width)
        trace = json.load(open(out / "build_trace.json"))
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        fits = [e for e in events if str(e.get("name", "")).startswith("fit:")]
        assert len(fits) == len(GANGS), fits  # one bucket a gang, each with its span
        roots = [e for e in events if e.get("name") == "fleet_build"]
        assert roots and roots[0]["args"]["gang_width"] == int(width)
        built[width] = _artifacts(out)
    assert built["1"].keys() == built["3"].keys() and len(built["1"]) == 3 * len(machines)
    for key, want in built["1"].items():
        got = built["3"][key]
        if isinstance(want, dict) and key[1].endswith(".npz"):
            assert got.keys() == want.keys(), key
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=str((key, k)))
        else:
            assert got == want, key


def test_a_group_fault_under_gang_threads_fails_that_group_alone(tmp_path, monkeypatch):
    monkeypatch.setenv("GORDO_GANG_WIDTH", "3")
    machines = _machines()
    resilience.reset()
    try:
        resilience.arm("fleet_build.group", exc=OSError, times=1)
        report = build_fleet(machines, str(tmp_path / "out"), device="cpu", group_retries=0)
    finally:
        resilience.reset()
    assert report.gang_width == 3 and report.group_retries == 0
    failed_gangs = {name.rsplit("-", 1)[0] for name in report.failed}
    assert len(failed_gangs) == 1 and len(report.failed) == 2, report.failed
    assert all("OSError" in err for err in report.failed.values())
    assert sorted(report) == sorted(m.name for m in machines if m.name not in report.failed)


def test_a_fault_spec_spends_each_of_its_times_once_under_threads():
    spec = FaultSpec(exc=None, times=500)
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [spec.fire("s") for _ in range(100)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(before)
    assert not any(t.is_alive() for t in threads)
    assert (spec.fired, spec.remaining) == (500, 0)
