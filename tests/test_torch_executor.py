"""The port's fleet executor (``workflow/executor.py``), its ``workflow run``
and the promotion gate (``gameday/gate.py``) against the JAX package's.

One small spec goes to both packages (2 dense machines in 1 bucket, 1
epoch; seeds made with numpy and ``train_core.member_generator``):

- the plan-only run: the same executed/cached/failed lists, step
  statuses and ``fleet_state.json`` step keys, and built detectors whose
  ``anomaly()`` answers agree within the port's build band (rtol 1e-4,
  atol 1e-5: ``tests/test_torch_build.py``), the port's fit given the
  JAX fit's initial parameters;
- each executor against a live server of its own package on the CPU:
  promote, an incremental re-run, a ``workflow.canary`` fault that rolls
  back, a no-signal window held and not cached, and a failed gate that
  blocks promote; the reports and the events (types, order, severities,
  fields) equal case by case;
- ``workflow run``'s exit codes and report against the JAX CLI's, plan-only
  and for an invalid spec;
- the gate: both packages' ``run_promotion_gate`` against one live port
  server, the documents equal once walls, latencies and counts are
  masked; the name-validation messages equal.
"""

import asyncio
import copy
import json
import os
import shutil
import threading
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest
import yaml
from click.testing import CliRunner

import gordo_components_tpu.observability.events as jax_events
from gordo_components_torch import resilience as port_resilience
from gordo_components_torch import serializer as port_serializer
from gordo_components_torch.cli import main
from gordo_components_torch.convert import feedforward_to_flax
from gordo_components_torch.gameday import gate as port_gate
from gordo_components_torch.models import lookup_factory, train_core
from gordo_components_torch.observability import events as port_events
from gordo_components_torch.parallel import fleet as port_fleet
from gordo_components_torch.server import run_server
from gordo_components_torch.workflow import FleetExecutor, compile_fleet
from gordo_components_tpu import resilience as jax_resilience
from gordo_components_tpu import serializer as jax_serializer
from gordo_components_tpu.cli.cli import gordo
from gordo_components_tpu.gameday import gate as jax_gate
from gordo_components_tpu.parallel import fleet as jax_fleet
from gordo_components_tpu.replay.verdict import finalize_verdict
from gordo_components_tpu.workflow import FleetExecutor as JaxFleetExecutor
from gordo_components_tpu.workflow import compile_fleet as jax_compile_fleet

PROJECT = "proj"
ARCH = dict(kind="feedforward_symmetric", dims=(4,))
_DS = {"type": "RandomDataset", "train_start_date": "2017-12-25 06:00:00Z", "train_end_date": "2017-12-25 18:00:00Z"}
_MODEL = {"gordo_components_tpu.models.DiffBasedAnomalyDetector": {"base_estimator": {"sklearn.pipeline.Pipeline": {
    "steps": ["sklearn.preprocessing.MinMaxScaler", {"gordo_components_tpu.models.AutoEncoder": {
        "kind": ARCH["kind"], "dims": list(ARCH["dims"]), "epochs": 1, "batch_size": 128,
        "learning_rate": 1e-2}}]}}}}
BAND = dict(rtol=1e-4, atol=1e-5)  # the port's build band (tests/test_torch_build.py)
ANOMALY_KEYS = ("tag-anomaly-scaled", "tag-anomaly-unscaled", "total-anomaly-scaled", "total-anomaly-unscaled")
GATE = ["replica_crash_restart", "gray_failure_slow_replica", "tenant_noisy_neighbor"]


def fleet_spec(rev=1, window_s=1.0, gameday_gate=None):
    """2 dense machines (3 tags each) in one bucket, a short canary window."""
    machines = [{"name": f"m-{i}", "dataset": dict(_DS, tag_list=[f"a{i}", f"b{i}", f"c{i}"]),
                 "metadata": {"rev": rev if i == 0 else 1}} for i in range(2)]
    fleet = {"canary": {"window_s": window_s, "poll_s": 0.05, "min_requests": 1}, "schedules": {"refit_every": "6h"}}
    if gameday_gate is not None:
        fleet["gameday"] = {"gate": list(gameday_gate)}
    return {"machines": machines, "globals": {"model": copy.deepcopy(_MODEL)}, "fleet": fleet}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The plan-only run of both executors over one spec, the port's fit
    seeded and the JAX fit given the same initial parameters."""
    root = tmp_path_factory.mktemp("executor")
    initial = {}
    port_fit, jax_fit = port_fleet.FleetTrainer.fit, jax_fleet.FleetTrainer.fit

    def seeded(self, members, member_hparams=None, initial_params=None):
        stack = train_core.StackedDense(lookup_factory("AutoEncoder", ARCH["kind"])(3, dims=ARCH["dims"]))
        states = stack.state_dicts(stack.init([train_core.member_generator(11, i) for i in range(len(members))]))
        initial.update(zip(members, states))
        return port_fit(self, members, member_hparams, initial_params=dict(zip(members, states)))

    def given(self, members, member_hparams=None, initial_params=None):
        return jax_fit(self, members, member_hparams,
                       initial_params={n: feedforward_to_flax(initial[n]) for n in members})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_fleet.FleetTrainer, "fit", seeded)
        mp.setattr(jax_fleet.FleetTrainer, "fit", given)
        port_ex = FleetExecutor(compile_fleet(fleet_spec(), PROJECT), str(root / "port"), device="cpu")
        port_report = port_ex.run()
        jax_ex = JaxFleetExecutor(jax_compile_fleet(fleet_spec(), PROJECT), str(root / "jax"))
        jax_report = jax_ex.run()
    return {"port": (port_ex, port_report), "jax": (jax_ex, jax_report), "root": root}


def _state(ex):
    with open(ex.state_path) as f:
        return json.load(f)


def test_plan_only_run_matches_jax(built):
    (port_ex, port), (jax_ex, jax) = built["port"], built["jax"]
    for key in ("executed", "cached", "failed", "blocked", "promoted", "rolled_back", "generation", "counts",
                "total_steps", "incremental_ratio"):
        assert port[key] == jax[key], key
    assert {s: v["status"] for s, v in port["steps"].items()} == {s: v["status"] for s, v in jax["steps"].items()}
    assert port["executed"] == ["build/m-0", "build/m-1", "bucket/gang-f3-0"]
    assert port["steps"]["promote/fleet"]["status"] == "planned" and not port["failed"]
    ps, js = _state(port_ex), _state(jax_ex)
    assert ps["schema"] == js["schema"] and ps["generation"] == js["generation"] == 0
    assert {s: r["key"] for s, r in ps["steps"].items()} == {s: r["key"] for s, r in js["steps"].items()}
    assert ps["placement"] == js["placement"]
    X = np.random.default_rng(3).random((20, 3)).astype("f4")
    for name in ("m-0", "m-1"):
        got = port_serializer.load(os.path.join(port_ex.artifact_dir, name), device="cpu")
        want = jax_serializer.load(os.path.join(jax_ex.artifact_dir, name))
        frame = want.anomaly(pd.DataFrame(X, columns=want.tags_))
        answer = got.anomaly(X)
        for key in ANOMALY_KEYS:
            np.testing.assert_allclose(answer[key], np.squeeze(frame[key].to_numpy()), **BAND, err_msg=key)


# ---------------------------------------------------------------------- #
# live: each executor against a server of its own package
# ---------------------------------------------------------------------- #


class _JaxServer:
    """The JAX aiohttp app on a loopback port in a daemon thread (the
    executor is a sync control-plane client)."""

    def __init__(self, collection_dir):
        from aiohttp import web

        from gordo_components_tpu.server import build_app

        self.web = web
        self.loop = asyncio.new_event_loop()
        self.app = build_app(collection_dir, devices=1)
        self.url = None
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        assert self._started.wait(60), "server failed to start"

    def _run(self):
        asyncio.set_event_loop(self.loop)

        async def go():
            self.runner = self.web.AppRunner(self.app)
            await self.runner.setup()
            site = self.web.TCPSite(self.runner, "127.0.0.1", 0)
            await site.start()
            self.url = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
            self._started.set()

        self.loop.create_task(go())
        self.loop.run_forever()

    def close(self):
        async def bye():
            await self.runner.cleanup()
            self.loop.stop()

        asyncio.run_coroutine_threadsafe(bye(), self.loop)
        self._thread.join(10)


def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, None


def _traffic(codes):
    X = np.random.RandomState(0).rand(8, 3).tolist()

    def hook(url):
        codes.append(_post(f"{url}/gordo/v0/{PROJECT}/m-0/anomaly/prediction", {"X": X})[0])

    return hook


def _served_rev(url):
    with urllib.request.urlopen(f"{url}/gordo/v0/{PROJECT}/m-0/metadata", timeout=10) as resp:
        return json.loads(resp.read())["endpoint-metadata"]["user-defined"]["rev"]


def _rigged_gate(base_url, project, scenarios=None, **kw):
    verdict = finalize_verdict({"scenario": "replica_crash_restart", "non_200": 3},
                               ["3 non-200(s) during the swap window"])
    return {"schema": port_gate.GATE_SCHEMA, "base_url": base_url,
            "scenarios": {"replica_crash_restart": verdict}, "passed": False}


def _event_fields(event):
    """What both logs must agree on: type, severity, generation and the
    attributes (a verdict's sample count and a healthy verdict's reason
    read the poll loop's timing, so they are kept out)."""
    attrs = dict(event["attrs"])
    attrs.pop("samples", None)
    if attrs.get("decision") == "promote":
        attrs.pop("reason")
    return event["type"], event["severity"], event["generation"], attrs


def _report_fields(report):
    return {"executed": report["executed"], "cached": report["cached"], "failed": report["failed"],
            "blocked": report["blocked"], "promoted": report["promoted"], "rolled_back": report["rolled_back"],
            "generation": report["generation"], "decision": (report["canary"] or {}).get("decision"),
            "statuses": {s: v["status"] for s, v in report["steps"].items()}}


def _rollout(package, built, root, monkeypatch):
    """The five cases, in order, on one live server of ``package`` and
    one state dir; (report fields, events, codes, served revs) a case."""
    ex0, _ = built[package]
    collection = root / f"{package}-collection"
    collection.mkdir()
    for name in os.listdir(ex0.artifact_dir):
        if os.path.isdir(os.path.join(ex0.artifact_dir, name)):
            shutil.copytree(os.path.join(ex0.artifact_dir, name), collection / name)
    if package == "port":
        server = run_server(str(collection), host="127.0.0.1", port=0, device="cpu", background=True)
        executor_cls, compile_, resilience, gate, log_mod = (FleetExecutor, compile_fleet, port_resilience,
                                                             port_gate, port_events)
    else:
        server = _JaxServer(str(collection))
        executor_cls, compile_, resilience, gate, log_mod = (JaxFleetExecutor, jax_compile_fleet, jax_resilience,
                                                             jax_gate, jax_events)
    monkeypatch.setattr(gate, "run_promotion_gate", _rigged_gate)
    extra = {"device": "cpu"} if package == "port" else {}

    def run(rev, hook=None, **spec_kw):
        log = log_mod.EventLog()
        previous = log_mod.set_event_log(log)
        try:
            report = executor_cls(compile_(fleet_spec(rev=rev, **spec_kw), PROJECT), str(root / f"{package}-state"),
                                  server_url=server.url, collection_dir=str(collection), register_dir=ex0.register_dir,
                                  traffic_hook=hook, **extra).run()
        finally:
            log_mod.set_event_log(previous)
        return _report_fields(report), [_event_fields(e) for e in log.events()]

    cases = {}
    try:
        codes = []
        cases["promote"] = (*run(1, _traffic(codes)), sorted(set(codes)), _served_rev(server.url))
        codes = []
        cases["rerun"] = (*run(2, _traffic(codes)), sorted(set(codes)), _served_rev(server.url))
        resilience.arm("workflow.canary", times=1)
        try:
            cases["fault"] = (*run(3), [], _served_rev(server.url))
        finally:
            resilience.reset()
        cases["held"] = (*run(3, window_s=0.3), [], _served_rev(server.url))
        cases["gate"] = (*run(4, _traffic([]), gameday_gate=["replica_crash_restart"]), [],
                         _served_rev(server.url))
    finally:
        server.close()
    return cases


@pytest.fixture(scope="module")
def rollouts(built):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GORDO_SERVER_WARMUP", "0")
        mp.setenv("GORDO_SLO_SAMPLE_S", "0.02")
        # availability only, as the JAX suite's live fixture: a first
        # call's latency would burn a latency objective on any canary
        mp.setenv("GORDO_SLO_OBJECTIVES", '[{"name": "availability", "target": 0.999}]')
        return {p: _rollout(p, built, built["root"], mp) for p in ("port", "jax")}


@pytest.mark.parametrize("case", ["promote", "rerun", "fault", "held", "gate"])
def test_rollout_case_reports_and_events_match_jax(rollouts, case):
    assert rollouts["port"][case] == rollouts["jax"][case]


def test_rollout_cases_do_what_they_say(rollouts):
    cases = rollouts["port"]
    promote, events, codes, rev = cases["promote"]
    assert promote["promoted"] and promote["decision"] == "promote" and codes == [200] and rev == 1
    assert [e[0] for e in events] == ["canary.verdict", "fleet.promote"]
    rerun, events, codes, rev = cases["rerun"]
    assert rerun["executed"] == ["build/m-0", "bucket/gang-f3-0", "place/fleet", "canary/fleet", "promote/fleet"]
    assert rerun["cached"] == ["build/m-1"] and rerun["generation"] == 2 and codes == [200] and rev == 2
    fault, events, _, rev = cases["fault"]
    assert fault["statuses"]["canary/fleet"] == "failed" and fault["rolled_back"] and not fault["promoted"]
    assert [e[:2] for e in events] == [("fleet.rollback", "error")] and rev == 2
    assert events[0][3]["reason"] == "mid-canary failure: FaultInjected: fault injected at 'workflow.canary'"
    held, events, _, _ = cases["held"]
    assert held["statuses"]["canary/fleet"] == "held" and held["statuses"]["promote/fleet"] == "blocked"
    assert held["decision"] == "no_signal" and "canary/fleet" not in held["cached"]
    gate, events, _, _ = cases["gate"]
    assert gate["statuses"]["gameday/fleet"] == "failed" and gate["statuses"]["promote/fleet"] == "blocked"
    assert not gate["promoted"] and gate["generation"] == 2
    assert [e[:2] for e in events] == [("canary.verdict", "info"), ("gameday.gate", "error")]


# ---------------------------------------------------------------------- #
# workflow run
# ---------------------------------------------------------------------- #


def _spec_file(path, spec):
    path.write_text(yaml.safe_dump(spec, sort_keys=False))
    return str(path)


def test_workflow_run_plan_only_exit_code_and_report_match_jax(built, tmp_path, capsys):
    spec = _spec_file(tmp_path / "spec.yaml", fleet_spec())
    common = ["workflow", "run", "-f", spec, "-p", PROJECT]
    rc = main(["--device", "cpu", *common, "--state-dir", str(tmp_path / "port"),
               "--model-register-dir", built["port"][0].register_dir])
    port = json.loads(capsys.readouterr().out)
    result = CliRunner().invoke(gordo, [*common, "--state-dir", str(tmp_path / "jax"),
                                        "--model-register-dir", built["jax"][0].register_dir])
    jax = json.loads(result.stdout)
    assert rc == result.exit_code == 0
    assert sorted(port) == sorted(jax)
    assert _report_fields(port) == _report_fields(jax)
    assert port["executed"] == ["build/m-0", "build/m-1", "bucket/gang-f3-0"]


def test_workflow_run_exits_81_for_an_invalid_spec_as_jax(tmp_path, capsys):
    bad = fleet_spec()
    bad["fleet"]["canary"]["no_such_key"] = 1
    spec = _spec_file(tmp_path / "bad.yaml", bad)
    args = ["workflow", "run", "-f", spec, "-p", PROJECT, "--state-dir", str(tmp_path / "s")]
    rc = main(args)
    err = capsys.readouterr().err
    result = CliRunner().invoke(gordo, args)
    assert rc == result.exit_code == 81
    assert err == result.stderr and err.startswith("Invalid fleet spec: ")
    # a server URL without its collection dir is the same config error
    args += ["--server-url", "http://127.0.0.1:1"]
    spec_ok = _spec_file(tmp_path / "ok.yaml", fleet_spec())
    args[3] = spec_ok
    rc = main(args)
    err = capsys.readouterr().err
    result = CliRunner().invoke(gordo, args)
    assert rc == result.exit_code == 81 and err == result.stderr


def test_workflow_run_pairs_repeated_replica_options(built, tmp_path, capsys, monkeypatch):
    """The port takes one ``--server-url``/``--collection-dir`` pair a
    replica (the JAX CLI one replica); counts that differ are a config
    error."""
    seen = {}

    def fake_run(self):
        seen["replicas"] = self.replicas
        return {"failed": [], "executed": []}

    import gordo_components_torch.workflow.executor as port_executor

    monkeypatch.setattr(port_executor.FleetExecutor, "run", fake_run)
    spec = _spec_file(tmp_path / "spec.yaml", fleet_spec())
    base = ["--device", "cpu", "workflow", "run", "-f", spec, "-p", PROJECT, "--state-dir", str(tmp_path / "s")]
    pairs = ["--server-url", "http://a:1", "--collection-dir", "/a", "--server-url", "http://b:2",
             "--collection-dir", "/b"]
    assert main(base + pairs) == 0
    assert seen["replicas"] == [("http://a:1", "/a"), ("http://b:2", "/b")]
    capsys.readouterr()
    assert main(base + pairs[:-2]) == 81
    assert "2 --server-url against 1 --collection-dir" in capsys.readouterr().err


# ---------------------------------------------------------------------- #
# the gate, both packages against one live port server
# ---------------------------------------------------------------------- #

_VARYING = {"wall_seconds", "probe_p95_ms", "probe_requests", "swap", "flood_statuses",
            "best_effort_admitted_delta", "shed_delta", "shed_on_best_effort_delta", "shed_precision"}


def _masked(doc):
    out = copy.deepcopy(doc)
    for verdict in out["scenarios"].values():
        for key in _VARYING & set(verdict):
            verdict[key] = type(verdict[key]).__name__
        if "probe_statuses" in verdict:
            verdict["probe_statuses"] = sorted(verdict["probe_statuses"])
    return out


@pytest.fixture(scope="module")
def gate_server(built):
    ex0, _ = built["port"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GORDO_SERVER_WARMUP", "0")
        mp.setenv("GORDO_SLO_OBJECTIVES", '[{"name": "availability", "target": 0.999}]')
        server = run_server(ex0.artifact_dir, host="127.0.0.1", port=0, device="cpu", background=True)
    yield server
    server.close()


def test_gate_document_matches_jax_against_one_port_server(gate_server):
    codes = []
    port = port_gate.run_promotion_gate(gate_server.url, PROJECT, GATE, traffic=_traffic(codes), settle_s=0.3)
    jax = jax_gate.run_promotion_gate(gate_server.url, PROJECT, GATE, traffic=_traffic(codes), settle_s=0.3)
    assert port["schema"] == "gordo.gameday-gate/v1" and port["passed"] and jax["passed"]
    assert list(port["scenarios"]) == list(jax["scenarios"]) == GATE
    for name in GATE:
        p, j = port["scenarios"][name], jax["scenarios"][name]
        assert (p["passed"], p["gate_mode"], p["failures"]) == (j["passed"], j["gate_mode"], j["failures"])
        assert p["probe_requests"] > 0 and p["non_200"] == 0
    assert _masked(port) == _masked(jax)
    assert port["scenarios"]["replica_crash_restart"]["swap"]["generation"] >= 1
    assert port["scenarios"]["tenant_noisy_neighbor"]["best_effort_admitted_delta"] > 0
    assert set(codes) == {200}


def test_gate_refuses_unknown_and_non_gate_scenarios_as_jax(gate_server):
    for names in (["nope"], ["migration_storm"]):
        with pytest.raises(ValueError) as port_exc:
            port_gate.run_promotion_gate(gate_server.url, PROJECT, names)
        with pytest.raises(ValueError) as jax_exc:
            jax_gate.run_promotion_gate(gate_server.url, PROJECT, names)
        assert str(port_exc.value) == str(jax_exc.value)


def test_gate_counts_a_scoring_fault_against_the_swap(gate_server):
    """A real ``bank.score`` fault under the reload drill: the server's
    own error counter convicts the swap (JAX
    ``test_injected_scoring_fault_fails_the_real_drill``)."""
    codes = []
    port_resilience.arm("bank.score", times=1000, exc=RuntimeError)
    try:
        doc = port_gate.run_promotion_gate(gate_server.url, PROJECT, ["replica_crash_restart"],
                                           traffic=_traffic(codes), settle_s=0.3)
    finally:
        port_resilience.reset()
    verdict = doc["scenarios"]["replica_crash_restart"]
    assert not doc["passed"] and not verdict["passed"] and verdict["non_200"] > 0
    assert any("non-200" in f for f in verdict["failures"]), verdict["failures"]
    assert codes and all(c >= 400 for c in codes), set(codes)
