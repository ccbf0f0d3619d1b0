"""The port's game-day harness (``gameday/harness.py``, ``replica.py``)
against the JAX package's.

Fast legs (tier-1), held to JAX ``tests/test_gameday.py``'s ``TestChildEnv``,
``TestRunValidation`` and ``render_verdict_table``: the child
environments equal, but for the JAX child's ``JAX_PLATFORMS`` (the port's
replica is told its device on its command line instead); the runners, the
shapes and their boot order; the mesh of each shape; the verdict table
byte for byte for the same document; the unknown-scenario refusal.

The multi-process drills (replica subprocesses on the CPU and a live
watchman) are marked ``slow``, as JAX's ``TestGamedayE2E`` is; the
whole catalog runs on the card from ``chip_smoke.py``'s ``gameday`` step.
"""

import asyncio
import os
import sys

import pytest

from gordo_components_torch.gameday import harness as port_harness
from gordo_components_torch.gameday import replica as port_replica
from gordo_components_tpu.gameday import harness as jax_harness

# JAX's child pins JAX to the CPU in its environment; the port's child
# takes its device on the command line
JAX_ONLY = {"JAX_PLATFORMS"}

MESHES = [
    dict(n_replicas=3),
    dict(n_replicas=2, partitioned=False),
    dict(n_replicas=2, partitioned=False, replica_env={1: {"GORDO_FAULTS": "engine.queue=latency:0.25"}}),
    dict(n_replicas=2, common_env={"GORDO_STREAM": "1"}),
    dict(n_replicas=1, partitioned=False, common_env={"GORDO_FAULTS": "server.connection=reset,p=0.15,seed=11"}),
]


def _env(env):
    return {k: v for k, v in env.items() if k not in JAX_ONLY}


@pytest.mark.parametrize("kwargs", MESHES, ids=["partitioned3", "replicated", "per_replica_fault", "common_env",
                                                 "push"])
def test_child_environments_match_jax(kwargs, tmp_path, monkeypatch):
    # a parent's own faults and mesh identity must not leak into a child
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setenv("GORDO_FAULTS", "bank.score=error")
    monkeypatch.setenv("GORDO_MESH_REPLICA_ID", "7")
    port = port_harness.GamedayMesh(str(tmp_path), ["gd-0"], device="cpu", **kwargs)
    jax = jax_harness.GamedayMesh(str(tmp_path), ["gd-0"], **kwargs)
    for index in range(kwargs["n_replicas"]):
        want = jax._child_env(index)
        assert want["JAX_PLATFORMS"] == "cpu" and "JAX_PLATFORMS" not in port._child_env(index)
        assert _env(port._child_env(index)) == _env(want)
        assert port._child_env(index).get("GORDO_FAULTS") == kwargs.get("replica_env", {}).get(index, {}).get(
            "GORDO_FAULTS", kwargs.get("common_env", {}).get("GORDO_FAULTS"))


def test_the_child_command_names_the_port_replica_and_its_device(tmp_path, monkeypatch):
    seen = {}

    def fake_popen(cmd, env, stdout, stderr):
        seen.update(cmd=cmd, env=env)
        return None

    monkeypatch.setattr(port_harness.subprocess, "Popen", fake_popen)
    for device in ("cpu", "cuda"):
        mesh = port_harness.GamedayMesh(str(tmp_path), ["gd-0"], n_replicas=2, device=device)
        mesh.ports = [5591, 5592]
        mesh._spawn(1)
        assert seen["cmd"] == [sys.executable, "-m", "gordo_components_torch.gameday.replica", "--root",
                               str(tmp_path), "--port", "5592", "--device", device]
        assert seen["env"] == mesh._child_env(1)
    assert port_harness.GamedayMesh(str(tmp_path), ["gd-0"]).device == "cuda"


def test_the_replica_serves_on_the_device_it_is_given(monkeypatch):
    seen = {}

    def fake_run_server(root, **kwargs):
        seen.update(root=root, **kwargs)

    import gordo_components_torch.server as port_server

    monkeypatch.setattr(port_server, "run_server", fake_run_server)
    for argv, device in ((["--root", "/r", "--port", "1"], "cuda"),
                         (["--root", "/r", "--port", "1", "--device", "cpu"], "cpu")):
        monkeypatch.setattr(sys, "argv", ["replica", *argv])
        port_replica.main()
        assert seen == {"root": "/r", "host": "127.0.0.1", "port": 1, "device": device}


def test_runners_shapes_and_constants_match_jax():
    assert list(port_harness.RUNNERS) == list(jax_harness.RUNNERS)
    assert port_harness.SHAPE_ORDER == jax_harness.SHAPE_ORDER
    assert port_harness.GAMEDAY_SCHEMA == jax_harness.GAMEDAY_SCHEMA
    assert port_harness.N_FEATURES == jax_harness.N_FEATURES
    assert port_harness.__all__ == jax_harness.__all__


@pytest.mark.parametrize("shape", jax_harness.SHAPE_ORDER)
def test_each_shape_boots_the_jax_mesh(shape, tmp_path):
    port = port_harness._mesh_for(shape, str(tmp_path), ["gd-0", "gd-1"], "cpu")
    jax = jax_harness._mesh_for(shape, str(tmp_path), ["gd-0", "gd-1"])
    fields = ("members", "project", "n_replicas", "partitioned", "refresh_interval", "common_env", "replica_env")
    assert {f: getattr(port, f) for f in fields} == {f: getattr(jax, f) for f in fields}
    assert port.device == "cpu"
    with pytest.raises(ValueError, match="unknown mesh shape"):
        port_harness._mesh_for("nope", str(tmp_path), [], "cpu")


def test_scoring_body_is_the_jax_bytes():
    for kwargs in ({}, {"rows": 32, "seed": 2}):
        assert port_harness.scoring_body(**kwargs) == jax_harness.scoring_body(**kwargs)


def test_unknown_scenario_rejected_as_jax(tmp_path):
    with pytest.raises(ValueError) as port_exc:
        asyncio.run(port_harness.run_gameday(str(tmp_path), scenario_names=["nope"], device="cpu"))
    with pytest.raises(ValueError) as jax_exc:
        asyncio.run(jax_harness.run_gameday(str(tmp_path), scenario_names=["nope"]))
    assert str(port_exc.value) == str(jax_exc.value)
    assert "unknown scenario" in str(port_exc.value)
    assert os.listdir(tmp_path) == []  # refused before any member is trained


DOCS = [
    {"schema": jax_harness.GAMEDAY_SCHEMA, "scenarios": {
        "a_drill": {"passed": True, "detection_latency_s": 0.5, "non_200": 0, "recovery_s": 1.0, "failures": []},
        "b_drill": {"passed": False, "non_200": 3, "failures": ["3 non-200(s) > budget 0"]}}, "passed": False},
    {"schema": jax_harness.GAMEDAY_SCHEMA, "scenarios": {
        "replica_crash_restart": {"passed": True, "detection_latency_s": 12.345, "non_200": 0,
                                  "recovery_s": 3, "failures": []},
        "gray_failure_slow_replica": {"passed": False, "detection_latency_s": None, "non_200": "-",
                                      "failures": ["x" * 50, "never detected within 40 s"]},
        "thundering_herd": {}}, "passed": False},
    {"scenarios": {}},
]


@pytest.mark.parametrize("doc", DOCS, ids=["jax_suite", "mixed", "empty"])
def test_render_verdict_table_is_the_jax_bytes(doc):
    assert port_harness.render_verdict_table(doc) == jax_harness.render_verdict_table(doc)


def test_render_verdict_table_lists_every_scenario():
    table = port_harness.render_verdict_table(DOCS[0])
    assert "a_drill" in table and "b_drill" in table
    assert "PASS" in table and "FAIL" in table and "non-200" in table


# ---------------------------------------------------------------------- #
# the real thing: replica subprocesses on the CPU and a live watchman
# ---------------------------------------------------------------------- #


@pytest.mark.slow
def test_partitioned_mesh_drills_end_to_end(tmp_path):
    """JAX ``TestGamedayE2E``: one real mesh boot (2 replica subprocesses
    + live watchman), the SIGKILL crash/restart drill and the watchman
    transport partition, judged by detection, containment, causal event
    order and recovery."""
    names = ["replica_crash_restart", "watchman_partition"]
    doc = asyncio.run(port_harness.run_gameday(str(tmp_path), scenario_names=names, device="cpu"))
    assert doc["schema"] == port_harness.GAMEDAY_SCHEMA
    assert set(doc["scenarios"]) == set(names)
    for name, v in doc["scenarios"].items():
        assert v["passed"], (name, v["failures"])
        assert v["schema"] == "gordo.scenario-verdict/v1"
        assert v["detected"] and v["non_200"] == 0
    crash = doc["scenarios"]["replica_crash_restart"]
    assert crash["recovered"] and crash["routing_version_steps"] >= 2
    types = [e["type"] for e in crash["events"]]
    assert "mesh.replica_unreachable" in types and "mesh.replica_recovered" in types
    assert doc["passed"] and doc["cpu_count"] == os.cpu_count()
