"""Gang heartbeats and build traces of the port (``workflow/gang_state.py``,
``build_fleet(state_dir=..., checkpoint_dir=...)`` and the CLI's
``build-fleet`` and ``checkpoint-prune``) against the JAX package's, on
the CPU.

- Each package reads the heartbeat file the other wrote; the protocol cases
  of JAX ``tests/test_gang_state.py`` (fields accumulate, stale and
  terminal phases, unreadable files skipped, an unwritable directory turns
  heartbeats off) run on the port.
- ``build_fleet(state_dir=...)`` ends ``done``, ``partial`` or ``failed``
  as JAX ``tests/test_gang_state.py:64-196`` does, with the trainer's epoch
  in the heartbeat on the way.
- ``build_trace.json`` holds one ``fit:`` span a bucket, its ``checkpoint``
  children (one a save) and its estimated ``compile`` span (epoch 0's
  warm-up: the port compiles no fleet programs, so it has no
  ``gordo_fleet_program_builds_total``); the builder's and the trainer's
  counters move.
- The CLI passes ``--checkpoint-dir``, ``--checkpoint-every``,
  ``--state-dir`` and ``--gang-id`` on, and ``checkpoint-prune`` prints
  what the JAX CLI prints.
"""

import json
import os
import time

import pytest
from click.testing import CliRunner

from gordo_components_torch.builder import build_fleet
from gordo_components_torch.cli import main
from gordo_components_torch.observability.metrics import get_registry
from gordo_components_torch.workflow import Machine
from gordo_components_torch.workflow import gang_state as port_gs
from gordo_components_tpu.cli.cli import gordo
from gordo_components_tpu.workflow import gang_state as jax_gs

PACKAGES = {"jax": jax_gs, "port": port_gs}


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
def test_each_package_reads_the_others_heartbeat(writer, reader, tmp_path):
    hb = PACKAGES[writer].GangHeartbeat(str(tmp_path), gang_id="gang-1")
    hb.update(phase="loading", n_machines=5)
    hb.update(phase="training", epoch=3, n_active=10)
    (s,) = PACKAGES[reader].read_gang_states(str(tmp_path))
    assert (s["gang_id"], s["phase"], s["epoch"], s["n_machines"], s["stale"]) == ("gang-1", "training", 3, 5, False)
    assert s["pid"] == os.getpid() and s["age_seconds"] >= 0
    hb.finish("partial", built=3, failed_members=2)
    with open(hb.path) as f:
        state = json.load(f)
    state["ts"] = time.time() - 3600
    with open(hb.path, "w") as f:
        json.dump(state, f)
    (s,) = PACKAGES[reader].read_gang_states(str(tmp_path), stale_after=1.0)
    assert s["phase"] == "partial" and not s["stale"]  # terminal: never stale


def test_stale_unreadable_and_unwritable(tmp_path):
    assert port_gs.TERMINAL_PHASES == jax_gs.TERMINAL_PHASES
    hb = port_gs.GangHeartbeat(str(tmp_path), gang_id="frozen")
    hb.update(phase="training", epoch=4)
    (tmp_path / "torn.json").write_text("{not json")
    (tmp_path / "list.json").write_text("[1, 2]")
    (s,) = port_gs.read_gang_states(str(tmp_path), stale_after=30.0)
    assert not s["stale"]
    time.sleep(0.15)
    (s,) = port_gs.read_gang_states(str(tmp_path), stale_after=0.1)
    assert s["stale"] and s["phase"] == "training" and s["age_seconds"] >= 0.1
    hb.update(phase="training", epoch=5)
    (s,) = port_gs.read_gang_states(str(tmp_path), stale_after=0.1)
    assert not s["stale"]
    assert port_gs.read_gang_states(str(tmp_path / "absent")) == []
    blocker = tmp_path / "file"
    blocker.write_text("x")
    dead = port_gs.GangHeartbeat(str(blocker / "sub"), gang_id="x")
    dead.update(phase="training")  # best effort: no raise, no file
    assert dead._disabled and not os.path.exists(dead.path)


DATA = {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00Z",
        "train_end_date": "2020-01-01T06:00:00Z"}


def _model(kind="feedforward_symmetric", epochs=3):
    return {"gordo_components_torch.models.DiffBasedAnomalyDetector": {"base_estimator": {
        "sklearn.pipeline.Pipeline": {"steps": ["sklearn.preprocessing.MinMaxScaler", {
            "gordo_components_torch.models.AutoEncoder": {
                "kind": kind, "dims": [4], "epochs": epochs, "batch_size": 16}}]}}}}


def _machine(name, model=None, **data):
    return Machine(name=name, dataset=dict(DATA, tag_list=[f"{name}-a", f"{name}-b"], **data),
                   model=model or _model())


def _state(state_dir):
    (s,) = port_gs.read_gang_states(str(state_dir))
    return s


def test_build_fleet_heartbeat_ends_done_with_its_epochs(tmp_path):
    seen = []
    real = port_gs.GangHeartbeat.update

    def spy(self, **kw):
        seen.append(dict(kw))
        return real(self, **kw)

    port_gs.GangHeartbeat.update = spy
    try:
        report = build_fleet([_machine("m-0"), _machine("m-1")], str(tmp_path / "out"),
                             state_dir=str(tmp_path / "state"), gang_id="g-0", device="cpu")
    finally:
        port_gs.GangHeartbeat.update = real
    s = _state(tmp_path / "state")
    assert sorted(report) == ["m-0", "m-1"]
    assert (s["gang_id"], s["phase"], s["built"], s["epoch"]) == ("g-0", "done", 2, 2)
    phases = [kw["phase"] for kw in seen if "phase" in kw]
    assert phases[:3] == ["starting", "loading", "training"] and phases[-2:] == ["building", "done"]
    assert [kw["epoch"] for kw in seen if kw.get("phase") == "training"] == [0, 1, 2]


def test_build_fleet_heartbeat_ends_partial_or_failed(tmp_path):
    bad = Machine(name="bad", dataset={"type": "NoSuchDataset"})
    report = build_fleet([_machine("m-0"), bad], str(tmp_path / "o1"), state_dir=str(tmp_path / "s1"),
                         gang_id="g-p", device="cpu")
    s = _state(tmp_path / "s1")
    assert list(report) == ["m-0"] and list(report.failed) == ["bad"]
    assert (s["phase"], s["built"], s["failed_members"]) == ("partial", 1, 1) and "error" in s
    build_fleet([bad], str(tmp_path / "o2"), state_dir=str(tmp_path / "s2"), gang_id="g-f", device="cpu")
    s = _state(tmp_path / "s2")
    assert (s["phase"], s["built"]) == ("failed", 0) and "NoSuchDataset" in s["error"]


def test_build_trace_has_a_fit_span_a_bucket_with_checkpoint_children(tmp_path):
    reg = get_registry()
    built = reg.counter("gordo_build_models_built_total", "", ("path",)).labels("fleet")
    before = built.get()
    # two buckets: 36 rows at batch 16 pad to 48 items, 72 rows to 96
    machines = [_machine("short", _model(epochs=4)),
                _machine("long", _model(epochs=4), train_end_date="2020-01-01T12:00:00Z")]
    ckdir = tmp_path / "ck"
    build_fleet(machines, str(tmp_path / "out"), checkpoint_dir=str(ckdir), checkpoint_every=2, device="cpu")
    with open(tmp_path / "out" / "build_trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    fits = sorted(e["name"] for e in spans if e["name"].startswith("fit:"))
    assert fits == ["fit:f2x48", "fit:f2x96"]
    for e in spans:
        if e["name"] == "checkpoint":
            assert e["args"]["epoch"] == 1 and not e["args"].get("error")
            # the save's pieces on the training thread; the first save of a
            # bucket waits for no writer
            pieces = ("generators_s", "wait_s", "commit_s", "copy_s", "host_state_s")
            assert all(e["args"][k] >= 0 for k in pieces), e["args"]
    # one save a bucket: after epoch 1 (epochs 0-3, every 2, none after the last)
    assert sum(e["name"] == "checkpoint" for e in spans) == 2
    assert all(e["args"]["epochs"] == 4 for e in spans if e["name"].startswith("fit:"))
    assert built.get() - before == 2
    # the port compiles no programs: "compile" is epoch 0's estimated warm-up,
    # and there is no program-build counter
    assert all(e["args"]["estimated"] for e in spans if e["name"] == "compile")
    assert reg.gauge("gordo_fleet_bucket_compile_seconds", "", ("bucket",)).labels("f2x48").get() >= 0
    assert reg.counter("gordo_fleet_bucket_epochs_total", "", ("bucket",)).labels("f2x96").get() >= 4
    assert "gordo_fleet_program_builds_total" not in reg._families
    assert os.listdir(ckdir) == []  # finished buckets clear their state
    root = [e for e in spans if e["name"] == "fleet_build"]
    assert root and root[0]["args"]["n_built"] == 2


def test_a_crashing_build_writes_its_trace_and_fails_its_heartbeat(tmp_path, monkeypatch):
    from gordo_components_torch.builder import fleet_build

    def boom(*a, **k):
        raise KeyboardInterrupt

    monkeypatch.setattr(fleet_build, "extract_fleetable", boom)
    with pytest.raises(KeyboardInterrupt):
        build_fleet([_machine("m-0")], str(tmp_path / "out"), state_dir=str(tmp_path / "s"), device="cpu")
    assert _state(tmp_path / "s")["phase"] == "failed"
    with open(tmp_path / "out" / "build_trace.json") as f:
        (root,) = [e for e in json.load(f)["traceEvents"] if e.get("name") == "fleet_build"]
    assert root["args"]["error"] is True


# ---------------------------------------------------------------------- #
# the CLI
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("option", ["--checkpoint-dir", "--state-dir"])
def test_build_fleet_passes_checkpoint_and_state_options_on(option, tmp_path, capsys, monkeypatch):
    seen = {}
    from gordo_components_torch import builder

    real = builder.build_fleet

    def capture(machines, output_dir, **kwargs):
        seen.update(kwargs)
        return real(machines, output_dir, **kwargs)

    monkeypatch.setattr(builder, "build_fleet", capture)
    path = tmp_path / "m.json"
    path.write_text(json.dumps([{"name": "m1", "dataset": dict(DATA, tag_list=["a", "b"]),
                                 "model": _model(epochs=5)}]))  # a save after epoch 2
    target = tmp_path / "target"
    rc = main(["--device", "cpu", "build-fleet", "--machines-file", str(path), "--output-dir",
               str(tmp_path / "o"), option, str(target), "--checkpoint-every", "3", "--gang-id", "g-cli"])
    assert rc == 0 and json.loads(capsys.readouterr().out)["built"] == {"m1": str(tmp_path / "o" / "m1")}
    assert seen["checkpoint_every"] == 3 and seen["gang_id"] == "g-cli"
    if option == "--checkpoint-dir":
        assert seen["checkpoint_dir"] == str(target) and os.listdir(target) == []
    else:
        assert seen["state_dir"] == str(target)
        assert (_state(target)["gang_id"], _state(target)["phase"]) == ("g-cli", "done")


def test_checkpoint_prune_prints_what_the_jax_cli_prints(tmp_path, capsys):
    outs = []
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        for key, age in (("a" * 24, 30), ("b" * 24, 0)):
            os.makedirs(root / key / "0")
            if age:
                old = time.time() - age * 86400
                os.utime(root / key, (old, old))
        args = ["checkpoint-prune", "--checkpoint-dir", str(root), "--older-than-days", "7"]
        if pkg == "jax":
            result = CliRunner().invoke(gordo, args)
            outs.append((result.exit_code, result.stdout.strip()))
        else:
            outs.append((main(args), capsys.readouterr().out.strip()))
        assert sorted(os.listdir(root)) == ["b" * 24]
    assert outs[0] == outs[1] == (0, "Pruned 1 stale checkpoint(s)")
    with pytest.raises(SystemExit) as exit_info:
        main(["checkpoint-prune"])
    assert exit_info.value.code == 2
