"""The port's CLI (``gordo_components_torch/cli``) against the JAX package's
(through click's ``CliRunner``), on the CPU with ``--device cpu``.

The same configs give the same exit codes (0, 81, 82, 83, 84), the same
built and failed names in the fleet manifest, the same keys from
``--print-cv-scores``, and the same machine list from a machines file (the
default model config written in each package's class paths). Options that
are not ported exit 2, or 83 where ``build_fleet`` refuses them, as the JAX
CLI maps a ``NotImplementedError`` (``GORDO_FAULTS``, ``--checkpoint-dir``
and ``--state-dir`` are ported: ``test_torch_faults.py``,
``test_torch_checkpoint.py`` and ``test_torch_gang_state.py`` drive them). One subprocess run drives
``python -m gordo_components_torch.cli build-fleet`` on examples/fleet.yaml,
then ``run-server`` on the result: one anomaly POST per machine, held
against the built detector's ``anomaly()`` within atol=1e-5 (the band of
test_torch_build.py), then SIGTERM, a clean exit and a free port.
"""

import copy
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import gordo_components_torch.builder as port_builder
from gordo_components_torch import serializer
from gordo_components_torch.builder import FleetBuildReport
from gordo_components_torch.cli import main
from gordo_components_torch.dataset import get_dataset
from gordo_components_torch.workflow import DEFAULT_MODEL_CONFIG
from gordo_components_tpu.builder import fleet_build as jax_fleet_build
from gordo_components_tpu.cli.cli import gordo
from gordo_components_tpu.workflow.config import DEFAULT_MODEL_CONFIG as JAX_DEFAULT_MODEL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET_YAML = os.path.join(REPO, "examples", "fleet.yaml")
DATA = {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00Z",
        "train_end_date": "2020-01-01T06:00:00Z", "tag_list": ["a", "b"]}


def _detector(pkg, **kw):
    return {f"{pkg}.models.DiffBasedAnomalyDetector": {"base_estimator": {f"{pkg}.models.AutoEncoder": {
        "kind": "feedforward_symmetric", "dims": [4], "epochs": 1, "batch_size": 32, **kw}}}}


JAX, PORT = "gordo_components_tpu", "gordo_components_torch"


def _both(make):
    """A config as each package spells it: (JAX's, the port's)."""
    return make(JAX), make(PORT)


def run_jax(args, env=None):
    result = CliRunner().invoke(gordo, args, env=env)
    return result.exit_code, result.stdout


def run_port(args, capsys, env=None, monkeypatch=None):
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    rc = main(["--device", "cpu", *args])
    return rc, capsys.readouterr().out


# (exit code, model config of each package, data config)
BUILD_CASES = {
    "built": (0, lambda p: json.dumps(_detector(p)), DATA),
    "yaml model config": (0, lambda p: (
        f"{p}.models.DiffBasedAnomalyDetector:\n  base_estimator:\n    {p}.models.AutoEncoder:\n"
        "      kind: feedforward_symmetric\n      dims: [4]\n      epochs: 1\n"), DATA),
    "config does not parse": (81, lambda p: "{unclosed: [1, 2", DATA),
    "unknown class": (82, lambda p: json.dumps({"no.such.Class": {}}), DATA),
    "unknown dataset type": (82, lambda p: json.dumps(_detector(p)), dict(DATA, type="Nope")),
    "unknown kind": (82, lambda p: json.dumps(_detector(p, kind="nope")), DATA),
    "unexpected dataset argument": (83, lambda p: json.dumps(_detector(p)), dict(DATA, bogus=1)),
}


@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_build_exit_codes_match_jax(case, tmp_path, capsys, monkeypatch):
    want, make, data = BUILD_CASES[case]
    jax_model, port_model = _both(make)
    env = {"MACHINE_NAME": "m1", "DATA_CONFIG": json.dumps(data)}
    jax_rc, _ = run_jax(["build"], env=dict(env, MODEL_CONFIG=jax_model, OUTPUT_DIR=str(tmp_path / "jax")))
    rc, out = run_port(["build"], capsys, monkeypatch=monkeypatch,
                       env=dict(env, MODEL_CONFIG=port_model, OUTPUT_DIR=str(tmp_path / "port")))
    assert rc == jax_rc == want
    if want == 0:
        assert out.strip() == str(tmp_path / "port") and serializer.is_artifact_dir(out.strip())


@pytest.mark.parametrize("evaluation", [{"cross_validation": True, "n_splits": 2},
                                        {"cv_mode": "cross_val_only", "n_splits": 3}, {}], ids=str)
def test_print_cv_scores_matches_jax(evaluation, tmp_path, capsys):
    jax_model, port_model = _both(lambda p: json.dumps(_detector(p)))
    common = ["--name", "m1", "--data-config", json.dumps(DATA),
              "--evaluation-config", json.dumps(evaluation), "--print-cv-scores"]
    jax_rc, jax_out = run_jax(["build", *common, "--model-config", jax_model,
                               "--output-dir", str(tmp_path / "j")])
    rc, out = run_port(["build", *common, "--model-config", port_model, "--output-dir", str(tmp_path / "p")],
                       capsys)
    assert rc == jax_rc == 0
    got, want = json.loads(out.splitlines()[0]), json.loads(jax_out.splitlines()[0])
    assert set(got) == set(want)
    if want:
        assert set(got) == {"mean", "std", "per-fold"}
        assert len(got["per-fold"]) == len(want["per-fold"]) == evaluation["n_splits"]
    assert out.splitlines()[1] == str(tmp_path / "p")


def _machines_file(tmp_path, name, payload):
    path = tmp_path / name
    path.write_text(payload if isinstance(payload, str) else json.dumps(payload))
    return str(path)


def _fleet_machine(name, pkg, model=None, **extra):
    m = {"name": name, "dataset": dict(DATA, tag_list=[f"{name}-a", f"{name}-b"]), **extra}
    if model is not None:
        m["model"] = model(pkg)
    return m


GOOD = lambda p: _detector(p)  # noqa: E731
UNKNOWN = lambda p: {"no.such.Model": {}}  # noqa: E731
# (exit code, payload of each package, built names, failed names)
FLEET_CASES = {
    "all built": (0, lambda p: {"machines": [_fleet_machine("m1", p, GOOD), _fleet_machine("m2", p, GOOD)]},
                  ["m1", "m2"], []),
    "default model, a list": (0, lambda p: [_fleet_machine("m1", p)], ["m1"], []),
    "partial": (84, lambda p: {"machines": [_fleet_machine("m1", p, GOOD),
                                            _fleet_machine("bad", p, UNKNOWN)]}, ["m1"], ["bad"]),
    "nothing built": (83, lambda p: {"machines": [_fleet_machine("bad", p, UNKNOWN)]}, [], ["bad"]),
    "evaluation carried": (0, lambda p: {"machines": [_fleet_machine(
        "m1", p, GOOD, evaluation={"cross_validation": True, "n_splits": 2})]}, ["m1"], []),
    # globals are not merged by build-fleet: the unknown global model is ignored
    "globals ignored": (0, lambda p: {"machines": [_fleet_machine("m1", p, GOOD)],
                                      "globals": {"model": UNKNOWN(p), "dataset": {"type": "Nope"}}},
                        ["m1"], []),
}


@pytest.mark.parametrize("case", sorted(FLEET_CASES))
def test_build_fleet_exit_codes_and_manifest_match_jax(case, tmp_path, capsys):
    want, payload, built, failed = FLEET_CASES[case]
    jax_file = _machines_file(tmp_path, "jax.json", payload(JAX))
    port_file = _machines_file(tmp_path, "port.yaml", payload(PORT))
    jax_rc, jax_out = run_jax(["build-fleet", "--machines-file", jax_file,
                               "--output-dir", str(tmp_path / "j")])
    rc, out = run_port(["build-fleet", "--machines-file", port_file,
                        "--output-dir", str(tmp_path / "p")], capsys)
    assert rc == jax_rc == want
    manifest, jax_manifest = json.loads(out), json.loads(jax_out)
    for m in (manifest, jax_manifest):
        assert sorted(m["built"]) == built and sorted(m["failed"]) == failed
    with open(tmp_path / "p" / "build_manifest.json") as f:
        assert json.load(f) == manifest
    if case == "evaluation carried":
        cv = serializer.load_metadata(str(tmp_path / "p" / "m1"))["model"]["cross-validation"]
        assert len(cv["explained-variance"]["per-fold"]) == 2


@pytest.mark.parametrize("payload", ["{machines: []}\n", "[]\n", "just text\n", ""])
def test_build_fleet_empty_payload_exits_81_as_jax(payload, tmp_path, capsys):
    path = _machines_file(tmp_path, "m.yaml", payload)
    jax_rc, _ = run_jax(["build-fleet", "--machines-file", path, "--output-dir", str(tmp_path / "j")])
    rc, _ = run_port(["build-fleet", "--machines-file", path, "--output-dir", str(tmp_path / "p")], capsys)
    assert rc == jax_rc == 81


def test_build_fleet_reads_fleet_yaml_into_the_jax_machine_list(tmp_path, capsys, monkeypatch):
    seen = {}

    def capture(key, report_type):
        def fake(machines, output_dir, **kwargs):
            seen[key] = [copy.deepcopy(m.to_dict()) for m in machines]
            report = report_type()
            report.update({m.name: os.path.join(output_dir, m.name) for m in machines})
            return report
        return fake

    monkeypatch.setattr(jax_fleet_build, "build_fleet", capture("jax", jax_fleet_build.FleetBuildReport))
    monkeypatch.setattr(port_builder, "build_fleet", capture("port", FleetBuildReport))
    args = ["build-fleet", "--machines-file", FLEET_YAML, "--output-dir", str(tmp_path)]
    assert run_jax(args)[0] == 0
    assert run_port(args, capsys)[0] == 0
    for m in seen["jax"]:
        if m["model"] == JAX_DEFAULT_MODEL:
            m["model"] = copy.deepcopy(DEFAULT_MODEL_CONFIG)
    assert seen["port"] == seen["jax"]
    assert [m["name"] for m in seen["port"]] == ["compressor-a", "compressor-b", "turbine-lstm"]


NOT_PORTED = {
    "--profile-dir": (["--profile-dir", "p"], {}),
    "GORDO_PROFILE_DIR": ([], {"GORDO_PROFILE_DIR": "p"}),
    "--compile-cache-dir": (["--compile-cache-dir", "c"], {}),
    "GORDO_COMPILE_CACHE_DIR": ([], {"GORDO_COMPILE_CACHE_DIR": "c"}),
}


@pytest.mark.parametrize("name", sorted(NOT_PORTED))
def test_unported_global_options_exit_2_with_a_message(name, tmp_path, capsys, monkeypatch):
    """The JAX CLI's global options: the compile cache has no counterpart
    and exits 2. ``--profile-dir`` and ``GORDO_PROFILE_DIR``, refused until
    the profiler was ported, now reach the build as ``GORDO_PROFILE_DIR``,
    as the JAX CLI passes them on."""
    args, env = NOT_PORTED[name]
    # the CLIs set it in os.environ: setenv first records it for the restore
    monkeypatch.setenv("GORDO_PROFILE_DIR", "")
    monkeypatch.delenv("GORDO_PROFILE_DIR")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if "PROFILE" in name.upper():
        seen = {}

        def capture(key, report_type):
            def fake(machines, output_dir, **kwargs):
                seen[key] = os.environ.get("GORDO_PROFILE_DIR")
                return report_type({m.name: os.path.join(output_dir, m.name) for m in machines})
            return fake

        monkeypatch.setattr(jax_fleet_build, "build_fleet", capture("jax", jax_fleet_build.FleetBuildReport))
        monkeypatch.setattr(port_builder, "build_fleet", capture("port", FleetBuildReport))
        fleet = ["build-fleet", "--machines-file", FLEET_YAML, "--output-dir", str(tmp_path)]
        assert run_jax([*args, *fleet], env=env or None)[0] == 0
        assert main([*args, "--device", "cpu", *fleet]) == 0
        assert seen["port"] == seen["jax"] == "p"
        return
    with pytest.raises(SystemExit) as exit_info:
        main([*args, "--device", "cpu", "build-fleet", "--machines-file", FLEET_YAML,
              "--output-dir", str(tmp_path)])
    err = capsys.readouterr().err
    assert exit_info.value.code == 2 and ("not ported" in err or "no counterpart" in err)


def _dump_detector(path):
    """A two-tag dense detector artifact of random weights at ``path``."""
    from gordo_components_torch.convert import entry_from_numpy, params_to_flax
    from gordo_components_torch.models import lookup_factory

    rng = np.random.default_rng(0)
    kw = {"encoding_dim": (4,), "decoding_dim": (4,)}
    state = {k: rng.standard_normal(tuple(v.shape)).astype("f4")
             for k, v in lookup_factory("AutoEncoder", "feedforward_model")(2, **kw).state_dict().items()}
    ones, zeros = np.ones(2, np.float32), np.zeros(2, np.float32)
    entry = entry_from_numpy("m", "AutoEncoder", "feedforward_model", kw, 2, params_to_flax(state), zeros, ones,
                             zeros, ones)
    serializer.dump(entry, str(path))


def test_run_server_devices_2_clamps_to_the_devices_present_with_the_jax_warning(tmp_path, monkeypatch, caplog):
    """Once refused; ``--devices 2`` now reaches ``build_app``, which clamps
    it to the devices present (one CPU here) with the JAX warning."""
    seen = {}

    def fake_run_server(model_dir, **kwargs):
        from gordo_components_torch.server import build_app

        seen["devices"] = kwargs["devices"]
        seen["app"] = build_app(model_dir, device=kwargs["device"], devices=kwargs["devices"])
        seen["app"].close()

    import gordo_components_torch.server as port_server

    _dump_detector(tmp_path / "m")
    monkeypatch.setattr(port_server, "run_server", fake_run_server)
    with caplog.at_level("WARNING", logger="gordo_components_torch.server"):
        assert main(["--device", "cpu", "run-server", "--model-dir", str(tmp_path), "--devices", "2"]) == 0
    assert seen["devices"] == 2 and seen["app"].bank.mesh is None and seen["app"].bank.coverage()["devices"] == 1
    assert "GORDO_SERVER_DEVICES=2 but only 1 device(s) present; sharding the bank over 1" in caplog.text


@pytest.mark.parametrize("command", ["build", "build-fleet", "run-server", "run-watchman"])
def test_missing_required_option_exits_2_as_jax(command, capsys):
    assert run_jax([command])[0] == 2
    with pytest.raises(SystemExit) as exit_info:
        main(["--device", "cpu", command])
    assert exit_info.value.code == 2


@pytest.mark.parametrize("extra", [["--distributed"]], ids=str)
def test_build_fleet_refuses_unported_options_with_83(extra, tmp_path, capsys):
    path = _machines_file(tmp_path, "m.json", FLEET_CASES["all built"][1](PORT))
    assert main(["--device", "cpu", "build-fleet", "--machines-file", path,
                 "--output-dir", str(tmp_path / "o"), *extra]) == 83
    assert "not ported" in capsys.readouterr().err


@pytest.mark.parametrize("config", [
    {"{p}.models.AutoEncoder": {"epochs": 1}},
    {"sklearn.pipeline.Pipeline": {"steps": ["sklearn.preprocessing.MinMaxScaler", "{p}.models.AutoEncoder"]}},
], ids=["estimator", "pipeline"])
def test_non_detector_config_builds_like_jax(config, tmp_path, capsys):
    """A top-level config that is not a detector builds in both CLIs
    (exit 0); the port writes it as model.json."""
    jax_model, port_model = _both(lambda p: json.dumps(config).replace("{p}", p))
    common = ["build", "--name", "m", "--data-config", json.dumps(DATA)]
    jax_rc, _ = run_jax([*common, "--model-config", jax_model, "--output-dir", str(tmp_path / "j")])
    rc, out = run_port([*common, "--model-config", port_model, "--output-dir", str(tmp_path / "p")], capsys)
    assert rc == jax_rc == 0
    assert os.path.exists(os.path.join(out.strip(), "model.json"))


def test_default_device_is_the_card(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main(["build", "--name", "m", "--model-config", json.dumps(_detector(PORT)),
               "--data-config", json.dumps(DATA), "--output-dir", str(tmp_path)])
    assert rc == 83 and "CUDA is not available" in capsys.readouterr().err
    path = _machines_file(tmp_path, "m.json", FLEET_CASES["all built"][1](PORT))
    assert main(["build-fleet", "--machines-file", path, "--output-dir", str(tmp_path / "o")]) == 83


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, json.load(resp)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.load(resp)


def test_cli_builds_fleet_yaml_and_serves_it_in_subprocesses(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    cli = [sys.executable, "-m", "gordo_components_torch.cli", "--device", "cpu"]
    out = str(tmp_path / "out")
    proc = subprocess.run([*cli, "build-fleet", "--machines-file", FLEET_YAML, "--output-dir", out],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["n_built"] == 3
    port = _free_port()
    log = open(tmp_path / "server.log", "w")
    server = subprocess.Popen([*cli, "run-server", "--model-dir", out, "--host", "127.0.0.1",
                               "--port", str(port)], cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        base = f"http://127.0.0.1:{port}/gordo/v0/proj"
        deadline = time.time() + 120
        while True:
            try:
                status, models = _get(base + "/models")
                break
            except OSError:
                if time.time() > deadline or server.poll() is not None:
                    raise AssertionError(f"the server did not answer: {server.poll()}")
                time.sleep(0.2)
        assert status == 200 and models["models"] == ["compressor-a", "compressor-b", "turbine-lstm"]
        for name in models["models"]:
            X = get_dataset(_fleet_dataset(name)).get_data()[0].values
            status, body = _post(f"{base}/{name}/anomaly/prediction", {"X": X.tolist()})
            assert status == 200
            want = serializer.load(os.path.join(out, name), device="cpu").anomaly(X)
            np.testing.assert_allclose(body["data"]["total-anomaly-scaled"], want["total-anomaly-scaled"],
                                       rtol=0, atol=1e-5)
        server.send_signal(signal.SIGTERM)
        assert server.wait(timeout=60) == 0
        with socket.socket() as s:  # nothing listens there any more (a new server would bind)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", port))
            s.listen()
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
        log.close()


def _fleet_dataset(name):
    from gordo_components_torch.utils.yaml_subset import safe_load

    with open(FLEET_YAML) as f:
        return next(m["dataset"] for m in safe_load(f)["machines"] if m["name"] == name)
