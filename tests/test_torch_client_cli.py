"""The port's ``client`` commands against the JAX CLI's, on the CPU.

One port server (the bank, a Unix socket and the ring) serves two dense
detectors and an ``lstm_hourglass`` (lookback 8) built from seeded
weights, with ``RandomDataset`` metadata. The JAX CLI (click's
``CliRunner``) and the port's (``main``) run the same commands against it:

- ``client predict START END --parquet-dir D`` for each
  ``--body-encoding``: the same output lines and exit code, and parquet
  files that read back equal (``pd.read_parquet``, the port's reader);
  a failed target: exit code 1 and the same ``FAILED`` line;
- ``client metadata``: the same JSON;
- ``client download-model TARGET DEST``: the route's archive, the same
  output, exit code 1 for an unknown target;
- a time that does not parse: exit code 1 before any request;
- the usage errors (no project, an unknown encoding): exit code 2.

Every network wait has a timeout (the clients' own, 600 s at most; the
runs take a second or two).
"""

import io
import json
import os
import shutil
import tarfile
import tempfile
import urllib.request

import numpy as np
import pandas as pd
import pytest
from click.testing import CliRunner

from gordo_components_torch import serializer
from gordo_components_torch.cli.cli import main
from gordo_components_torch.convert import entry_from_numpy, lstm_to_flax
from gordo_components_torch.dataset.data_provider._parquet import read_parquet
from gordo_components_torch.models.factories.feedforward import hourglass_calc_dims
from gordo_components_torch.models.register import lookup_factory
from gordo_components_torch.server import run_server
from gordo_components_tpu.cli.cli import gordo

TAGS = [f"tag-{i}" for i in range(10)]
DATASET = {"type": "RandomDataset", "tag_list": TAGS, "resolution": "10min"}
NAMES = ["cli-dense-0", "cli-dense-1", "cli-lstm"]
START, END = "2020-01-01T00:00:00Z", "2020-01-01T12:00:00Z"  # 72 rows at 10 min


def _dense_entry(name, rng):
    enc = hourglass_calc_dims(0.5, 3, 10)
    dims = [10, *enc, *enc[::-1], 10]
    params = {"params": {f"Dense_{i}": {"kernel": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
                                        "bias": (0.1 * rng.standard_normal(b)).astype(np.float32)}
                         for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}}
    return entry_from_numpy(name, "AutoEncoder", "feedforward_hourglass", {}, 10, params,
                            0.1 * rng.standard_normal(10), 1 + rng.random(10), 0.05 * rng.random(10),
                            1 + rng.random(10), tags=TAGS)


def _lstm_entry(name, rng):
    module = lookup_factory("LSTMAutoEncoder", "lstm_hourglass")(10)
    state = {k: ((0.1 if k.endswith(".b") or k == "head.bias" else 1 / np.sqrt(v.shape[0]))
                 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
             for k, v in module.state_dict().items()}
    return entry_from_numpy(name, "LSTMAutoEncoder", "lstm_hourglass", {}, 10, lstm_to_flax(state),
                            0.1 * rng.standard_normal(10), 1 + rng.random(10), 0.05 * rng.random(10),
                            1 + rng.random(10), tags=TAGS, lookback=8)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli-models")
    rng = np.random.default_rng(8)
    for name in NAMES:
        entry = _lstm_entry(name, rng) if "lstm" in name else _dense_entry(name, rng)
        serializer.dump(entry, str(root / name), metadata={"name": name, "dataset": DATASET})
    sock_dir = tempfile.mkdtemp(prefix="gcc")
    srv = run_server(str(root), host="127.0.0.1", port=0, device="cpu", background=True,
                     uds_path=os.path.join(sock_dir, "c.sock"), shm_ring=f"gordo-cli-{os.getpid()}")
    try:
        yield srv
    finally:
        srv.close()
        shutil.rmtree(sock_dir, ignore_errors=True)


def _members(data):
    """An artifact archive's members; ``detector.json`` without its
    ``stamp``, which each dump writes anew."""
    with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tar:
        out = {m.name: tar.extractfile(m).read() if m.isfile() else None for m in tar.getmembers()}
    desc = json.loads(out.pop("detector.json"))
    desc.pop("stamp")
    return out, desc


def run_jax(args, env=None):
    result = CliRunner().invoke(gordo, args, env=env)
    return result.exit_code, result.stdout, result.stderr


def run_port(args, capsys, monkeypatch, env=None):
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    try:
        rc = main(args)
    except SystemExit as exc:  # argparse's usage errors
        rc = exc.code
    out = capsys.readouterr()
    return rc, out.out, out.err


def _frames_equal(port_path, jax_path):
    pdf, jdf = pd.read_parquet(port_path), pd.read_parquet(jax_path)
    np.testing.assert_array_equal(pdf.to_numpy(), jdf.to_numpy())
    assert list(pdf.columns) == list(jdf.columns)
    np.testing.assert_array_equal(pdf.index.as_unit("ns").asi8, jdf.index.as_unit("ns").asi8)
    (pi, pn, pc), (ji, jn, jc) = read_parquet(port_path), read_parquet(jax_path)
    assert pn == jn and np.array_equal(pi, ji)
    for name in pn:
        np.testing.assert_array_equal(pc[name], jc[name])


@pytest.mark.parametrize("encoding", ["auto", "json", "parquet"])
def test_client_predict_matches_jax(server, tmp_path, capsys, monkeypatch, encoding):
    common = ["client", "predict", START, END, "--project", "proj", "--base-url", server.url, "--batch-size", "30",
              "--body-encoding", encoding]
    jax = run_jax([*common, "--parquet-dir", str(tmp_path / "jax")])
    port = run_port([*common, "--parquet-dir", str(tmp_path / "port")], capsys, monkeypatch)
    assert port[:2] == jax[:2] == (0, "3/3 machines scored successfully\n")
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        f"{n}.parquet" for n in sorted(NAMES)]
    for name in NAMES:
        _frames_equal(str(tmp_path / "port" / f"{name}.parquet"), str(tmp_path / "jax" / f"{name}.parquet"))


def test_client_predict_reports_a_failed_target_as_jax(server, tmp_path, capsys, monkeypatch):
    common = ["client", "predict", START, END, "--project", "proj", "--base-url", server.url,
              "--target", "ghost", "--target", NAMES[0]]
    jax = run_jax(common)
    port = run_port(common, capsys, monkeypatch)
    assert port[0] == jax[0] == 1
    assert port[1] == jax[1] == "1/2 machines scored successfully\n"
    failed = [line for line in port[2].splitlines() if "FAILED" in line]
    assert failed == [line for line in jax[2].splitlines() if "FAILED" in line]
    assert failed[0].startswith("  FAILED ghost: ['dataset: HTTP 404 from ")


def test_client_predict_takes_the_project_from_the_environment(server, tmp_path, capsys, monkeypatch):
    env = {"PROJECT_NAME": "proj", "GORDO_CLIENT_ENCODING": "json"}
    args = ["client", "predict", START, END, "--base-url", server.url, "--target", NAMES[2]]
    jax = run_jax(args, env=env)
    port = run_port(args, capsys, monkeypatch, env=env)
    assert port[:2] == jax[:2] == (0, "1/1 machines scored successfully\n")


def test_client_metadata_matches_jax(server, capsys, monkeypatch):
    args = ["client", "metadata", "--project", "proj", "--base-url", server.url]
    jax = run_jax(args)
    port = run_port(args, capsys, monkeypatch)
    assert port[0] == jax[0] == 0
    assert json.loads(port[1]) == json.loads(jax[1])
    assert sorted(json.loads(port[1])) == sorted(NAMES)


def test_client_download_model_matches_jax(server, tmp_path, capsys, monkeypatch):
    url = f"{server.url}/gordo/v0/proj/{NAMES[2]}/download-model"
    with urllib.request.urlopen(url, timeout=60) as resp:
        route = resp.read()
    jdest, pdest = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    common = ["--project", "proj", "--base-url", server.url]
    jax = run_jax(["client", "download-model", NAMES[2], jdest, *common])
    port = run_port(["client", "download-model", NAMES[2], pdest, *common], capsys, monkeypatch)
    assert (port[0], port[1]) == (0, pdest + "\n") and (jax[0], jax[1]) == (0, jdest + "\n")
    with open(pdest, "rb") as f, open(jdest, "rb") as g:
        got, want = f.read(), g.read()
    # the route dumps the artifact anew each time (its mtimes and stamp
    # move): the members' names and bytes are what must agree
    assert _members(got) == _members(want) == _members(route)
    assert serializer.loads(got, device="cpu") is not None
    jax = run_jax(["client", "download-model", "ghost", str(tmp_path / "j2"), *common])
    port = run_port(["client", "download-model", "ghost", str(tmp_path / "p2"), *common], capsys, monkeypatch)
    assert port[0] == jax[0] == 1
    assert not os.path.exists(tmp_path / "p2") and not os.path.exists(tmp_path / "j2")


def test_client_predict_refuses_a_time_that_does_not_parse_as_jax(server, capsys, monkeypatch):
    args = ["client", "predict", "not-a-time", END, "--project", "proj", "--base-url", server.url]
    jax = run_jax(args)
    port = run_port(args, capsys, monkeypatch)
    assert port[0] == jax[0] == 1 and port[1] == jax[1] == ""
    assert port[2] == "Invalid time: not an ISO 8601 timestamp: 'not-a-time'\n"


@pytest.mark.parametrize("case", ["no-project", "bad-encoding"])
def test_client_usage_errors_exit_2_as_jax(server, capsys, monkeypatch, case):
    monkeypatch.delenv("PROJECT_NAME", raising=False)
    args = ["client", "predict", START, END, "--base-url", server.url]
    env = None
    if case == "bad-encoding":
        args += ["--project", "proj"]
        env = {"GORDO_CLIENT_ENCODING": "tensor"}
    jax = run_jax(args, env=env)
    port = run_port(args, capsys, monkeypatch, env=env)
    assert port[0] == jax[0] == 2
