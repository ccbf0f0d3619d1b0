"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, and its entry points default to the card and refuse to run on the
CPU unless asked to.

The import check runs in a subprocess because this test process has already
imported jax (tests/conftest.py). It blocks pandas, sklearn, PyYAML,
pyarrow, aiohttp and requests too: the card's machine has none of them. The port reads parquet
with its own reader, so under the block it still reads the lake's 2021
parquet file.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "gordo_components_tpu",
           "pandas", "sklearn", "yaml", "pyarrow", "aiohttp", "requests")

_IMPORT_ALL = """
import importlib, importlib.abc, importlib.util, json, pkgutil, sys

BLOCKED = set({blocked!r})


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None


sys.meta_path.insert(0, Block())
import gordo_components_torch

names = [m.name for m in pkgutil.walk_packages(
    gordo_components_torch.__path__, "gordo_components_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
from gordo_components_torch.dataset.data_provider import NcsReader
from gordo_components_torch.dataset.sensor_tag import SensorTag
from gordo_components_torch.dataset.times import to_ns

(series,) = NcsReader({lake!r}).load_series(to_ns("2021-01-01"), to_ns("2022-01-01"),
                                           [SensorTag("GRA-T1", "asset-a")])
print(json.dumps({{"modules": names, "rows_2021": int(series.index.size), "leaked": sorted(
    n for n in sys.modules if n.split(".")[0] in BLOCKED)}}))
"""


def _run(args, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


def test_port_imports_without_jax_or_the_jax_package():
    code = _IMPORT_ALL.format(
        blocked=BLOCKED, smoke=os.path.join(REPO, "chip_smoke.py"),
        lake=os.path.join(REPO, "examples", "datalake"),
    )
    proc = _run(["-c", code], cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["leaked"] == []
    assert report["rows_2021"] == 400  # GRA-T1_2021.parquet, read with pyarrow blocked
    # every module of the slice was imported under the block
    for mod in ("ops.score", "ops._cuda", "server.bank", "server.engine",
                "server.views", "convert", "serializer.artifacts",
                "models.anomaly.diff", "models.factories.feedforward",
                "ops.seq_scan", "ops.windows", "ops.activations",
                "models.factories.lstm", "ops.losses", "models.train_core",
                "models.models", "models.transformers", "models.base",
                "models.anomaly.base", "serializer.definitions", "dataset.datasets",
                "dataset.resample", "dataset.data_provider.providers", "workflow.config",
                "builder.build_model", "builder.fleet_build", "parallel.fleet",
                "utils.staging", "utils.yaml_subset", "builder.splits", "cli", "cli.cli",
                "cli.__main__", "models.factories.conv", "models.factories.variational",
                "ops.dense", "models.register", "server.model_io", "server.swap",
                "utils.digest", "dataset.times", "dataset.filter_rows",
                "dataset.data_provider.datalake", "dataset.data_provider.auth",
                "dataset.data_provider.influx_http", "dataset.data_provider._files",
                "dataset.data_provider._parquet", "dataset.data_provider._snappy",
                "dataset.data_provider._thrift", "models.compose", "utils.wire", "utils.shm_ring",
                "server.transport", "server.workers", "qos.classify", "client", "client.client",
                "client.io", "client.http", "client.forwarders", "resilience.retry_budget",
                "ops.quantize", "streaming", "streaming.ingest", "streaming.drift", "streaming.push",
                "streaming.adapt", "dataset.data_provider.streaming", "client.subscribe",
                "workflow.executor", "gameday.gate", "gameday.harness", "gameday.replica"):
        assert f"gordo_components_torch.{mod}" in report["modules"]


_CLI_UNDER_BLOCK = """
import importlib.abc, json, sys

BLOCKED = set({blocked!r})


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None


sys.meta_path.insert(0, Block())
from gordo_components_torch.cli import main

rc = main(["--device", "cpu", "build-fleet", "--machines-file", {fleet!r}, "--output-dir", {out!r}])
print(json.dumps({{"rc": rc, "leaked": sorted(
    n for n in sys.modules if n.split(".")[0] in BLOCKED)}}))
"""


def test_cli_imports_no_yaml_click_sklearn_pandas_or_jax():
    """Where all of them are installed, the CLI loads none of them."""
    code = ("import json, sys, gordo_components_torch.cli; print(json.dumps(sorted("
            f"n for n in sys.modules if n.split('.')[0] in {BLOCKED!r})))")
    proc = _run(["-c", code], cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_cli_builds_fleet_yaml_with_yaml_click_sklearn_pandas_and_jax_blocked(tmp_path):
    code = _CLI_UNDER_BLOCK.format(blocked=BLOCKED, fleet=os.path.join(REPO, "examples", "fleet.yaml"),
                                   out=str(tmp_path / "out"))
    proc = _run(["-c", code], cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"rc": 0, "leaked": []}
    assert sorted(os.listdir(tmp_path / "out")) == [
        "build_manifest.json", "build_trace.json", "compressor-a", "compressor-b", "turbine-lstm"]


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this process sees a card; the check is for machines without one")
    proc = _run(["chip_smoke.py"], cwd=REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def artifact_dir(tmp_path):
    from gordo_components_torch import serializer
    from gordo_components_torch.convert import entry_from_numpy

    rng = np.random.RandomState(0)
    F = 3
    params = {"params": {
        "Dense_0": {"kernel": rng.randn(F, 2).astype("f4"), "bias": np.zeros(2, "f4")},
        "Dense_1": {"kernel": rng.randn(2, F).astype("f4"), "bias": np.zeros(F, "f4")},
    }}
    entry = entry_from_numpy(
        "m", "AutoEncoder", "feedforward_model",
        {"encoding_dim": [2], "decoding_dim": []}, F, params,
        np.zeros(F), np.ones(F), np.zeros(F), np.ones(F),
    )
    serializer.dump(entry, str(tmp_path / "m"))
    return str(tmp_path)


_DATASET = {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00Z",
            "train_end_date": "2020-01-01T06:00:00Z", "tag_list": ["a", "b", "c"]}
_MODEL = {"gordo_components_torch.models.DiffBasedAnomalyDetector": {"base_estimator": {
    "gordo_components_torch.models.AutoEncoder": {"kind": "feedforward_symmetric", "dims": [2],
                                                  "epochs": 1}}}}


def _entry_points(artifact_dir):
    from gordo_components_torch import resolve_device, serializer
    from gordo_components_torch.builder import build_fleet, build_model, provide_saved_model
    from gordo_components_torch.models import AutoEncoder
    from gordo_components_torch.parallel import FleetTrainer
    from gordo_components_torch.server import ModelBank, build_app, run_server

    X = np.random.RandomState(0).rand(20, 3).astype("f4")
    out = os.path.join(artifact_dir, "built")
    return {
        "AutoEncoder.fit": lambda **kw: AutoEncoder(
            kind="feedforward_symmetric", dims=[2], epochs=1, **kw).fit(X),
        "FleetTrainer.fit": lambda **kw: FleetTrainer(
            kind="feedforward_symmetric", dims=[2], epochs=1, **kw).fit({"m": X}),
        "build_model": lambda **kw: build_model("m", _MODEL, _DATASET, **kw),
        "provide_saved_model": lambda **kw: provide_saved_model(
            "m", _MODEL, _DATASET, output_dir=out, **kw),
        "build_fleet": lambda **kw: build_fleet([{"name": "m", "dataset": _DATASET}], out, **kw),
        "resolve_device": lambda **kw: resolve_device(**kw),
        "ModelBank": lambda **kw: ModelBank(**kw),
        "serializer.load": lambda **kw: serializer.load(os.path.join(artifact_dir, "m"), **kw),
        "serializer.loads": lambda **kw: serializer.loads(
            serializer.dumps(serializer.load(os.path.join(artifact_dir, "m"), device="cpu")), **kw),
        "build_app": lambda **kw: build_app(artifact_dir, **kw).close(),
        "run_server": lambda **kw: run_server(
            artifact_dir, host="127.0.0.1", port=0, background=True, **kw
        ).close(),
    }


@pytest.mark.parametrize(
    "name", ["resolve_device", "ModelBank", "serializer.load", "serializer.loads", "build_app", "run_server",
             "AutoEncoder.fit", "FleetTrainer.fit", "build_model", "provide_saved_model",
             "build_fleet"]
)
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, artifact_dir, name):
    entry = _entry_points(artifact_dir)[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
    entry(device="cpu")  # an explicit CPU request runs


def test_resolve_device_rejects_other_devices():
    from gordo_components_torch import resolve_device

    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
