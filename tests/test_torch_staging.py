"""The port's staging engines (``utils/staging.py``) against the JAX
package's, on the CPU: ``load_mode`` picks the same engine for the same
environment, host and member count (threads where JAX's ``auto`` spawns
processes), ``_io_bound_hint`` reads the same
providers the same way, and the ``sync``, ``thread`` and ``process``
engines stage bitwise the same arrays, in input order."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from gordo_components_torch.dataset.data_provider.providers import RandomDataProvider
from gordo_components_torch.utils import staging as port
from gordo_components_tpu.utils import staging as jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(i, **kw):
    return {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00Z",
            "train_end_date": "2020-01-03T00:00:00Z", "tag_list": [f"m{i}-a", f"m{i}-b", f"m{i}-c"], **kw}


@pytest.mark.parametrize("cores", [1, 2, 8])
def test_load_mode_matches_jax(cores, monkeypatch):
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    for env in (None, "", "auto", "thread", "process", "sync"):
        if env is None:
            monkeypatch.delenv("GORDO_LOAD_MODE", raising=False)
        else:
            monkeypatch.setenv("GORDO_LOAD_MODE", env)
        for n_tasks in (1, 15, 16, 64, 200):
            for workers in (1, 4, 8):
                for io_bound in (True, False):
                    want = jax.load_mode(n_tasks, workers, io_bound)
                    if env in (None, "", "auto") and want == "process":
                        want = "thread"  # the port's auto never spawns workers
                    assert port.load_mode(n_tasks, workers, io_bound) == want
    for bad in ("threads", "PROCESS", "fork"):
        monkeypatch.setenv("GORDO_LOAD_MODE", bad)
        with pytest.raises(ValueError) as want:
            jax.load_mode(4, 4)
        with pytest.raises(ValueError) as got:
            port.load_mode(4, 4)
        assert str(got.value) == str(want.value)


def test_io_bound_hint_matches_jax():
    cases = [
        [_config(0)],
        [_config(0, data_provider={"type": "RandomDataProvider"})],
        [_config(0, data_provider={"type": "DataLakeProvider", "store_path": "x"})],
        [_config(0), _config(1, data_provider={"type": "InfluxDataProvider", "measurement": "m"})],
        [_config(0, data_provider={"type": "SomeProviderNobodyKnows"})],
        [_config(0, data_provider={"type": "gordo_components_tpu.dataset.data_provider.RandomDataProvider"})],
    ]
    for configs in cases:
        assert port._io_bound_hint(configs) == jax._io_bound_hint(configs), configs


def test_the_engines_stage_the_same_arrays_in_order(monkeypatch):
    monkeypatch.delenv("GORDO_LOAD_MODE", raising=False)
    configs = [_config(i, seed=i) for i in range(6)]
    staged = {mode: port.stage_members(configs, workers=3, mode=mode) for mode in ("sync", "thread", "process")}
    for mode, got in staged.items():
        assert len(got) == len(configs)
        for config, (X, meta), (SX, smeta) in zip(configs, got, staged["sync"]):
            assert X.columns == config["tag_list"], mode
            np.testing.assert_array_equal(X.values, SX.values)
            np.testing.assert_array_equal(X.index, SX.index)
            assert meta == smeta
    # an injected provider object cannot be pickled for a worker: threads
    unpicklable = [dict(c, data_provider=RandomDataProvider(seed=i)) for i, c in enumerate(configs[:3])]
    for provider in unpicklable:
        provider["data_provider"]._lock = threading.Lock()
    got = port.stage_members(unpicklable, workers=3, mode="process")
    want = port.stage_members(unpicklable, workers=3, mode="sync")
    for (X, _), (WX, _) in zip(got, want):
        np.testing.assert_array_equal(X.values, WX.values)
    with pytest.raises(ValueError, match="auto\\|thread\\|process\\|sync"):
        port.stage_members(configs, mode="spawn")


def test_a_staging_worker_imports_the_dataset_modules_only():
    """What a spawned worker runs: ``_stage_one`` imports no torch (and so
    never touches CUDA)."""
    code = ("import sys, json; from gordo_components_torch.utils.staging import _stage_one; "
            f"X, meta = _stage_one({_config(0)!r}); "
            "print(json.dumps([X.values.shape[0], 'torch' in sys.modules]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[288, false]"
