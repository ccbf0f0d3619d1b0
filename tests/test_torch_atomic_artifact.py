"""A served artifact directory rewritten under a refreshing collection.

The port's artifact is several files in one directory, and the builders
write (``serializer.dump``) or copy (``builder.build_model._mirror_artifact``)
a new build over the one a server is reading. A refresh that comes in the
middle must keep the earlier model serving, never report it removed and
never serve a mix of two builds: the JAX package's rule for "a corrupt or
mid-write artifact" (``gordo_components_tpu/server/model_io.py``). These
tests replay the two interleavings that broke it, a dump cut before its
descriptor and a mirror cut after two files, then a change of descriptor
kind in one directory, an artifact written before descriptors were stamped,
and the digest check itself.
"""

import json
import os
import shutil

import numpy as np
import pytest

from gordo_components_torch import serializer
from gordo_components_torch.builder.build_model import _mirror_artifact
from gordo_components_torch.models import AutoEncoder, DiffBasedAnomalyDetector
from gordo_components_torch.models.transformers import MinMaxScaler, Pipeline
from gordo_components_torch.serializer import artifacts
from gordo_components_torch.server import ModelCollection

ROWS = np.random.RandomState(11).rand(16, 3).astype("float32")


def _detector(seed, scale=1.0):
    rows = (np.random.RandomState(seed).rand(120, 3) * scale).astype("float32")
    return DiffBasedAnomalyDetector(base_estimator=AutoEncoder(epochs=1, batch_size=64, device="cpu")).fit(rows)


@pytest.fixture(scope="module")
def fitted():
    rows = np.random.RandomState(5).rand(120, 3).astype("float32")
    pipe = Pipeline([("s", MinMaxScaler()), ("m", AutoEncoder(epochs=1, batch_size=64, device="cpu"))]).fit(rows)
    return {"old": _detector(0), "new": _detector(7, scale=100.0), "other": _detector(1), "pipe": pipe}


@pytest.fixture()
def served(fitted, tmp_path):
    """``m-a`` (the old build) and ``m-b`` dumped under ``root`` and loaded
    into a collection; yields (collection, root)."""
    root = tmp_path / "served"
    serializer.dump(fitted["old"], str(root / "m-a"), metadata={"name": "m-a", "build": "old"})
    serializer.dump(fitted["other"], str(root / "m-b"), metadata={"name": "m-b"})
    return ModelCollection(str(root), device="cpu"), root


def assert_same_anomaly(got, want):
    a, b = got.anomaly(ROWS), want.anomaly(ROWS)
    assert sorted(a) == sorted(b) and len(a) == 6
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_refresh_during_dump_keeps_the_old_model(served, fitted, monkeypatch):
    collection, root = served
    replace_into = artifacts._replace_into

    def cut_before_descriptor(dest_dir, fname, write):
        if fname in artifacts.DESCRIPTOR_FILES:
            raise KeyboardInterrupt("the builder stops before its descriptor")
        return replace_into(dest_dir, fname, write)

    monkeypatch.setattr(artifacts, "_replace_into", cut_before_descriptor)
    with pytest.raises(KeyboardInterrupt):
        serializer.dump(fitted["new"], str(root / "m-a"), metadata={"name": "m-a", "build": "new"})
    monkeypatch.undo()
    assert not [f for f in os.listdir(root / "m-a") if f.startswith(".")]  # no temporary left

    changes = collection.refresh()
    assert changes["removed"] == [] and changes["updated"] == []
    assert "m-a" in changes["failed"] and "sha256" in changes["failed"]["m-a"]
    assert collection.names() == ["m-a", "m-b"]
    assert_same_anomaly(collection.models["m-a"], fitted["old"])
    assert collection.metadata["m-a"]["build"] == "old"

    # the builder finishes: the next refresh takes the whole new build
    serializer.dump(fitted["new"], str(root / "m-a"), metadata={"name": "m-a", "build": "new"})
    changes = collection.refresh()
    assert changes["updated"] == ["m-a"] and changes["failed"] == {}
    assert_same_anomaly(collection.models["m-a"], fitted["new"])
    assert collection.metadata["m-a"]["build"] == "new"
    assert collection.refresh() == {"added": [], "updated": [], "removed": [], "failed": {}}


def test_refresh_during_mirror_never_serves_a_mix(served, fitted, tmp_path):
    collection, root = served
    register = tmp_path / "register" / "key"
    serializer.dump(fitted["new"], str(register), metadata={"name": "m-a", "build": "new"})
    # the mirror as it was: file by file, source times kept, metadata first
    for fname in ("metadata.json", "params.npz"):
        shutil.copy2(register / fname, root / "m-a" / fname)
    changes = collection.refresh()
    assert changes["removed"] == [] and "m-a" in changes["failed"]
    assert_same_anomaly(collection.models["m-a"], fitted["old"])

    _mirror_artifact(str(register), str(root / "m-a"))
    changes = collection.refresh()
    assert changes["updated"] == ["m-a"] and changes["failed"] == {}
    assert_same_anomaly(collection.models["m-a"], fitted["new"])
    assert sorted(os.listdir(root / "m-a")) == sorted(os.listdir(register))


def test_mirror_copies_the_descriptor_last(fitted, tmp_path, monkeypatch):
    src, dest = tmp_path / "src", tmp_path / "dest"
    serializer.dump(fitted["new"], str(src), metadata={"name": "m"})
    listdir, replace_into, order = os.listdir, artifacts._replace_into, []
    # a listing that puts the descriptor first
    monkeypatch.setattr(os, "listdir", lambda p: sorted(listdir(p), key=lambda f: (f != "detector.json", f)))
    monkeypatch.setattr(artifacts, "_replace_into",
                        lambda d, fname, write: order.append(fname) or replace_into(d, fname, write))
    _mirror_artifact(str(src), str(dest))
    monkeypatch.undo()
    assert order == ["metadata.json", "params.npz", "scalers.npz", "detector.json"]
    assert_same_anomaly(serializer.load(str(dest), device="cpu"), fitted["new"])


@pytest.mark.parametrize("first, second", [("pipe", "new"), ("new", "pipe")])
def test_kind_change_in_one_directory(fitted, tmp_path, first, second):
    root = tmp_path / "served"
    serializer.dump(fitted[first], str(root / "m"), metadata={"name": "m", "build": first})
    collection = ModelCollection(str(root), device="cpu")
    before = collection.models["m"]
    serializer.dump(fitted[second], str(root / "m"), metadata={"name": "m", "build": second})
    kinds = {"pipe": "model.json", "new": "detector.json"}
    assert kinds[second] in os.listdir(root / "m") and kinds[first] not in os.listdir(root / "m")
    if second == "pipe":  # a bare Pipeline writes its own scalers.npz
        assert "scalers.npz" in os.listdir(root / "m")
    changes = collection.refresh()
    assert changes["updated"] == ["m"] and changes["failed"] == {}
    after = collection.models["m"]
    assert type(after) is type(fitted[second]) and type(before) is type(fitted[first])
    assert collection.metadata["m"]["build"] == second
    np.testing.assert_array_equal(after.predict(ROWS), fitted[second].predict(ROWS))


def test_dump_of_a_bare_estimator_removes_the_detector_scalers(fitted, tmp_path):
    path = tmp_path / "m"
    serializer.dump(fitted["old"], str(path))
    serializer.dump(fitted["pipe"].steps[-1][1], str(path))
    assert sorted(os.listdir(path)) == ["model.json", "params.npz"]
    assert type(serializer.load(str(path), device="cpu")) is AutoEncoder


def test_unstamped_artifact_loads_and_refreshes_by_mtime(fitted, tmp_path):
    root = tmp_path / "served"
    path = root / "m"
    serializer.dump(fitted["old"], str(path), metadata={"name": "m"})
    meta = json.loads((path / "detector.json").read_text())
    assert len(meta.pop("stamp")) == 32 and sorted(meta.pop("digests")) == [
        "metadata.json", "params.npz", "scalers.npz"]
    (path / "detector.json").write_text(json.dumps(meta))  # as dumped before stamps
    assert_same_anomaly(serializer.load(str(path), device="cpu"), fitted["old"])
    collection = ModelCollection(str(root), device="cpu")
    assert collection.refresh()["updated"] == []
    later = os.path.getmtime(path / "detector.json") + 5
    os.utime(path / "params.npz", (later, later))
    assert collection.refresh()["updated"] == ["m"]


def test_load_refuses_a_file_that_is_not_the_descriptors(fitted, tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    serializer.dump(fitted["old"], str(a), metadata={"name": "a"})
    serializer.dump(fitted["other"], str(b), metadata={"name": "b"})
    shutil.copy2(b / "scalers.npz", a / "scalers.npz")
    with pytest.raises(ValueError, match="sha256"):
        serializer.load(str(a), device="cpu")
    shutil.copy2(b / "metadata.json", a / "metadata.json")
    with pytest.raises(ValueError, match="sha256"):
        serializer.load_metadata(str(a))
    assert "stamp" not in serializer.load_metadata(str(b))


def test_dump_metadata_still_leaves_no_artifact(fitted, tmp_path):
    path = tmp_path / "m"
    serializer.dump(fitted["old"], str(path), metadata={"name": "m"})
    serializer.dump_metadata(str(path), {"name": "m", "model": {"trained": False}})
    assert os.listdir(path) == ["metadata.json"] and not serializer.is_artifact_dir(str(path))
    assert serializer.load_metadata(str(path))["model"] == {"trained": False}
