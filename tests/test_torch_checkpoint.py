"""Fleet checkpoint and resume of the port (``parallel/checkpoint.py`` and
``FleetTrainer(checkpoint_dir=...)``) against the JAX package's, on the CPU.

- **Resume.** A port fleet killed by ``epoch_callback`` after epoch k and
  resumed equals the uninterrupted port run bitwise (parameters,
  histories, scalers, thresholds) for a dense fleet, an ``lstm_symmetric``
  fleet (lookback 8), a variational fleet (its noise draws), early stopping
  with a validation split, and ``host_sync_every=2``; each case asserts the
  epochs the resume ran (a silent restore failure would retrain from epoch
  0 to the same numbers).
- **Against JAX.** From the same initial parameters with one batch an
  epoch (``test_torch_fleet.py``'s set-up), the port's resumed run and the
  JAX resumed run agree within rtol=1e-4, atol=1e-5.
- **Protocol.** Each case runs the same directory operations on both
  packages' ``FleetBucketCheckpoint`` (the JAX one writes orbax, the port
  an npz): torn saves, the deferred async commit, digest fallbacks, a
  checkpoint without digests, ``clear`` and ``prune_stale_checkpoints``. A
  JAX-written checkpoint under the port's key is skipped, never resumed.
- **Faults.** ``checkpoint.write`` failing costs the checkpoint, not the
  fit; ``checkpoint.read`` failing starts fresh.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest

from gordo_components_torch import resilience
from gordo_components_torch.convert import feedforward_from_flax, feedforward_to_flax
from gordo_components_torch.models import lookup_factory, train_core
from gordo_components_torch.parallel import FleetTrainer
from gordo_components_torch.parallel import checkpoint as port_ck
from gordo_components_tpu.parallel import FleetTrainer as JaxFleetTrainer
from gordo_components_tpu.parallel import checkpoint as jax_ck

BAND = dict(rtol=1e-4, atol=1e-5)
PACKAGES = {"jax": jax_ck, "port": port_ck}


@pytest.fixture(autouse=True)
def _clean_faults():
    resilience.reset()
    yield
    resilience.reset()


def _members(n=5, rows=64, f=3, seed=0):
    rng = np.random.RandomState(seed)
    return {f"m-{i}": rng.rand(rows, f).astype("float32") for i in range(n)}


class _Preempt(Exception):
    pass


def _kill_after(n_syncs):
    calls = {"n": 0}

    def cb(info):
        calls["n"] += 1
        if calls["n"] >= n_syncs:
            raise _Preempt(f"preempted after epoch {info['epoch']}")

    return cb


def _counting_cb():
    ran = []
    return ran, lambda info: ran.append(int(info["epoch"]))


def _same(a, b):
    for name in a:
        for k in a[name].params:
            np.testing.assert_array_equal(a[name].params[k], b[name].params[k])
        assert a[name].history == b[name].history
        for x, y in (*zip(a[name].scaler, b[name].scaler), *zip(a[name].error_scaler, b[name].error_scaler)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a[name].feature_thresholds, b[name].feature_thresholds)
        assert a[name].total_threshold == b[name].total_threshold


# (trainer kwargs, syncs before the kill, epochs the resume runs)
RESUME_CASES = {
    "dense": (dict(kind="feedforward_hourglass", epochs=6, batch_size=16, seed=3), 3, [2, 3, 4, 5]),
    "lstm": (dict(model_type="LSTMAutoEncoder", kind="lstm_symmetric", dims=(6,), lookback_window=8,
                  epochs=4, batch_size=16, seed=3), 2, [1, 2, 3]),
    "vae": (dict(kind="feedforward_variational", epochs=5, batch_size=16, seed=2), 3, [2, 3, 4]),
    "early stopping": (dict(kind="feedforward_hourglass", epochs=8, batch_size=16, seed=1, learning_rate=1e-2,
                            early_stopping_patience=1, validation_split=0.25), 3, [2, 3, 4, 5, 6, 7]),
    # syncs after epochs 1, 3, 5: killed at the second, epoch 1's save resumes
    "host_sync_every=2": (dict(kind="feedforward_hourglass", epochs=6, batch_size=16, seed=3,
                               host_sync_every=2), 2, [3, 5]),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_killed_and_resumed_fleet_equals_the_uninterrupted_run_bitwise(case, tmp_path):
    common, kill_at, want_ran = RESUME_CASES[case]
    members = _members()
    reference = FleetTrainer(device="cpu", **common).fit(members)
    ckdir = str(tmp_path / "ck")
    with pytest.raises(_Preempt):
        FleetTrainer(device="cpu", checkpoint_dir=ckdir, epoch_callback=_kill_after(kill_at), **common).fit(members)
    assert os.listdir(ckdir), "a checkpoint must survive the preemption"
    ran, cb = _counting_cb()
    resumed = FleetTrainer(device="cpu", checkpoint_dir=ckdir, epoch_callback=cb, **common).fit(members)
    if case == "early stopping":  # some members stop after the save, others train on
        assert sorted({len(r.history["loss"]) for r in reference.values()}) == [4, 8]
    assert ran == want_ran, ran
    _same(reference, resumed)
    # a finished bucket clears its checkpoint
    assert all(not os.listdir(os.path.join(ckdir, k)) for k in os.listdir(ckdir)) or not os.listdir(ckdir)


def test_resume_with_every_member_stopped_skips_the_loop(tmp_path, monkeypatch):
    """A preemption in the error pass after every member stopped resumes
    into no epoch at all."""
    from gordo_components_torch.parallel import fleet as port_fleet

    members = _members(3)
    common = dict(kind="feedforward_hourglass", epochs=30, batch_size=32, seed=0, early_stopping_patience=0,
                  learning_rate=0.5)
    reference = FleetTrainer(device="cpu", **common).fit(members)
    assert max(len(r.history["loss"]) for r in reference.values()) < 30
    ckdir = str(tmp_path / "ck")
    real = port_fleet._error_scalers

    def dies(*a, **k):
        raise _Preempt("preempted in the error pass")

    monkeypatch.setattr(port_fleet, "_error_scalers", dies)
    with pytest.raises(_Preempt):
        FleetTrainer(device="cpu", checkpoint_dir=ckdir, **common).fit(members)
    monkeypatch.setattr(port_fleet, "_error_scalers", real)
    ran, cb = _counting_cb()
    resumed = FleetTrainer(device="cpu", checkpoint_dir=ckdir, epoch_callback=cb, **common).fit(members)
    assert ran == []
    _same(reference, resumed)


def _initial(members, features=3):
    stack = train_core.StackedDense(lookup_factory("AutoEncoder", "feedforward_symmetric")(features, dims=(3,)))
    states = stack.state_dicts(stack.init([train_core.member_generator(11, i) for i in range(len(members))]))
    return dict(zip(members, states))


def test_resumed_run_matches_the_jax_resumed_run(tmp_path):
    members = _members(4, rows=60, f=3, seed=5)
    initial = _initial(members)
    common = dict(kind="feedforward_symmetric", dims=(3,), epochs=5, batch_size=64, learning_rate=1e-2)
    out = {}
    for pkg, trainer, init in (("jax", JaxFleetTrainer, {n: feedforward_to_flax(sd) for n, sd in initial.items()}),
                               ("port", lambda **k: FleetTrainer(device="cpu", **k), initial)):
        ckdir = str(tmp_path / pkg)
        with pytest.raises(_Preempt):
            trainer(checkpoint_dir=ckdir, epoch_callback=_kill_after(3), **common).fit(members, initial_params=init)
        ran, cb = _counting_cb()
        out[pkg] = trainer(checkpoint_dir=ckdir, epoch_callback=cb, **common).fit(members, initial_params=init)
        assert ran == [2, 3, 4], (pkg, ran)
    for name, want in out["jax"].items():
        got = out["port"][name]
        jparams = feedforward_from_flax(want.params)
        for k in jparams:
            np.testing.assert_allclose(got.params[k], jparams[k], **BAND)
        np.testing.assert_allclose(got.history["loss"], want.history["loss"], **BAND)
        np.testing.assert_allclose(got.feature_thresholds, want.feature_thresholds, **BAND)
        np.testing.assert_allclose(got.total_threshold, want.total_threshold, **BAND)


def test_lookback_change_invalidates_the_checkpoint(tmp_path):
    members = _members(2, rows=80)
    base = dict(model_type="LSTMAutoEncoder", kind="lstm_symmetric", dims=(6,), epochs=2, batch_size=32)
    ckdir = str(tmp_path / "ck")
    with pytest.raises(_Preempt):
        FleetTrainer(device="cpu", lookback_window=8, checkpoint_dir=ckdir, epoch_callback=_kill_after(2),
                     **base).fit(members)
    assert os.listdir(ckdir)
    ran, cb = _counting_cb()
    FleetTrainer(device="cpu", lookback_window=12, checkpoint_dir=ckdir, epoch_callback=cb, **base).fit(members)
    assert ran == [0, 1], ran


# ---------------------------------------------------------------------- #
# the protocol, the same operations on both packages
# ---------------------------------------------------------------------- #


def _state(k=0.0):
    return {"w": np.arange(100, dtype=np.float32) + k, "b": np.ones((4,), np.float32) * k}


def _checkpoint(pkg, root, key):
    """The package's checkpoint as its ``FleetTrainer`` runs it: the JAX one
    asked for its asynchronous writer, the port's always has one. A save
    commits at the next save, ``flush`` or ``clear``."""
    if pkg == "jax":
        return jax_ck.FleetBucketCheckpoint(root, key, use_async=True)
    return port_ck.FleetBucketCheckpoint(root, key)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_key_changes_with_the_config_and_the_data(pkg):
    key = PACKAGES[pkg].bucket_checkpoint_key
    a = key(["x", 1, ["m1", "m2"]], data=np.ones((4, 8), np.float32))
    assert a == key(["x", 1, ["m1", "m2"]], data=[np.ones((4, 8), np.float32)])
    assert a != key(["x", 1, ["m1", "m3"]], data=np.ones((4, 8), np.float32))
    assert a != key(["x", 1, ["m1", "m2"]], data=np.full((4, 8), 2.0, np.float32))
    assert a == port_ck.bucket_checkpoint_key(["x", 1, ["m1", "m2"]], data=np.ones((4, 8), np.float32))


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_torn_save_is_ignored_and_the_previous_survives(pkg, tmp_path):
    ck = _checkpoint(pkg, str(tmp_path), "a" * 24)
    os.makedirs(os.path.join(ck.root, "3", "state"))
    assert ck.restore() is None
    ck.save(4, _state(1.0), {"histories": [[0.5]]})
    ck.flush()
    os.makedirs(os.path.join(ck.root, "5", "state"))  # torn: never committed
    got = ck.restore()
    assert got["epoch"] == 4 and got["histories"] == [[0.5]]
    np.testing.assert_array_equal(got["state"]["w"], _state(1.0)["w"])
    ck.save(5, _state(2.0), {"histories": []})
    ck.flush()  # the commit prunes the old epoch and the torn one
    assert sorted(os.listdir(ck.root)) == ["5"] and ck.restore()["epoch"] == 5


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_async_commit_is_deferred_to_the_next_save(pkg, tmp_path):
    ck = _checkpoint(pkg, str(tmp_path), "b" * 24)
    histories = [[0.5]]
    ck.save(0, {"state": {"0": _state(0.0)["w"]}}, {"histories": histories})
    histories[0].append(0.4)  # training goes on past the save
    assert ck.restore() is None
    ck.save(1, {"state": {"0": _state(1.0)["w"]}}, {"histories": histories})
    got = ck.restore()
    assert got["epoch"] == 0 and got["histories"] == [[0.5]]
    ck.flush()
    got = ck.restore()
    assert got["epoch"] == 1 and got["histories"] == [[0.5, 0.4]]
    np.testing.assert_array_equal(got["state"]["state"]["0"], _state(1.0)["w"])
    ck.save(2, {"state": {"0": _state(2.0)["w"]}}, {"histories": []})
    ck.close()  # waits, does not commit: epoch 2 stays torn
    assert _checkpoint(pkg, str(tmp_path), "b" * 24).restore()["epoch"] == 1
    ck.clear()
    assert not os.path.isdir(ck.root)


def test_a_save_splits_its_seconds_and_reports_its_writer(tmp_path):
    ck = _checkpoint("port", str(tmp_path), "f" * 24)
    ck.save(0, _state(0.0), {"histories": [[0.5]]})
    first = ck.last_save_seconds
    assert set(first) == {"wait_s", "commit_s", "copy_s", "host_state_s"}
    ck.save(1, _state(1.0), {"histories": [[0.5]]})
    second = ck.last_save_seconds  # with the writer of epoch 0 it waited for
    assert set(second) == set(first) | {"write_s", "digest_s"}
    assert all(v >= 0 for v in second.values()) and ck.last_save_bytes > 0
    ck.clear()


def _two_epochs(ck):
    """Epoch 1 committed, and a copy of it as a newer epoch 2."""
    ck.save(1, _state(1.0), {"histories": []})
    ck.flush()
    shutil.copytree(os.path.join(ck.root, "1"), os.path.join(ck.root, "2"))
    with open(os.path.join(ck.root, "2", "host.json")) as f:
        host = json.load(f)
    host["epoch"] = 2
    with open(os.path.join(ck.root, "2", "host.json"), "w") as f:
        json.dump(host, f)
    return os.path.join(ck.root, "2")


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_a_tampered_digest_or_a_flipped_byte_falls_back_to_the_previous_epoch(pkg, tmp_path):
    ck = _checkpoint(pkg, str(tmp_path / "digest"), "c" * 24)
    edir = _two_epochs(ck)
    assert ck.restore()["epoch"] == 2
    with open(os.path.join(edir, "host.json")) as f:
        host = json.load(f)
    host["state_digest"] = "0" * 64
    with open(os.path.join(edir, "host.json"), "w") as f:
        json.dump(host, f)
    got = ck.restore()
    assert got["epoch"] == 1 and "state_digest" not in got
    np.testing.assert_array_equal(got["state"]["w"], _state(1.0)["w"])

    ck = _checkpoint(pkg, str(tmp_path / "bytes"), "c" * 24)
    edir = _two_epochs(ck)
    paths = [os.path.join(r, f) for r, _d, fs in os.walk(os.path.join(edir, "state")) for f in fs]
    victim = max(paths, key=os.path.getsize)
    data = bytearray(open(victim, "rb").read())
    data[len(data) // 2] ^= 0xFF
    with open(victim, "wb") as f:
        f.write(bytes(data))
    assert ck.restore()["epoch"] == 1


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_a_checkpoint_without_digests_still_restores(pkg, tmp_path):
    ck = _checkpoint(pkg, str(tmp_path), "d" * 24)
    ck.save(0, _state(3.0), {"histories": []})
    ck.flush()
    path = os.path.join(ck.root, "0", "host.json")
    with open(path) as f:
        host = json.load(f)
    host.pop("state_digest")
    host.pop("files_digest")
    with open(path, "w") as f:
        json.dump(host, f)
    np.testing.assert_array_equal(ck.restore()["state"]["b"], _state(3.0)["b"])


def _fake_bucket_dir(parent, key, age_days=0.0):
    path = os.path.join(str(parent), key)
    os.makedirs(os.path.join(path, "0"))
    if age_days:
        old = time.time() - age_days * 86400
        os.utime(path, (old, old))
    return path


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_clear_leaves_siblings_and_prune_counts_as_jax(pkg, tmp_path):
    mod = PACKAGES[pkg]
    stale = _fake_bucket_dir(tmp_path, "a" * 24, age_days=30)
    ck = _checkpoint(pkg, str(tmp_path), "b" * 24)
    os.makedirs(os.path.join(ck.root, "0"))
    ck.clear()
    assert not os.path.isdir(ck.root) and os.path.isdir(stale)
    fresh = _fake_bucket_dir(tmp_path, "c" * 24)
    not_ours = os.path.join(str(tmp_path), "user-data")
    os.makedirs(not_ours)
    _fake_bucket_dir(tmp_path, "d" * 24 + "e", age_days=30)  # not a key name
    old = time.time() - 60 * 86400
    os.utime(not_ours, (old, old))
    assert mod.prune_stale_checkpoints(str(tmp_path), older_than_days=7) == 1
    assert not os.path.isdir(stale) and os.path.isdir(fresh) and os.path.isdir(not_ours)
    assert mod.prune_stale_checkpoints(str(tmp_path / "absent"), 7) == 0


def test_a_jax_written_checkpoint_is_skipped_by_the_port(tmp_path):
    jax_ck.FleetBucketCheckpoint(str(tmp_path), "e" * 24).save(0, _state(1.0), {"histories": []})
    port = port_ck.FleetBucketCheckpoint(str(tmp_path), "e" * 24)
    assert port._committed_epochs() == [0]  # committed, but orbax's payload
    assert port.restore() is None


# ---------------------------------------------------------------------- #
# fault points
# ---------------------------------------------------------------------- #


def test_checkpoint_write_fault_costs_the_checkpoint_not_the_fit(tmp_path):
    members = _members(3)
    common = dict(kind="feedforward_hourglass", epochs=4, batch_size=16, seed=3)
    reference = FleetTrainer(device="cpu", **common).fit(members)
    resilience.configure_from_env("checkpoint.write=error:OSError")
    out = FleetTrainer(device="cpu", checkpoint_dir=str(tmp_path / "ck"), **common).fit(members)
    assert resilience.fault_stats()["checkpoint.write"]["fired"] == 3  # epochs 0-2 save
    _same(reference, out)


def test_checkpoint_read_fault_starts_fresh(tmp_path):
    members = _members(3)
    common = dict(kind="feedforward_hourglass", epochs=4, batch_size=16, seed=3)
    ckdir = str(tmp_path / "ck")
    with pytest.raises(_Preempt):
        FleetTrainer(device="cpu", checkpoint_dir=ckdir, epoch_callback=_kill_after(3), **common).fit(members)
    resilience.arm("checkpoint.read", exc=OSError)
    ran, cb = _counting_cb()
    FleetTrainer(device="cpu", checkpoint_dir=ckdir, epoch_callback=cb, **common).fit(members)
    assert ran == [0, 1, 2, 3]
