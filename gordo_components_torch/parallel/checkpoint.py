"""Preemption-safe checkpoints of a fleet bucket's training state.

Counterpart of ``gordo_components_tpu/parallel/checkpoint.py``. Every N
epochs ``FleetTrainer`` writes a bucket's stacked training state (the
``(M, P)`` parameters, the optimizer's moments and step counts, each
member's random stream and the early-stopping state) and its host-side
bookkeeping (the loss histories); a restarted gang resumes where it
stopped, drawing the same shuffles and noise. The JAX package writes the
state through orbax; the port, which has no orbax, writes one numpy
archive (``state/state.npz``) of named arrays. The protocol is the JAX
one:

    <key>/<epoch>/state/state.npz   the named arrays
    <key>/<epoch>/host.json         epoch, bookkeeping, digests: the commit

``host.json`` is written last, through ``.tmp`` and ``os.replace``: an
epoch directory without it is a torn save and is ignored, and older epochs
are pruned only after the new one commits. ``host.json`` records two
digests, :func:`state_digest` over the named arrays and
:func:`payload_files_digest` over every file under ``state/``; a restore
checks the file digest before it reads the payload and the array digest
after, and a checkpoint that fails either, or cannot be read (a JAX-written
one among them: its ``state/`` holds orbax files), is skipped for the next
one back, or for a fresh start. The key (:func:`bucket_checkpoint_key`)
hashes the bucket's configuration and its members' data, so a changed run
never resumes another's state.
"""

import copy
import hashlib
import json
import logging
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from gordo_components_torch.resilience.faults import faultpoint

logger = logging.getLogger(__name__)

_KEY_RE = re.compile(r"[0-9a-f]{24}")
_PAYLOAD = "state.npz"
_SEP = "/"  # joins the nested keys of a state dict into one archive name

# a failed write must not kill the run it protects; a failed read falls
# back to an older checkpoint or a fresh start
_FP_WRITE = faultpoint("checkpoint.write")
_FP_READ = faultpoint("checkpoint.read")


def _flatten(state: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """``{"a": {"b": x}}`` -> ``{"a/b": x}``."""
    out: Dict[str, Any] = {}
    for k, v in state.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + _SEP))
        else:
            out[name] = v
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, v in flat.items():
        *parents, leaf = name.split(_SEP)
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _host_array(x) -> np.ndarray:
    """An owned numpy copy of an array or tensor (a tensor on the card is
    copied to the host here)."""
    if hasattr(x, "detach"):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def state_digest(state: Dict[str, Any]) -> str:
    """Content digest of a (nested) dict of arrays: each array's name,
    shape, dtype and raw bytes, in sorted name order. The same before the
    write and after a clean read, so :meth:`FleetBucketCheckpoint.restore`
    sees a payload whose bytes changed on disk."""
    h = hashlib.sha256()
    for name, leaf in sorted(_flatten(state).items()):
        arr = np.asarray(leaf)
        h.update(name.encode())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(memoryview(np.ascontiguousarray(arr)).cast("B"))
    return h.hexdigest()


def payload_files_digest(state_dir: str) -> str:
    """Content digest of every file under ``state_dir`` (sorted relative
    paths and raw bytes): a flipped byte anywhere in the payload fails it
    before the payload is read."""
    h = hashlib.sha256()
    root = os.path.abspath(state_dir)
    entries = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            path = os.path.join(dirpath, name)
            entries.append((os.path.relpath(path, root), path))
    for rel, path in sorted(entries):
        h.update(rel.encode())
        h.update(b"\0")
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
    return h.hexdigest()


def bucket_checkpoint_key(payload: Any, data=None) -> str:
    """Identity of a bucket's training run: the JSON of ``payload`` and the
    content of ``data`` (an array, or an iterable of per-member arrays,
    hashed member by member without stacking them)."""
    h = hashlib.sha256(json.dumps(payload, sort_keys=True, default=str).encode())
    if data is not None:
        if isinstance(data, np.ndarray):
            data = [data]
        for arr in data:
            arr = np.ascontiguousarray(arr)
            h.update(str(arr.shape).encode())
            h.update(memoryview(arr).cast("B"))
    return h.hexdigest()[:24]


class FleetBucketCheckpoint:
    """Save and restore one bucket's training state under
    ``<checkpoint_dir>/<key>``.

    A save copies the state to host memory (on the caller's thread, before
    it returns) and a writer thread writes the archive while training goes
    on; epoch N commits at the next :meth:`save`, :meth:`flush` or
    :meth:`clear`. A preemption can then lose the one uncommitted save,
    never the committed one before it. A write that failed in the writer
    thread is logged at the commit, and its epoch stays uncommitted.

    ``last_save_seconds`` splits the last save's time on the caller's
    thread: ``wait_s`` (the writer of the save before), ``commit_s`` (its
    ``host.json`` and the prune), ``copy_s`` (the state to the host),
    ``host_state_s`` (the bookkeeping's deep copy), with ``write_s`` (the
    archive) and ``digest_s`` (both digests and the text of ``host.json``)
    of the writer it waited for."""

    def __init__(self, checkpoint_dir: str, key: str):
        self.root = os.path.join(os.path.abspath(checkpoint_dir), key)
        self._writer: Optional[threading.Thread] = None
        self._pending: Optional[list] = None  # [epoch, host.json's text or the exception]
        self.last_save_bytes = 0  # the archive's bytes, once written
        self.last_save_seconds: Dict[str, float] = {}
        self._write_seconds: Dict[str, float] = {}  # the writer's, read after its join

    # ------------------------------------------------------------------ #

    def _epoch_dirs(self):
        if not os.path.isdir(self.root):
            return []
        out = []
        for entry in os.listdir(self.root):
            try:
                out.append(int(entry))
            except ValueError:
                continue
        return sorted(out)

    def _committed_epochs(self):
        return [e for e in self._epoch_dirs()
                if os.path.exists(os.path.join(self.root, str(e), "host.json"))]

    def _commit(self, epoch: int, host_json: str) -> None:
        """Write the commit marker of ``epoch`` (its text, encoded by the
        writer), then prune older epochs."""
        edir = os.path.join(self.root, str(int(epoch)))
        host_path = os.path.join(edir, "host.json")
        with open(host_path + ".tmp", "w") as f:
            f.write(host_json)
        os.replace(host_path + ".tmp", host_path)  # the commit
        for old in self._epoch_dirs():
            if old != int(epoch):
                shutil.rmtree(os.path.join(self.root, str(old)), ignore_errors=True)
        logger.info("Fleet checkpoint committed at epoch %d -> %s", epoch, edir)

    def _write(self, edir: str, flat: Dict[str, np.ndarray], epoch: int, host_state: Dict[str, Any]) -> str:
        """The archive of ``flat`` under ``edir/state``; returns the text of
        ``host.json``: ``epoch``, ``host_state`` and both digests, all taken
        here, on the writer thread."""
        t = time.perf_counter()
        state_dir = os.path.join(edir, "state")
        os.makedirs(state_dir)
        path = os.path.join(state_dir, _PAYLOAD)
        with open(path, "wb") as f:
            np.savez(f, **flat)
        self.last_save_bytes = os.path.getsize(path)
        t_digest = time.perf_counter()
        host = {"epoch": int(epoch), **host_state, "state_digest": state_digest(flat),
                "files_digest": payload_files_digest(state_dir)}
        self._write_seconds = {"write_s": t_digest - t, "digest_s": time.perf_counter() - t_digest}
        return json.dumps(host)

    def _wait_writer(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    def _commit_pending(self) -> None:
        self._wait_writer()
        if self._pending is None:
            return
        epoch, result = self._pending
        self._pending = None
        if isinstance(result, BaseException):
            logger.warning("Fleet checkpoint write of epoch %d failed; it is not committed: %r",
                           epoch, result)
            return
        self._commit(epoch, result)

    def save(self, epoch: int, state: Dict[str, Any], host_state: Dict[str, Any]) -> None:
        """Persist the state after ``epoch``: a fresh ``<epoch>`` directory,
        the archive first and ``host.json`` last, and only then the older
        epochs pruned. ``state`` is a (nested) dict of arrays or tensors,
        ``host_state`` a JSON-able dict."""
        _FP_WRITE.fire()
        edir = os.path.join(self.root, str(int(epoch)))
        seconds = {}
        t = time.perf_counter()
        self._wait_writer()
        seconds.update(self._write_seconds, wait_s=time.perf_counter() - t)
        self._write_seconds = {}
        # commit (and prune for) the save in flight first, so that this
        # epoch's fresh directory is never pruned by it
        t = time.perf_counter()
        self._commit_pending()
        if os.path.isdir(edir):  # a torn save of an earlier attempt
            shutil.rmtree(edir)
        os.makedirs(edir)
        seconds["commit_s"] = time.perf_counter() - t
        t = time.perf_counter()
        flat = {k: _host_array(v) for k, v in _flatten(state).items()}
        seconds["copy_s"] = time.perf_counter() - t
        t = time.perf_counter()
        # host_state holds live lists (the histories) that grow on while
        # the writer encodes them
        host_state = copy.deepcopy(host_state)
        seconds["host_state_s"] = time.perf_counter() - t
        self.last_save_seconds = seconds
        pending = [int(epoch), None]

        def run():
            try:
                pending[1] = self._write(edir, flat, epoch, host_state)
            except BaseException as exc:  # reported at the commit
                pending[1] = exc

        self._pending = pending
        self._writer = threading.Thread(target=run, name="gordo-checkpoint-writer", daemon=True)
        self._writer.start()

    def flush(self) -> None:
        """Wait for the save in flight and commit it."""
        self._commit_pending()

    def close(self) -> None:
        """Wait for the writer without committing (teardown), so that it
        cannot race a later delete or save of the same directory."""
        self._wait_writer()
        self._pending = None

    def restore(self) -> Optional[Dict[str, Any]]:
        """``{"epoch": int, "state": dict of numpy arrays, **host_state}``
        from the newest committed epoch that reads and validates, or None.
        A checkpoint without digests (an older writer's) restores as
        before."""
        for epoch in reversed(self._committed_epochs()):
            edir = os.path.join(self.root, str(epoch))
            try:
                _FP_READ.fire()
                with open(os.path.join(edir, "host.json")) as f:
                    host = json.load(f)
                expected_files = host.pop("files_digest", None)
                if expected_files is not None and (
                        payload_files_digest(os.path.join(edir, "state")) != expected_files):
                    logger.warning("Fleet checkpoint at %s FAILED its payload-file digest (on-disk "
                                   "corruption); falling back to the next valid checkpoint", edir)
                    continue
                with np.load(os.path.join(edir, "state", _PAYLOAD), allow_pickle=False) as z:
                    state = _unflatten({k: z[k] for k in z.files})
            except Exception:
                logger.warning("Unreadable fleet checkpoint at %s; skipping", edir, exc_info=True)
                continue
            expected = host.pop("state_digest", None)
            if expected is not None and state_digest(state) != expected:
                logger.warning("Fleet checkpoint at %s FAILED its state digest (on-disk corruption); "
                               "falling back to the next valid checkpoint", edir)
                continue
            host["state"] = state
            logger.info("Resuming fleet bucket from %s (epoch %d done)", edir, epoch)
            return host
        return None

    def clear(self, prune_stale_after_days: Optional[float] = None) -> None:
        """Remove this bucket's checkpoint (the bucket finished). Siblings
        are pruned only when ``prune_stale_after_days`` asks for it: another
        key's state may be a paused gang's."""
        self.close()
        if os.path.isdir(self.root):
            shutil.rmtree(self.root, ignore_errors=True)
        if prune_stale_after_days is not None:
            prune_stale_checkpoints(os.path.dirname(self.root), prune_stale_after_days)


def prune_stale_checkpoints(checkpoint_dir: str, older_than_days: float) -> int:
    """Delete the bucket checkpoints under ``checkpoint_dir`` untouched for
    ``older_than_days`` (a changed config or data strands its key for
    good); returns how many. Only directories named by 24 hex digits that
    hold nothing but integer epoch directories are touched."""
    parent = os.path.abspath(checkpoint_dir)
    if not os.path.isdir(parent):
        return 0
    cutoff = time.time() - float(older_than_days) * 86400
    pruned = 0
    for entry in os.listdir(parent):
        path = os.path.join(parent, entry)
        try:
            if not (os.path.isdir(path) and _KEY_RE.fullmatch(entry)
                    and all(e.isdigit() for e in os.listdir(path))):
                continue
            if os.path.getmtime(path) < cutoff:
                logger.warning("Pruning stale fleet checkpoint %s", path)
                shutil.rmtree(path, ignore_errors=True)
                pruned += 1
        except OSError:
            continue
    return pruned
