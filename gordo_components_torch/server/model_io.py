"""The served model collection, read from port artifact directories.

Counterpart of ``scan_artifacts`` and ``ModelCollection`` in
``gordo_components_tpu/server/model_io.py``, over the port's artifact format
(``serializer/artifacts.py``): no pickle is ever loaded. A collection holds
every model under its root, whatever its class (a detector, a bare
``Pipeline``, a bare estimator), loaded on the server's device.

Also the tensor wire's codecs at the model boundary (JAX
``decode_tensor_request``, ``decode_tensor_request_ex``,
``encode_prediction_response`` and ``encode_anomaly_response``): a request
body decodes to float32 rows (a read-only ``np.frombuffer`` view for a
native ``<f4`` frame) and the score arrays encode into one preallocated
body (``utils/wire.py``). The per-model ``anomaly()`` returns the arrays
themselves, so the port needs no counterpart of JAX's pandas bridge
``anomaly_frame_arrays``.

The streaming plane's adaptations replace models in memory
(:meth:`ModelCollection.publish`) and roll back
(:meth:`ModelCollection.restore`), as the JAX collection does.

A collection of the serving mesh owns a set of members (``owned``): it
loads only those of the artifacts under its root (a shared directory holds
the whole fleet), :meth:`ModelCollection.acquire` and
:meth:`ModelCollection.release` move a member in and out, and
:func:`pack_artifact_dir` / :func:`unpack_artifact_dir` ship an artifact
between replicas as a gzipped tar (JAX ``model_io.py:139-172, 207-330``).
"""

import io
import json
import logging
import os
import tarfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from gordo_components_torch.serializer.artifacts import (
    artifact_version,
    is_artifact_dir,
    load,
    load_metadata,
)

from gordo_components_torch.utils.wire import (
    ANOMALY_FRAME_NAMES,
    WireFormatError,
    pack_frames,
    rows_as_f32,
    unpack_frames,
)
from gordo_components_torch.resilience.faults import faultpoint

logger = logging.getLogger(__name__)

# one artifact that fails to load leaves the others serving
_FP_LOAD = faultpoint("model_io.load")


def decode_tensor_request(raw) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """A tensor request body as ``(X, y)`` float32 rows; ``y`` is None
    without a ``y`` frame. Raises :class:`WireFormatError` (a 400 with the
    reason) for a malformed body."""
    X, y, _ = decode_tensor_request_ex(raw)
    return X, y


def decode_tensor_request_ex(raw) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[Dict[str, Any]]]:
    """:func:`decode_tensor_request` and the body's ``__meta__`` sidecar
    (None without one). The body must carry ``X``; ``y`` must have as many
    rows. A sidecar that is not a JSON object is ignored, not a 400: QoS
    tagging never refuses a well-formed body."""
    frames = unpack_frames(raw)
    if "X" not in frames:
        raise WireFormatError(f"tensor body must carry an 'X' frame (got {sorted(frames)})")
    X = rows_as_f32(frames["X"], "X")
    y = rows_as_f32(frames["y"], "y") if "y" in frames else None
    if y is not None and len(y) != len(X):
        raise WireFormatError(f"y has {len(y)} rows but X has {len(X)}")
    meta: Optional[Dict[str, Any]] = None
    if "__meta__" in frames:
        try:
            doc = json.loads(np.asarray(frames["__meta__"], np.uint8).tobytes())
            if isinstance(doc, dict):
                meta = doc
        except (ValueError, TypeError):
            pass
    return X, y, meta


def _meta_frame(meta: Dict[str, Any]) -> Tuple[str, np.ndarray]:
    """A JSON sidecar riding as a ``|u1`` frame."""
    return "__meta__", np.frombuffer(json.dumps(meta).encode("utf-8"), np.uint8)


def encode_prediction_response(output: np.ndarray, n_input_rows: int) -> bytes:
    """``POST .../prediction``'s tensor answer: ``__meta__`` with the
    warm-up ``offset`` (output row i is input row i + offset), then
    ``data``."""
    output = np.asarray(output)
    return pack_frames([_meta_frame({"offset": int(n_input_rows - len(output))}), ("data", output)])


def encode_anomaly_response(tags, arrays: Dict[str, np.ndarray], offset: int) -> bytes:
    """``POST .../anomaly/prediction``'s tensor answer: ``__meta__`` with
    ``offset`` and ``tags``, then the six score arrays in
    ``ANOMALY_FRAME_NAMES`` order."""
    meta = _meta_frame({"offset": int(offset), "tags": [str(t) for t in tags]})
    return pack_frames([meta] + [(name, arrays[name]) for name in ANOMALY_FRAME_NAMES])


def pack_artifact_dir(path: str) -> bytes:
    """One member's artifact directory as a gzipped tar, its paths relative
    to the directory (the receiver lands them under its own root)."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for entry in sorted(os.listdir(path)):
            tar.add(os.path.join(path, entry), arcname=entry)
    return buf.getvalue()


def unpack_artifact_dir(raw: bytes, dest: str) -> None:
    """Extract a shipped artifact archive under ``dest``. Every member name
    is checked first: an absolute path, a ``..`` component, a link or a
    device refuses the whole archive (it crossed a network)."""
    os.makedirs(dest, exist_ok=True)
    with tarfile.open(fileobj=io.BytesIO(raw), mode="r:gz") as tar:
        members = tar.getmembers()
        for member in members:
            name = member.name
            if os.path.isabs(name) or ".." in name.split("/") or not (member.isfile() or member.isdir()):
                raise ValueError(f"refusing artifact archive member {name!r} (unsafe path or non-file entry)")
        for member in members:
            tar.extract(member, dest, set_attrs=False)


def scan_artifacts(root: str, target_name: Optional[str] = None) -> Dict[str, str]:
    """name -> artifact dir under ``root``: ``root`` itself when it is an
    artifact (named ``target_name`` or its basename), else each artifact
    subdirectory under its own name."""
    if is_artifact_dir(root):
        return {target_name or os.path.basename(os.path.normpath(root)): root}
    try:
        entries = sorted(os.listdir(root))
    except FileNotFoundError:
        return {}
    return {
        e: os.path.join(root, e) for e in entries if is_artifact_dir(os.path.join(root, e))
    }


class ModelCollection:
    """name -> (model, metadata) for every artifact under ``root``, loaded
    on ``device``.

    The models and their metadata are published together as one tuple:
    :meth:`refresh` builds new dicts to the side and swaps them in with one
    assignment, and a published dict is never changed afterwards, so a
    reader on another thread sees one whole state (:meth:`snapshot`,
    :meth:`entry`).

    :meth:`refresh` loads new and changed artifacts and drops removed ones.
    A version is the descriptor's build stamp with the newest mtime of the
    artifact's files (``serializer.artifacts.artifact_version``). A corrupt
    artifact, or one caught in the middle of a rewrite (its data files do
    not match the descriptor's digests), is reported under ``failed`` and in
    ``load_failures``, and skipped: a previous good version keeps serving,
    and the next refresh tries it again.

    ``owned`` (the serving mesh): the member names this collection loads
    and serves, whatever else the root holds; None (the default) owns
    everything on disk. An owned set may be empty (a small fleet over many
    replicas), so it does not raise when nothing loads, as an unowned
    collection does."""

    def __init__(self, root: str, target_name: Optional[str] = None, device="cuda", owned=None):
        self.root = root
        self.target_name = target_name
        self.device = device
        self.owned = None if owned is None else set(owned)
        self._state: Tuple[Dict[str, Any], Dict[str, Dict]] = ({}, {})
        self._versions: Dict[str, Any] = {}
        self.load_failures: Dict[str, str] = {}  # the latest scan's failed loads
        # every failed load attempt, summed over scans: a counter whose rate
        # above 0 says an artifact still fails (gordo_models_load_failed_total)
        self.load_failed_total = 0
        changes = self.refresh()
        if not self.models and self.owned is None:
            detail = f"; all artifact loads failed: {changes['failed']}" if changes["failed"] else ""
            raise FileNotFoundError(f"No model artifacts found under {root!r}{detail}")
        if changes["failed"]:
            logger.error("Startup loaded %d models but %d artifacts FAILED: %s",
                         len(self.models), len(changes["failed"]), changes["failed"])

    @property
    def models(self) -> Dict[str, Any]:
        return self._state[0]

    @property
    def metadata(self) -> Dict[str, Dict]:
        return self._state[1]

    def snapshot(self) -> Tuple[Dict[str, Any], Dict[str, Dict]]:
        """One consistent (models, metadata) pair."""
        return self._state

    def entry(self, name: str):
        """(model, metadata) from one state; KeyError for an unknown name."""
        models, metadata = self._state
        return models[name], metadata.get(name, {})

    def names(self) -> List[str]:
        return sorted(self.models)

    def publish(self, updates: Dict[str, Any], note: Optional[Dict[str, Any]] = None) -> None:
        """Publish in-memory replacements of models already in the
        collection, all at once (the streaming plane's recalibration and
        refit: no artifact is written). A replacement stands across
        refreshes until its artifact's version changes. ``note`` is merged
        into each replaced model's metadata under ``online-adaptation``
        with its new total threshold and threshold method (JAX
        ``model_io.py:388-423``)."""
        unknown = [n for n in updates if n not in self.models]
        if unknown:
            raise KeyError(f"cannot publish unknown members: {sorted(unknown)}")
        models, metadata = dict(self.models), dict(self.metadata)
        for name, model in updates.items():
            models[name] = model
            if note is not None:
                meta = dict(metadata.get(name, {}))
                meta["online-adaptation"] = {
                    **note,
                    "total-anomaly-threshold": getattr(model, "total_threshold_", None),
                    "threshold-method": getattr(model, "threshold_method_", None),
                }
                metadata[name] = meta
        self._state = (models, metadata)  # one assignment publishes both

    def restore(self, state: Tuple[Dict[str, Any], Dict[str, Dict]]) -> None:
        """Go back to a :meth:`snapshot` taken before :meth:`publish` (a
        failed adaptation's rollback); a published state is never changed,
        so it is published as it is."""
        self._state = state

    def _scan(self) -> Dict[str, str]:
        """The artifacts under ``root`` this collection owns."""
        on_disk = scan_artifacts(self.root, self.target_name)
        if self.owned is None:
            return on_disk
        return {n: p for n, p in on_disk.items() if n in self.owned}

    def acquire(self, name: str) -> Dict[str, Any]:
        """Own ``name`` (its artifact already under ``root``) and load it;
        idempotent, a refresh on an unowned collection. Raises
        ``FileNotFoundError`` when it does not load: owning nothing would
        swallow the member's traffic."""
        if self.owned is not None:
            self.owned.add(name)
        changes = self.refresh()
        if name not in self.models:
            if self.owned is not None:
                self.owned.discard(name)
            reason = changes["failed"].get(name, "artifact not found on disk")
            raise FileNotFoundError(f"cannot acquire {name!r} under {self.root!r}: {reason}")
        return changes

    def release(self, name: str) -> Dict[str, Any]:
        """Stop owning ``name``: it stops serving here, its artifact stays
        on disk. An unowned collection first owns what it serves. KeyError
        for a member it does not serve."""
        if name not in self.models:
            raise KeyError(f"cannot release unknown member {name!r}")
        if self.owned is None:
            self.owned = set(self.models)
        self.owned.discard(name)
        return self.refresh()

    def refresh(self) -> Dict[str, Any]:
        """Rescan ``root``: ``{"added": [...], "updated": [...], "removed":
        [...], "failed": {name: error}}``. A failed load keeps the name's
        earlier model (if any) and leaves its version unrecorded, so the
        next refresh retries it. So does an artifact whose version changed
        while it was read."""
        on_disk = self._scan()
        models, metadata = dict(self.models), dict(self.metadata)
        versions = dict(self._versions)
        added, updated, removed = [], [], []
        failed: Dict[str, str] = {}
        for name in list(models):
            if name not in on_disk:
                removed.append(name)
                del models[name]
                metadata.pop(name, None)
                versions.pop(name, None)
        for name, path in on_disk.items():
            try:
                version = artifact_version(path)
            except OSError as exc:  # removed between the scan and here
                failed[name] = f"{type(exc).__name__}: {exc}"
                continue
            is_new = name not in models
            if not is_new and version == versions.get(name):
                continue
            try:
                logger.info("Loading model %r from %s", name, path)
                _FP_LOAD.fire()
                model = load(path, device=self.device)
                meta = load_metadata(path)
                if artifact_version(path) != version:
                    raise RuntimeError("the artifact was rewritten while it was read")
            except Exception as exc:
                logger.warning("Failed to load %r from %s: %s", name, path, exc)
                failed[name] = f"{type(exc).__name__}: {exc}"
                continue
            meta.setdefault("name", name)
            models[name], metadata[name] = model, meta
            versions[name] = version
            (added if is_new else updated).append(name)
        self._state = (models, metadata)  # one assignment publishes both
        self._versions = versions
        self.load_failures = dict(failed)
        self.load_failed_total += len(failed)
        if added or updated or removed or failed:
            logger.info("Collection refresh: +%d ~%d -%d !%d (now %d models)",
                        len(added), len(updated), len(removed), len(failed), len(models))
        return {"added": added, "updated": updated, "removed": removed, "failed": failed}
