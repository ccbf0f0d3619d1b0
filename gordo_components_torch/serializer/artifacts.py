"""The port's artifact directory.

Counterpart of ``gordo_components_tpu/serializer/artifacts.py``. A port
artifact holds no pickle; it is three files, and a fourth for a built model:

- ``params.npz``    — network weights under the flattened Flax keys, as the
                      JAX package writes them: ``params/Dense_i/kernel``
                      (in, out) and ``params/Dense_i/bias`` for a dense
                      model, ``params/OptimizedLSTMCell_i/{ii,if,ig,io}/kernel``,
                      ``params/OptimizedLSTMCell_i/{hi,hf,hg,ho}/{kernel,bias}``
                      and ``params/Dense_0/...`` for an LSTM stack,
                      ``params/Conv_i/kernel`` (K, F_in, C), ``.../bias`` and
                      ``params/ConvTranspose_j/...`` for a conv
                      autoencoder, ``params/{enc_i,mu,logvar,dec_j,out}/...``
                      for a variational one;
- ``detector.json`` — registry type, kind, factory kwargs, ``n_features``,
                      ``lookback`` and ``target_offset`` (absent in
                      directories that predate sequence models, which read
                      as 1 and 0), tags and thresholds;
- ``scalers.npz``   — ``in_shift``, ``in_scale``, ``err_shift``, ``err_scale``;
- ``metadata.json`` — the build metadata the builders record (name,
                      dataset, model config, training history, durations),
                      when the artifact was built rather than converted.

The format has no untrained detector. A ``cv_mode: cross_val_only`` build
(cross-validation without the final fit) writes ``metadata.json`` alone
(:func:`dump_metadata`), so its directory is no artifact:
``is_artifact_dir`` is false for it, the server's ``scan_artifacts`` skips
it and the build cache (``builder.build_model.cached_artifact``) never
returns it. :func:`load_metadata` reads it.
"""

import json
import os
from typing import Any, Dict, Optional

import numpy as np

from gordo_components_torch.convert import entry_from_numpy, params_to_flax

PARAMS_FILE = "params.npz"
DETECTOR_FILE = "detector.json"
SCALERS_FILE = "scalers.npz"
METADATA_FILE = "metadata.json"
FORMAT = "gordo-torch-artifact/v1"
_SCALERS = ("in_shift", "in_scale", "err_shift", "err_scale")


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        out: Dict[str, np.ndarray] = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): np.asarray(tree)}


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def is_artifact_dir(path: str) -> bool:
    return os.path.exists(os.path.join(path, DETECTOR_FILE))


def check_artifact_model(model) -> None:
    """Raise for a model the port cannot write as an artifact: anything
    but a detector with ``to_entry`` (a ``DiffBasedAnomalyDetector``)."""
    if not hasattr(model, "to_entry"):
        raise NotImplementedError(
            f"{type(model).__name__}: artifacts for a top-level model that is not a "
            "DiffBasedAnomalyDetector (a bare Pipeline or estimator) are not ported yet"
        )


def dump(obj, dest_dir: str, metadata: Optional[Dict[str, Any]] = None) -> None:
    """Write ``obj`` as an artifact directory at ``dest_dir``: a bank entry
    (``server/bank._BankEntry``) or a fitted detector (through its
    ``to_entry()``), with the build ``metadata`` in ``metadata.json``.
    Anything else raises ``NotImplementedError`` before a file is written."""
    from gordo_components_torch.server.bank import _BankEntry

    if isinstance(obj, _BankEntry):
        entry = obj
    else:
        check_artifact_model(obj)
        entry = obj.to_entry(os.path.basename(os.path.normpath(dest_dir)))
    os.makedirs(dest_dir, exist_ok=True)
    np.savez(
        os.path.join(dest_dir, PARAMS_FILE),
        **_flatten(params_to_flax(entry.params)),
    )
    np.savez(
        os.path.join(dest_dir, SCALERS_FILE),
        **{k: np.asarray(getattr(entry, k), np.float32) for k in _SCALERS},
    )
    meta = {
        "format": FORMAT,
        "registry_type": entry.registry_type,
        "kind": entry.kind,
        "factory_kwargs": entry.factory_kwargs,
        "n_features": entry.n_features,
        "lookback": entry.lookback,
        "target_offset": entry.target_offset,
        "compute_dtype": entry.compute_dtype,
        "tags": list(entry.tags),
        "thresholds": entry.thresholds,
    }
    with open(os.path.join(dest_dir, DETECTOR_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    if metadata is not None:
        with open(os.path.join(dest_dir, METADATA_FILE), "w") as f:
            json.dump(metadata, f, default=str, indent=2)


def dump_metadata(dest_dir: str, metadata: Dict[str, Any]) -> None:
    """Write the build ``metadata`` of a build that trained no model to
    ``dest_dir``, and remove an earlier artifact's files there, so the
    directory is no artifact."""
    os.makedirs(dest_dir, exist_ok=True)
    for fname in (PARAMS_FILE, SCALERS_FILE, DETECTOR_FILE):
        if os.path.exists(os.path.join(dest_dir, fname)):
            os.remove(os.path.join(dest_dir, fname))
    with open(os.path.join(dest_dir, METADATA_FILE), "w") as f:
        json.dump(metadata, f, default=str, indent=2)


def _load_detector(source_dir: str) -> Dict[str, Any]:
    with open(os.path.join(source_dir, DETECTOR_FILE)) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{source_dir}: not a {FORMAT} artifact (format={meta.get('format')!r})")
    return meta


def load_metadata(source_dir: str) -> Dict[str, Any]:
    """The artifact's ``detector.json`` fields, with the build metadata of
    ``metadata.json`` (when present) beside them; for a directory that
    holds ``metadata.json`` alone (a build that trained no model), that."""
    path = os.path.join(source_dir, METADATA_FILE)
    meta = {} if os.path.exists(path) and not is_artifact_dir(source_dir) else _load_detector(source_dir)
    if os.path.exists(path):
        with open(path) as f:
            meta = {**json.load(f), **meta}
    return meta


def load_entry(source_dir: str, name: Optional[str] = None):
    """The artifact at ``source_dir`` as a bank entry (numpy, no device);
    ``name`` defaults to the directory's basename."""
    meta = _load_detector(source_dir)
    with np.load(os.path.join(source_dir, PARAMS_FILE)) as npz:
        params = _unflatten({k: npz[k] for k in npz.files})
    with np.load(os.path.join(source_dir, SCALERS_FILE)) as npz:
        scalers = {k: npz[k] for k in _SCALERS}
    return entry_from_numpy(
        name or os.path.basename(os.path.normpath(source_dir)),
        meta["registry_type"],
        meta["kind"],
        meta.get("factory_kwargs") or {},
        meta["n_features"],
        params,
        tags=meta.get("tags"),
        thresholds=meta.get("thresholds"),
        lookback=meta.get("lookback", 1),
        target_offset=meta.get("target_offset", 0),
        compute_dtype=meta.get("compute_dtype", "float32"),
        **scalers,
    )


def load(source_dir: str, device="cuda"):
    """The artifact at ``source_dir`` as a
    :class:`~gordo_components_torch.models.anomaly.diff.DiffBasedAnomalyDetector`
    on ``device``."""
    from gordo_components_torch.models.anomaly.diff import DiffBasedAnomalyDetector

    return DiffBasedAnomalyDetector.from_entry(load_entry(source_dir), device=device)
