"""The port's artifact directory.

Counterpart of ``gordo_components_tpu/serializer/artifacts.py``. A port
artifact holds no pickle. A detector's is three files, and a fourth for a
built model:

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

A top-level model that is not a detector (a bare estimator, a bare
``Pipeline`` of transformers and an estimator, or a
``TransformedTargetRegressor`` over either, all legal model configs) writes
``model.json`` in place of ``detector.json``: the same ``format``, its
``model_type`` (``"estimator"``, ``"Pipeline"`` or
``"TransformedTargetRegressor"``), the estimator's registry type, kind,
factory kwargs, ``n_features``, ``lookback``, ``target_offset``,
``compute_dtype`` and constructor arguments (``estimator_params``), and for
a Pipeline its ``steps`` and the estimator step's name. A regressor's
``transformer`` and its own arguments (``ttr``) go beside them, and
``regressor_type`` says whether the regressor is an estimator or a
Pipeline. Its weights are in ``params.npz`` as above.

Each transformer step is described by its ``name``, ``class`` and
constructor ``kwargs`` (a ``FeatureUnion`` also by its
``transformer_list``, each child described the same way, ``"drop"`` by
its ``class``), and its fitted state goes into
``scalers.npz`` keyed by its path: ``steps/<i>/<attr>``,
``steps/<i>/transformer_list/<j>/<attr>``, ``transformer/<attr>``. A
scaler's state is ``shift`` and ``scale`` (``(x - shift) * scale``) and
sklearn's fitted attributes it keeps (``center_``, ``scale_``,
``max_abs_``); PCA's ``components_``, ``mean_``, ``explained_variance_``,
``n_components_`` and the rest of sklearn's.

A detector whose pipeline has a step that is not affine (``PCA``,
``FeatureUnion``, a clipping scaler) has no bank entry. Its
``detector.json`` holds the estimator's fields, its ``preprocessing``
steps, ``estimator_step``, tags and thresholds, and its ``scalers.npz``
``err_shift``, ``err_scale`` and the steps' state; it loads as a detector
over the rebuilt pipeline, which scores in model space.
:func:`load` returns the class that was dumped: a detector, a
``Pipeline``, a ``TransformedTargetRegressor`` or an estimator.

:func:`dumps` and :func:`loads` carry a model as bytes (the server's
``download-model``). The JAX package pickles the object there; the port
writes no pickle, so its bytes are the artifact directory as a gzipped tar
(:func:`pack_artifact_dir`, :func:`unpack_artifact_dir`, the JAX server's
shipping format with its checks of member names), and only the port's
:func:`loads` reads them.

The format has no untrained detector. A ``cv_mode: cross_val_only`` build
(cross-validation without the final fit) writes ``metadata.json`` alone
(:func:`dump_metadata`), so its directory is no artifact:
``is_artifact_dir`` is false for it, the server's ``scan_artifacts`` skips
it and the build cache (``builder.build_model.cached_artifact``) never
returns it. :func:`load_metadata` reads it.

A directory that is being served is rewritten in place, so a rewrite never
leaves it without a whole artifact (:func:`dump`, :func:`copy_artifact`).
Each data file (``params.npz``, ``scalers.npz``, ``metadata.json``) is
written under a temporary name in the directory and renamed over the old
one; the descriptor (``detector.json`` or ``model.json``) comes last, the
same way, with a build ``stamp`` and the sha256 of each data file
(``digests``). The old descriptor stays until the new one replaces it; a
descriptor of the other kind is removed after. :func:`load` checks each
data file against the descriptor's digests and raises on a mismatch, so a
reader that comes in the middle of a rewrite gets an error, never a mix of
two builds. A descriptor without a stamp (written before the port stamped
them) loads unchecked.
"""

import hashlib
import io
import json
import os
import shutil
import tarfile
import tempfile
import uuid
from typing import Any, Callable, Dict, Optional

import numpy as np

from gordo_components_torch.convert import entry_from_numpy, estimator_from_numpy, params_to_flax

PARAMS_FILE = "params.npz"
DETECTOR_FILE = "detector.json"
MODEL_FILE = "model.json"
SCALERS_FILE = "scalers.npz"
METADATA_FILE = "metadata.json"
DESCRIPTOR_FILES = (DETECTOR_FILE, MODEL_FILE)
ARTIFACT_FILES = (PARAMS_FILE, SCALERS_FILE, DETECTOR_FILE, MODEL_FILE)
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
    return any(os.path.exists(os.path.join(path, f)) for f in DESCRIPTOR_FILES)


def _descriptor_path(path: str) -> str:
    detector = os.path.join(path, DETECTOR_FILE)
    return detector if os.path.exists(detector) else os.path.join(path, MODEL_FILE)


def artifact_version(path: str):
    """What tells one version of the artifact at ``path`` from another: the
    descriptor's build ``stamp`` (None before stamps) and the newest
    modification time of the artifact's files (a data file rewritten under
    the same descriptor is read again, and fails its digest); OSError when
    no artifact file is there or the descriptor cannot be read."""
    times = [os.path.getmtime(os.path.join(path, f)) for f in (*ARTIFACT_FILES, METADATA_FILE)
             if os.path.exists(os.path.join(path, f))]
    if not times:
        raise FileNotFoundError(f"no artifact files under {path!r}")
    with open(_descriptor_path(path)) as f:
        try:
            stamp = json.load(f).get("stamp")
        except ValueError:
            stamp = None  # load reports the broken descriptor
    return stamp, max(times)


def _sha256(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            digest.update(block)
    return digest.hexdigest()


def _replace_into(dest_dir: str, fname: str, write: Callable[[str], None]) -> str:
    """``write`` a temporary file in ``dest_dir``, then rename it to
    ``fname`` there; the sha256 of what was written."""
    fd, tmp = tempfile.mkstemp(prefix=f".{fname}.", suffix=".tmp", dir=dest_dir)
    os.close(fd)
    try:
        write(tmp)
        digest = _sha256(tmp)
        os.replace(tmp, os.path.join(dest_dir, fname))
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return digest


def _npz_writer(arrays: Dict[str, np.ndarray]) -> Callable[[str], None]:
    def write(tmp: str) -> None:
        with open(tmp, "wb") as f:  # a path would get ".npz" appended
            np.savez(f, **arrays)
    return write


def _json_writer(obj: Dict[str, Any]) -> Callable[[str], None]:
    def write(tmp: str) -> None:
        with open(tmp, "w") as f:
            json.dump(obj, f, default=str, indent=2)
    return write


def _remove(dest_dir: str, fnames) -> None:
    for fname in fnames:
        if os.path.exists(os.path.join(dest_dir, fname)):
            os.remove(os.path.join(dest_dir, fname))


def _commit(dest_dir: str, data: Dict[str, Callable[[str], None]], descriptor_file: str,
            descriptor: Dict[str, Any]) -> None:
    """Write the ``data`` files, then the descriptor with a new stamp and
    their digests, each renamed into ``dest_dir`` whole; then remove what
    the new artifact does not hold (the other descriptor, a data file it
    did not write)."""
    os.makedirs(dest_dir, exist_ok=True)
    digests = {fname: _replace_into(dest_dir, fname, write) for fname, write in data.items()}
    _replace_into(dest_dir, descriptor_file,
                  _json_writer({**descriptor, "stamp": uuid.uuid4().hex, "digests": digests}))
    _remove(dest_dir, [f for f in ARTIFACT_FILES if f != descriptor_file and f not in data])


def copy_artifact(src_dir: str, dest_dir: str) -> None:
    """Copy the artifact at ``src_dir`` over the one at ``dest_dir`` (file
    times kept): every file renamed in whole, the descriptor last, then the
    files ``src_dir`` does not hold removed."""
    os.makedirs(dest_dir, exist_ok=True)
    names = [f for f in os.listdir(src_dir)
             if not f.startswith(".") and os.path.isfile(os.path.join(src_dir, f))]
    for fname in sorted(names, key=lambda f: f in DESCRIPTOR_FILES):
        src = os.path.join(src_dir, fname)
        _replace_into(dest_dir, fname, lambda tmp, src=src: shutil.copy2(src, tmp))
    _remove(dest_dir, [f for f in (*ARTIFACT_FILES, METADATA_FILE) if f not in names])


def _estimator_fields(est) -> Dict[str, Any]:
    from gordo_components_torch.models.models import BaseEstimator, _jsonable

    if not isinstance(est, BaseEstimator):
        raise TypeError(f"{type(est).__name__} is not an estimator of the port")
    if est.params_ is None:
        raise RuntimeError(f"{type(est).__name__} has not been fitted")
    params = {k: v for k, v in est.get_params().items() if k != "device"}
    return {
        "registry_type": type(est).__name__,
        "kind": est.kind,
        "factory_kwargs": _jsonable(est.factory_kwargs),
        "n_features": int(est.n_features_),
        "lookback": int(getattr(est, "lookback_window", 1)),
        "target_offset": int(est._target_offset),
        "compute_dtype": str(est.compute_dtype),
        "estimator_params": _jsonable(params),
    }


def _step_classes():
    from gordo_components_torch.models import compose, transformers

    return {c.__name__: c for c in (transformers.MinMaxScaler, transformers.StandardScaler,
                                    transformers.RobustScaler, transformers.MaxAbsScaler, transformers.PCA,
                                    compose.FeatureUnion)}


def _step_entry(name: str, step, prefix: str, arrays: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """A transformer step's description; its fitted state goes into
    ``arrays`` under ``prefix``. Anything but a fitted transformer of the
    port raises ``TypeError``."""
    if step == "drop":
        return {"name": name, "class": step}
    cls = type(step).__name__
    if _step_classes().get(cls) is not type(step):
        raise TypeError(f"Pipeline step {name!r} ({cls}) is not a fitted scaler or transformer of the port")
    if cls == "FeatureUnion":
        return {"name": name, "class": cls,
                "kwargs": {k: v for k, v in step.get_params().items() if k != "transformer_list"},
                "transformer_list": [_step_entry(n, t, f"{prefix}transformer_list/{j}/", arrays)
                                     for j, (n, t) in enumerate(step.transformer_list)]}
    try:
        state = step.fitted_state()
    except RuntimeError:
        raise TypeError(f"Pipeline step {name!r} ({cls}) is not a fitted scaler or transformer of the port") from None
    arrays.update({prefix + k: np.asarray(v) for k, v in state.items()})
    return {"name": name, "class": cls, "kwargs": step.get_params()}


def _step_from_entry(entry: Dict[str, Any], prefix: str, arrays: Dict[str, np.ndarray]):
    """Inverse of :func:`_step_entry`."""
    cls = entry["class"]
    if cls == "drop":
        return cls
    if cls == "FeatureUnion":
        children = [(c["name"], _step_from_entry(c, f"{prefix}transformer_list/{j}/", arrays))
                    for j, c in enumerate(entry["transformer_list"])]
        return _step_classes()[cls](children, **entry.get("kwargs", {}))
    if cls not in _step_classes():
        raise ValueError(f"{cls!r} is not a transformer of the port")
    state = {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix) and "/" not in k[len(prefix):]}
    return _step_classes()[cls](**(entry.get("kwargs") or {})).set_fitted_state(state)


def _pipeline_fields(pipeline, arrays: Dict[str, np.ndarray], key: str = "steps"):
    """(``{key: step descriptions, "estimator_step": name}``, the
    pipeline's estimator)."""
    *pre, (est_name, est) = pipeline.steps
    steps = [_step_entry(n, step, f"steps/{i}/", arrays) for i, (n, step) in enumerate(pre)]
    return {key: steps, "estimator_step": est_name}, est


def _model_files(model):
    """A bare Pipeline, transformed-target regressor or estimator's data
    files (``params.npz`` and, with transformers, ``scalers.npz``) and its
    ``model.json``."""
    from gordo_components_torch.models.compose import TransformedTargetRegressor
    from gordo_components_torch.models.transformers import Pipeline

    meta: Dict[str, Any] = {"format": FORMAT}
    scalers: Dict[str, np.ndarray] = {}
    if isinstance(model, TransformedTargetRegressor):
        meta.update(model_type="TransformedTargetRegressor",
                    ttr={"check_inverse": model.check_inverse, "training_dim": model._training_dim},
                    transformer=None if model.transformer is None
                    else _step_entry("transformer", model.transformer, "transformer/", scalers))
        model = model.regressor
        meta["regressor_type"] = "Pipeline" if isinstance(model, Pipeline) else "estimator"
    if isinstance(model, Pipeline):
        fields, est = _pipeline_fields(model, scalers)
        meta.update(fields)
        meta.setdefault("model_type", "Pipeline")
    else:
        est = model
        meta.setdefault("model_type", "estimator")
    meta.update(_estimator_fields(est))
    data = {PARAMS_FILE: _npz_writer(_flatten(params_to_flax(est.params_)))}
    if scalers:
        data[SCALERS_FILE] = _npz_writer(scalers)
    return data, meta


def _model_space_detector_files(det):
    """A detector over a pipeline that is not affine: its data files and
    its ``detector.json``."""
    det._check_fitted()
    scalers = {"err_shift": np.asarray(det.error_scaler_.shift, np.float32),
               "err_scale": np.asarray(det.error_scaler_.scale, np.float32)}
    fields, est = _pipeline_fields(det.base_estimator, scalers, key="preprocessing")
    descriptor = {"format": FORMAT, **fields, **_estimator_fields(est), "tags": list(det.tags_ or []),
                  "thresholds": det._thresholds()}
    data = {PARAMS_FILE: _npz_writer(_flatten(params_to_flax(est.params_))), SCALERS_FILE: _npz_writer(scalers)}
    return data, descriptor


def dump(obj, dest_dir: str, metadata: Optional[Dict[str, Any]] = None) -> None:
    """Write ``obj`` as an artifact directory at ``dest_dir``, with the
    build ``metadata`` in ``metadata.json``: a bank entry
    (``server/bank._BankEntry``) or a fitted detector (through its
    ``to_entry()``, or its pipeline where a step is not affine) as
    ``detector.json``; a fitted bare estimator, ``Pipeline`` of the port's
    transformers and an estimator, or ``TransformedTargetRegressor`` as
    ``model.json``. Anything else raises before a file is written. The
    artifact that was at ``dest_dir`` stays whole until the new descriptor
    replaces it."""
    from gordo_components_torch.server.bank import _BankEntry

    if getattr(obj, "non_affine_step", None) is not None:
        data, descriptor = _model_space_detector_files(obj)
        descriptor_file = DETECTOR_FILE
    elif isinstance(obj, _BankEntry) or hasattr(obj, "to_entry"):
        entry = obj if isinstance(obj, _BankEntry) else obj.to_entry(
            os.path.basename(os.path.normpath(dest_dir)))
        data = {
            PARAMS_FILE: _npz_writer(_flatten(params_to_flax(entry.params))),
            SCALERS_FILE: _npz_writer({k: np.asarray(getattr(entry, k), np.float32) for k in _SCALERS}),
        }
        descriptor_file, descriptor = DETECTOR_FILE, {
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
    else:
        data, descriptor = _model_files(obj)
        descriptor_file = MODEL_FILE
    if metadata is not None:
        data[METADATA_FILE] = _json_writer(metadata)
    _commit(dest_dir, data, descriptor_file, descriptor)


def dump_metadata(dest_dir: str, metadata: Dict[str, Any]) -> None:
    """Write the build ``metadata`` of a build that trained no model to
    ``dest_dir``, and remove an earlier artifact's files there, so the
    directory is no artifact."""
    os.makedirs(dest_dir, exist_ok=True)
    _remove(dest_dir, (*DESCRIPTOR_FILES, PARAMS_FILE, SCALERS_FILE))  # the descriptor first
    _replace_into(dest_dir, METADATA_FILE, _json_writer(metadata))


def _read_format(path: str) -> Dict[str, Any]:
    with open(path) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} artifact (format={meta.get('format')!r})")
    return meta


def _load_detector(source_dir: str) -> Dict[str, Any]:
    return _read_format(os.path.join(source_dir, DETECTOR_FILE))


def _is_detector(source_dir: str) -> bool:
    return os.path.exists(os.path.join(source_dir, DETECTOR_FILE))


def _read_checked(source_dir: str, fname: str, meta: Dict[str, Any]) -> bytes:
    """The bytes of ``fname``, checked against the digest the descriptor
    ``meta`` records for it (when it records one)."""
    path = os.path.join(source_dir, fname)
    with open(path, "rb") as f:
        raw = f.read()
    want = (meta.get("digests") or {}).get(fname)
    if want is not None and hashlib.sha256(raw).hexdigest() != want:
        raise ValueError(f"{path}: its sha256 is not the one the descriptor records for build "
                         f"{meta.get('stamp')} (the artifact is being rewritten, or is corrupt)")
    return raw


def load_metadata(source_dir: str) -> Dict[str, Any]:
    """The artifact's ``detector.json`` or ``model.json`` fields, with the
    build metadata of ``metadata.json`` (when present) beside them; for a
    directory that holds ``metadata.json`` alone (a build that trained no
    model), that."""
    path = os.path.join(source_dir, METADATA_FILE)
    if not is_artifact_dir(source_dir):
        meta = {} if os.path.exists(path) else _load_detector(source_dir)
    elif _is_detector(source_dir):
        meta = _load_detector(source_dir)
    else:
        meta = _read_format(os.path.join(source_dir, MODEL_FILE))
    if os.path.exists(path):
        meta = {**json.loads(_read_checked(source_dir, METADATA_FILE, meta)), **meta}
    meta.pop("digests", None)
    meta.pop("stamp", None)
    return meta


def _load_npz(source_dir: str, fname: str, meta: Dict[str, Any]) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(_read_checked(source_dir, fname, meta))) as npz:
        return {k: npz[k] for k in npz.files}


def _load_params(source_dir: str, meta: Dict[str, Any]) -> Dict[str, Any]:
    return _unflatten(_load_npz(source_dir, PARAMS_FILE, meta))


def load_entry(source_dir: str, name: Optional[str] = None):
    """The detector artifact at ``source_dir`` as a bank entry (numpy, no
    device); ``name`` defaults to the directory's basename. A detector
    over a pipeline that is not affine has none: ``ValueError``."""
    meta = _load_detector(source_dir)
    if "preprocessing" in meta:
        raise ValueError(f"{source_dir}: a detector over a pipeline that is not affine has no bank entry")
    params = _load_params(source_dir, meta)
    npz = _load_npz(source_dir, SCALERS_FILE, meta)
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


def _load_estimator(source_dir: str, meta: Dict[str, Any], device):
    return estimator_from_numpy(
        meta["registry_type"], meta["kind"], meta.get("factory_kwargs") or {}, meta["n_features"],
        _load_params(source_dir, meta), lookback=meta.get("lookback", 1),
        target_offset=meta.get("target_offset", 0), compute_dtype=meta.get("compute_dtype", "float32"),
        estimator_params=meta.get("estimator_params"), device=device,
    )


def _load_pipeline(source_dir: str, meta: Dict[str, Any], est, key: str = "steps"):
    from gordo_components_torch.models.transformers import Pipeline

    arrays = _load_npz(source_dir, SCALERS_FILE, meta) if meta[key] else {}
    steps = [(step["name"], _step_from_entry(step, f"steps/{i}/", arrays)) for i, step in enumerate(meta[key])]
    return Pipeline(steps + [(meta["estimator_step"], est)])


def _load_model(source_dir: str, device):
    meta = _read_format(os.path.join(source_dir, MODEL_FILE))
    est = _load_estimator(source_dir, meta, device)
    model_type = meta.get("model_type")
    if model_type == "estimator":
        return est
    if model_type == "Pipeline":
        return _load_pipeline(source_dir, meta, est)
    if model_type != "TransformedTargetRegressor":
        raise ValueError(f"{source_dir}: unknown model_type {model_type!r}")
    from gordo_components_torch.models.compose import TransformedTargetRegressor

    regressor = _load_pipeline(source_dir, meta, est) if meta["regressor_type"] == "Pipeline" else est
    transformer = None
    if meta.get("transformer") is not None:
        transformer = _step_from_entry(meta["transformer"], "transformer/", _load_npz(source_dir, SCALERS_FILE, meta))
    ttr = TransformedTargetRegressor(regressor=regressor, transformer=transformer,
                                     check_inverse=meta["ttr"]["check_inverse"])
    ttr._training_dim = meta["ttr"]["training_dim"]
    return ttr


def _load_model_space_detector(source_dir: str, meta: Dict[str, Any], device):
    from gordo_components_torch.models.anomaly.diff import DiffBasedAnomalyDetector
    from gordo_components_torch.ops.scaler import ScalerParams

    det = DiffBasedAnomalyDetector(
        base_estimator=_load_pipeline(source_dir, meta, _load_estimator(source_dir, meta, device), "preprocessing"))
    npz = _load_npz(source_dir, SCALERS_FILE, meta)
    det.error_scaler_ = ScalerParams(npz["err_shift"], npz["err_scale"])
    det.tags_ = list(meta["tags"])
    det._set_thresholds(meta.get("thresholds"))
    return det


def load(source_dir: str, device="cuda"):
    """The artifact at ``source_dir`` on ``device``, as the class that was
    dumped: a
    :class:`~gordo_components_torch.models.anomaly.diff.DiffBasedAnomalyDetector`
    for ``detector.json``, a ``Pipeline``, a ``TransformedTargetRegressor``
    or a bare estimator for ``model.json``. A data file that does not match the descriptor's digest
    raises ``ValueError``."""
    from gordo_components_torch.device import resolve_device
    from gordo_components_torch.models.anomaly.diff import DiffBasedAnomalyDetector

    device = resolve_device(device)
    if _is_detector(source_dir):
        meta = _load_detector(source_dir)
        if "preprocessing" in meta:
            return _load_model_space_detector(source_dir, meta, device)
        return DiffBasedAnomalyDetector.from_entry(load_entry(source_dir), device=device)
    return _load_model(source_dir, device)


def pack_artifact_dir(path: str) -> bytes:
    """An artifact directory as a gzipped tar, its member names relative to
    the directory (JAX ``server/model_io.pack_artifact_dir``)."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for entry in sorted(os.listdir(path)):
            tar.add(os.path.join(path, entry), arcname=entry)
    return buf.getvalue()


def unpack_artifact_dir(raw: bytes, dest: str) -> None:
    """Extract an artifact archive under ``dest``. Every member name is
    checked first: an absolute path, a ``..`` part, a link or a device
    refuses the whole archive (JAX ``server/model_io.unpack_artifact_dir``)."""
    os.makedirs(dest, exist_ok=True)
    with tarfile.open(fileobj=io.BytesIO(raw), mode="r:gz") as tar:
        members = tar.getmembers()
        for member in members:
            name = member.name
            if os.path.isabs(name) or ".." in name.split("/") or not (member.isfile() or member.isdir()):
                raise ValueError(f"refusing artifact archive member {name!r} (unsafe path or non-file entry)")
        for member in members:
            tar.extract(member, dest, set_attrs=False, filter="data")


def dumps(model) -> bytes:
    """``model`` (anything :func:`dump` writes) as the bytes of its artifact
    directory, a gzipped tar."""
    with tempfile.TemporaryDirectory() as tmp:
        dump(model, tmp)
        return pack_artifact_dir(tmp)


def loads(data: bytes, device="cuda"):
    """Inverse of :func:`dumps`: the model on ``device``."""
    with tempfile.TemporaryDirectory() as tmp:
        unpack_artifact_dir(data, tmp)
        return load(tmp, device=device)
