"""Train-one-model pipeline.

Counterpart of ``build_model``, ``calculate_model_key``,
``provide_saved_model`` and ``_mirror_artifact`` in
``gordo_components_tpu/builder/build_model.py``: dataset -> the model the
config defines (``serializer.from_definition``) -> fit on ``device`` ->
build metadata -> a port artifact, with a config-hash build cache so a
rerun skips machines whose artifact already exists.

Cross-validation (``evaluation_config`` asking for folds, or
``cv_mode="cross_val_only"``) is not ported yet and raises, and so does a
model config that is not a ``DiffBasedAnomalyDetector``: its artifact has
no port format yet (``serializer.check_artifact_model``), so the build
refuses it before loading data.
"""

import hashlib
import json
import logging
import os
import shutil
import time
from typing import Any, Dict, Optional, Tuple

import torch

from gordo_components_torch import __version__, serializer
from gordo_components_torch.dataset import get_dataset
from gordo_components_torch.device import resolve_device
from gordo_components_torch.utils import metadata_timestamp

logger = logging.getLogger(__name__)


def check_evaluation(evaluation_config: Optional[Dict[str, Any]]) -> None:
    """Raise for an evaluation the port cannot run: cross-validation."""
    evaluation = evaluation_config or {}
    wants_folds = evaluation.get("cross_validation") and int(evaluation.get("n_splits", 3)) > 0
    if wants_folds or evaluation.get("cv_mode") == "cross_val_only":
        raise NotImplementedError("cross-validation is not ported yet")


def place(model, device) -> None:
    """Point the estimator at the end of ``model`` (a detector's base
    estimator, a pipeline's last step) at ``device``."""
    est = model
    while True:
        if hasattr(est, "base_estimator") and est.base_estimator is not None:
            est = est.base_estimator
        elif hasattr(est, "steps"):
            est = est.steps[-1][1]
        else:
            break
    if hasattr(est, "device"):
        est.device = device


def device_memory_stats(device: torch.device) -> Dict[str, Any]:
    if device.type != "cuda":
        return {"device": str(device)}
    return {
        "device": torch.cuda.get_device_name(device),
        "peak_bytes_allocated": int(torch.cuda.max_memory_allocated(device)),
    }


def build_model(
    name: str,
    model_config: Dict[str, Any],
    data_config: Dict[str, Any],
    metadata: Optional[Dict[str, Any]] = None,
    evaluation_config: Optional[Dict[str, Any]] = None,
    device="cuda",
) -> Tuple[Any, Dict[str, Any]]:
    """Build and train one model on ``device``; returns ``(model, metadata)``.
    Raises ``NotImplementedError`` before loading data for a model that is
    not a detector (``serializer.check_artifact_model``)."""
    device = resolve_device(device)
    check_evaluation(evaluation_config)
    model = serializer.from_definition(model_config)
    serializer.check_artifact_model(model)
    place(model, device)
    t0 = time.time()
    dataset = get_dataset(dict(data_config))
    X, y = dataset.get_data()
    data_elapsed = time.time() - t0

    t1 = time.time()
    model.fit(X, y)
    fit_elapsed = time.time() - t1

    build_metadata = {
        "name": name,
        "gordo_components_torch_version": __version__,
        "checked_at": metadata_timestamp(),
        "dataset": dataset.get_metadata(),
        "model": {
            "model_config": model_config,
            "data_query_duration_sec": data_elapsed,
            "model_training_duration_sec": fit_elapsed,
            "trained": True,
            "device_memory": device_memory_stats(device),
            **model.get_metadata(),
        },
        "user-defined": dict(metadata or {}),
    }
    return model, build_metadata


def _jsonable_config(config: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v.to_dict() if hasattr(v, "to_dict") else v for k, v in config.items()}


def calculate_model_key(
    name: str,
    model_config: Dict[str, Any],
    data_config: Dict[str, Any],
    metadata: Optional[Dict[str, Any]] = None,
) -> str:
    """Deterministic cache key over (name, configs, the port's version)."""
    payload = json.dumps(
        {
            "name": name,
            "model_config": model_config,
            "data_config": _jsonable_config(data_config),
            "metadata": metadata or {},
            "version": __version__,
        },
        sort_keys=True,
        default=str,
    )
    return hashlib.sha256(payload.encode()).hexdigest()


def cached_artifact(model_register_dir: Optional[str], key: str) -> Optional[str]:
    """The registered artifact for ``key``, when one exists; else None."""
    if not model_register_dir:
        return None
    cached = os.path.join(model_register_dir, key)
    return cached if serializer.is_artifact_dir(cached) else None


def provide_saved_model(
    name: str,
    model_config: Dict[str, Any],
    data_config: Dict[str, Any],
    metadata: Optional[Dict[str, Any]] = None,
    output_dir: str = "./model-output",
    model_register_dir: Optional[str] = None,
    replace_cache: bool = False,
    evaluation_config: Optional[Dict[str, Any]] = None,
    device="cuda",
) -> str:
    """Build-or-reuse: the registered artifact for this config hash when
    one exists, else build on ``device``, write the artifact (to the
    register when given, else ``output_dir``) and mirror it to
    ``output_dir``. Returns the artifact directory."""
    device = resolve_device(device)
    check_evaluation(evaluation_config)
    key = calculate_model_key(name, model_config, data_config, metadata)
    cached = None if replace_cache else cached_artifact(model_register_dir, key)
    if cached is not None:
        logger.info("Model %s found in build cache: %s", name, cached)
        _mirror_artifact(cached, output_dir)
        return cached
    model, build_metadata = build_model(
        name, model_config, data_config, metadata, evaluation_config, device=device
    )
    build_metadata["model"]["model_builder_cache_key"] = key
    dest = os.path.join(model_register_dir, key) if model_register_dir else output_dir
    serializer.dump(model, dest, metadata=build_metadata)
    _mirror_artifact(dest, output_dir)
    logger.info("Model %s built and saved to %s", name, dest)
    return dest


def _mirror_artifact(src_dir: str, output_dir: str) -> None:
    """Copy a (possibly cached) registry artifact to the requested output
    location: reruns must still populate the serving directory."""
    if os.path.abspath(src_dir) == os.path.abspath(output_dir):
        return
    os.makedirs(output_dir, exist_ok=True)
    for fname in os.listdir(src_dir):
        shutil.copy2(os.path.join(src_dir, fname), os.path.join(output_dir, fname))
