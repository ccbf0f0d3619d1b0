"""Train-one-model pipeline.

Counterpart of ``gordo_components_tpu/builder/build_model.py``: dataset ->
the model the config defines (``serializer.from_definition``) -> optional
``TimeSeriesSplit`` cross-validation (``builder/splits.py``) -> fit on
``device`` -> build metadata -> a port artifact, with a config-hash build
cache so a rerun skips machines whose artifact already exists.

Cross-validation trains a fresh model from the config for each fold and
records the reference's four metrics per fold under ``cross-validation``.
``cv_mode: cross_val_only`` evaluates without the final fit: the port's
artifact format has no untrained detector, so such a build writes
``metadata.json`` alone, is never registered and never served. A model
config that is not a ``DiffBasedAnomalyDetector`` (a bare ``Pipeline`` or
estimator) builds the same way and is written as ``model.json``
(``serializer/artifacts.py``); its metadata records a Pipeline's final
estimator under ``final_step``, as the JAX builder's does. Under
``GORDO_PROFILE_DIR`` the fit is captured as ``build-<name>``
(``utils/profiling.py``).
"""

import hashlib
import json
import logging
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from gordo_components_torch import __version__, serializer
from gordo_components_torch.builder.splits import TimeSeriesSplit
from gordo_components_torch.dataset import get_dataset
from gordo_components_torch.device import resolve_device
from gordo_components_torch.models.base import score_metrics_of
from gordo_components_torch.utils import metadata_timestamp
from gordo_components_torch.utils.profiling import device_memory_stats, maybe_profile

logger = logging.getLogger(__name__)


def place(model, device) -> None:
    """Point the estimator at the end of ``model`` (a detector's base
    estimator, a pipeline's last step, a transformed-target regressor's
    regressor) at ``device``."""
    est = model
    while True:
        if hasattr(est, "base_estimator") and est.base_estimator is not None:
            est = est.base_estimator
        elif hasattr(est, "steps"):
            est = est.steps[-1][1]
        elif hasattr(est, "regressor"):
            est = est.regressor
        else:
            break
    if hasattr(est, "device"):
        est.device = device


def build_model(
    name: str,
    model_config: Dict[str, Any],
    data_config: Dict[str, Any],
    metadata: Optional[Dict[str, Any]] = None,
    evaluation_config: Optional[Dict[str, Any]] = None,
    device="cuda",
) -> Tuple[Any, Dict[str, Any]]:
    """Build one model on ``device``; returns ``(model, metadata)``.

    ``evaluation_config``: ``{"cv_mode": "full_build" | "cross_val_only",
    "cross_validation": true, "n_splits": 3}``: TimeSeriesSplit
    cross-validation scores in the metadata; ``cross_val_only`` leaves the
    model untrained."""
    device = resolve_device(device)
    evaluation_config = _normalize_evaluation(evaluation_config)
    model = serializer.from_definition(model_config)
    place(model, device)
    t0 = time.time()
    dataset = get_dataset(dict(data_config))
    X, y = dataset.get_data()
    data_elapsed = time.time() - t0

    cv_meta: Dict[str, Any] = {}
    if _wants_cv(evaluation_config):
        cv_meta = _cross_validate(model_config, X, y, int(evaluation_config.get("n_splits", 3)), device)

    t1 = time.time()
    trained = evaluation_config["cv_mode"] != "cross_val_only"
    if trained:
        with maybe_profile(f"build-{name}"):
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
            "trained": trained,
            "device_memory": device_memory_stats(device),
            **model.get_metadata(),
        },
        "user-defined": dict(metadata or {}),
    }
    if cv_meta:
        build_metadata["model"]["cross-validation"] = cv_meta
    return model, build_metadata


def _normalize_evaluation(evaluation_config: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    return {"cv_mode": "full_build", **(evaluation_config or {})}


def _wants_cv(evaluation_config: Dict[str, Any]) -> bool:
    wants = evaluation_config["cv_mode"] == "cross_val_only" or bool(
        evaluation_config.get("cross_validation", False)
    )
    return wants and int(evaluation_config.get("n_splits", 3)) > 0


def cached_cv_satisfied(cached_dir: str, evaluation: Dict[str, Any]) -> bool:
    """True iff the artifact at ``cached_dir`` satisfies ``evaluation``
    (normalized): no cross-validation is asked for, or the artifact records
    as many folds as asked. One rule for the single and the fleet build."""
    if not _wants_cv(evaluation):
        return True
    folds = (
        serializer.load_metadata(cached_dir)
        .get("model", {})
        .get("cross-validation", {})
        .get("explained-variance", {})
        .get("per-fold", [])
    )
    return len(folds) == int(evaluation.get("n_splits", 3))


def summarize_cv_folds(folds) -> Dict[str, Any]:
    """``{mean, std, per-fold}`` of each metric over per-fold metric dicts:
    one shape for the single-build and the fleet's cross-validation."""
    out: Dict[str, Any] = {}
    for key in folds[0] if folds else ():
        vals = [float(f[key]) for f in folds]
        out[key] = {"mean": float(np.mean(vals)), "std": float(np.std(vals)), "per-fold": vals}
    return out


def _cross_validate(model_config, X, y, n_splits: int, device) -> Dict[str, Any]:
    """TimeSeriesSplit cross-validation: each fold trains a fresh model
    from the config on ``device`` and records explained variance, r2, MSE
    and MAE of one prediction pass over its test rows."""
    Xv = X.values if hasattr(X, "values") else np.asarray(X)
    yv = None if y is None else (y.values if hasattr(y, "values") else np.asarray(y))
    folds = []
    t0 = time.time()
    for fold, (train_idx, test_idx) in enumerate(TimeSeriesSplit(n_splits=n_splits).split(Xv)):
        fold_model = serializer.from_definition(model_config)
        place(fold_model, device)
        fold_model.fit(Xv[train_idx], None if yv is None else yv[train_idx])
        metrics = score_metrics_of(fold_model, Xv[test_idx], None if yv is None else yv[test_idx])
        folds.append(metrics)
        logger.info("CV fold %d explained variance: %.4f", fold, metrics["explained-variance"])
    return {"cv_duration_sec": time.time() - t0, **summarize_cv_folds(folds)}


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
    one exists and records the cross-validation asked for, else build on
    ``device``, write the artifact (to the register when given, else
    ``output_dir``) and mirror it to ``output_dir``. Returns the artifact
    directory.

    A ``cross_val_only`` build never takes the cache and is never
    registered: it writes its metadata alone to ``output_dir``."""
    device = resolve_device(device)
    key = calculate_model_key(name, model_config, data_config, metadata)
    # the key leaves the evaluation out: a cached artifact satisfies a
    # cross-validating build only if it records the folds asked for
    evaluation = _normalize_evaluation(evaluation_config)
    cross_val_only = evaluation["cv_mode"] == "cross_val_only"
    cached = None if replace_cache or cross_val_only else cached_artifact(model_register_dir, key)
    if cached is not None and cached_cv_satisfied(cached, evaluation):
        logger.info("Model %s found in build cache: %s", name, cached)
        _mirror_artifact(cached, output_dir)
        return cached
    model, build_metadata = build_model(
        name, model_config, data_config, metadata, evaluation_config, device=device
    )
    build_metadata["model"]["model_builder_cache_key"] = key
    if not build_metadata["model"]["trained"]:
        serializer.dump_metadata(output_dir, build_metadata)
        logger.info("Model %s cross-validated; its metadata saved to %s", name, output_dir)
        return output_dir
    dest = os.path.join(model_register_dir, key) if model_register_dir else output_dir
    serializer.dump(model, dest, metadata=build_metadata)
    _mirror_artifact(dest, output_dir)
    logger.info("Model %s built and saved to %s", name, dest)
    return dest


def _mirror_artifact(src_dir: str, output_dir: str) -> None:
    """Copy a (possibly cached) registry artifact to the requested output
    location: reruns must still populate the serving directory. A server
    reading ``output_dir`` meanwhile keeps the artifact that was there
    (``serializer.copy_artifact``)."""
    if os.path.abspath(src_dir) == os.path.abspath(output_dir):
        return
    serializer.copy_artifact(src_dir, output_dir)
