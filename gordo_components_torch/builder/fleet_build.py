"""Fleet builder: build every machine of a fleet in one process.

Counterpart of ``gordo_components_tpu/builder/fleet_build.py``. Machines
whose model config is exactly the canonical anomaly pipeline
(``extract_fleetable``) train together, one ``FleetTrainer`` stack per
group of identical estimator kwargs (so dense and LSTM machines, and LSTM
machines of different model types or lookbacks, train apart); every other
machine takes the single-model path (``provide_saved_model``). Both paths share the
config-hash build cache, and a failure stays with its machine or group: a
bespoke build that raises, or a group that fails ``group_retries + 1``
times (default 1 retry, env ``GORDO_BUILD_GROUP_RETRIES``), lands in the
report's ``failed`` while the rest ship. Groups train one after another on
the one card.

Not ported yet, and raising (or, for one machine, recorded in ``failed``
with the error): top-level configs that are not detectors, conv models,
cross-validation folds, checkpoint and resume, the distributed gang,
heartbeats (``state_dir``), fault points (``GORDO_FAULTS``) and gang worker
threads (``GORDO_GANG_WIDTH``). The build
trace and metrics registry of the JAX builder are not written.
"""

import copy
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from gordo_components_torch import serializer
from gordo_components_torch.builder.build_model import (
    _mirror_artifact,
    cached_artifact,
    calculate_model_key,
    check_evaluation,
    provide_saved_model,
)
from gordo_components_torch.device import resolve_device
from gordo_components_torch.parallel.fleet import DEFAULT_LEARNING_RATE, FleetTrainer
from gordo_components_torch.utils import metadata_timestamp
from gordo_components_torch.utils.staging import stage_members
from gordo_components_torch.workflow.config import Machine

logger = logging.getLogger(__name__)


class FleetBuildReport(Dict[str, str]):
    """``build_fleet``'s result: name -> artifact dir, plus ``failed``
    (name -> error of the members whose build or group failed for good) and
    ``group_retries`` (retries that then succeeded). ``manifest()`` renders
    the partial-build manifest."""

    SCHEMA = "gordo.fleet-build.manifest/v1"

    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.failed: Dict[str, str] = {}
        self.group_retries: int = 0
        self.gang_width: int = 1

    def manifest(self) -> Dict[str, Any]:
        return {
            "schema": self.SCHEMA,
            "built": dict(self),
            "failed": dict(self.failed),
            "n_built": len(self),
            "n_failed": len(self.failed),
            "group_retries": self.group_retries,
            "gang_width": self.gang_width,
        }


# every spelling of each class a configuration may use: the JAX package's,
# the reference era's and the port's
_AE_PATHS = (
    "gordo_components_tpu.models.AutoEncoder",
    "gordo_components_tpu.models.models.AutoEncoder",
    "gordo_components.model.models.KerasAutoEncoder",
    "gordo_components_torch.models.AutoEncoder",
    "gordo_components_torch.models.models.AutoEncoder",
)
_SEQ_PATHS = {
    t: (f"gordo_components_tpu.models.{t}", f"gordo_components_tpu.models.models.{t}",
        f"gordo_components_torch.models.{t}", f"gordo_components_torch.models.models.{t}")
    + ((f"gordo_components.model.models.Keras{t}",) if t != "ConvAutoEncoder" else ())
    for t in ("LSTMAutoEncoder", "LSTMForecast", "ConvAutoEncoder")
}
_DET_PATHS = (
    "gordo_components_tpu.models.DiffBasedAnomalyDetector",
    "gordo_components_tpu.models.anomaly.DiffBasedAnomalyDetector",
    "gordo_components.model.anomaly.DiffBasedAnomalyDetector",
    "gordo_components_torch.models.DiffBasedAnomalyDetector",
    "gordo_components_torch.models.anomaly.DiffBasedAnomalyDetector",
)
_PIPELINE_PATHS = ("sklearn.pipeline.Pipeline", "gordo_components_torch.models.transformers.Pipeline")
_SCALER_PATHS = (
    "sklearn.preprocessing.MinMaxScaler",
    "gordo_components_tpu.models.transformers.JaxMinMaxScaler",
    "gordo_components_torch.models.transformers.MinMaxScaler",
)
_STANDARD_SCALER_PATHS = (
    "sklearn.preprocessing.StandardScaler",
    "gordo_components_tpu.models.transformers.JaxStandardScaler",
    "gordo_components_torch.models.transformers.StandardScaler",
)
# estimator kwargs the fleet honors exactly as the single build does
_TRAINER_KEYS = frozenset({
    "kind", "epochs", "batch_size", "learning_rate", "optimizer",
    "early_stopping_patience", "early_stopping_min_delta",
    "validation_split", "seed", "compute_dtype", "quantize_rows",
    "loss", "kl_weight",
})
# "input_scaler" is not a user kwarg: extract_fleetable injects it from the
# pipeline's scaler step
_FACTORY_KEYS = frozenset({
    "encoding_dim", "decoding_dim", "encoding_func", "decoding_func",
    "out_func", "dims", "funcs", "encoding_layers", "compression_factor",
    "func", "channels", "kernel_size", "latent_dim", "conv_impl",
})


def extract_fleetable(model_config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The FleetTrainer kwargs of a config that is exactly the canonical
    anomaly pipeline, ``DiffBasedAnomalyDetector(base_estimator=Pipeline(
    scaler, estimator))`` with a default-kwargs min-max or z-score scaler,
    with the routing kwargs added (``input_scaler`` for z-score,
    ``model_type`` for sequence families, the detector's
    ``threshold_quantile``/``require_thresholds``); else None (the
    single-build path). Strict, so that the fleet never changes a config's
    semantics."""
    if not isinstance(model_config, dict) or len(model_config) != 1:
        return None
    (path, kwargs), = model_config.items()
    kwargs = kwargs or {}
    if path not in _DET_PATHS:
        return None
    det_kwargs = {k: v for k, v in kwargs.items() if k != "base_estimator"}
    if set(det_kwargs) - {"threshold_quantile", "require_thresholds"}:
        return None
    base = kwargs.get("base_estimator")
    if not (isinstance(base, dict) and len(base) == 1):
        return None
    (bpath, bkwargs), = base.items()
    if bpath not in _PIPELINE_PATHS:
        return None
    inner = [s[1] if isinstance(s, (list, tuple)) and len(s) == 2 else s
             for s in (bkwargs or {}).get("steps", [])]
    if len(inner) != 2:
        return None
    if _is_path(inner[0], _SCALER_PATHS):
        scaler_kind = "minmax"
    elif _is_path(inner[0], _STANDARD_SCALER_PATHS):
        scaler_kind = "standard"
    else:
        return None
    est = _estimator_kwargs(inner[1])
    if est is None:
        return None
    model_type, ae = est
    honored = _TRAINER_KEYS | _FACTORY_KEYS
    if model_type != "AutoEncoder":
        honored = honored | {"lookback_window"}
    if set(ae) - honored:
        return None
    if scaler_kind != "minmax":
        ae = dict(ae, input_scaler=scaler_kind)
    if model_type != "AutoEncoder":
        ae = dict(ae, model_type=model_type)
    if det_kwargs:
        ae = dict(ae, **det_kwargs)
    return ae


def _is_path(defn, paths) -> bool:
    """True iff ``defn`` names one of ``paths`` with no constructor kwargs."""
    if isinstance(defn, str):
        return defn in paths
    if isinstance(defn, dict) and len(defn) == 1:
        (path, kwargs), = defn.items()
        return path in paths and not kwargs
    return False


def _estimator_kwargs(defn) -> Optional[Tuple[str, Dict[str, Any]]]:
    """(model_type, kwargs) of a recognized estimator definition, else None."""
    if isinstance(defn, str):
        path, kwargs = defn, {}
    elif isinstance(defn, dict) and len(defn) == 1:
        (path, kwargs), = defn.items()
        kwargs = dict(kwargs or {})
    else:
        return None
    if path in _AE_PATHS:
        return "AutoEncoder", kwargs
    for model_type, paths in _SEQ_PATHS.items():
        if path in paths:
            return model_type, kwargs
    return None


def _group_key(ae_kwargs: Dict[str, Any]) -> Tuple:
    """Gang membership key. ``learning_rate`` and the value of
    ``early_stopping_patience`` stack as per-member vectors, so they do not
    split a gang; early stopping on or off does."""
    items = []
    for k, v in sorted(ae_kwargs.items()):
        if k == "learning_rate":
            continue
        if k == "early_stopping_patience":
            if v is not None:
                items.append((k, True))
            continue
        items.append((k, repr(v)))
    return tuple(items)


def _member_hparams_of(ae_kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """The per-member vector knobs, omissions normalized to the engine's
    defaults."""
    hp = {"learning_rate": float(ae_kwargs.get("learning_rate", DEFAULT_LEARNING_RATE))}
    if ae_kwargs.get("early_stopping_patience") is not None:
        hp["early_stopping_patience"] = int(ae_kwargs["early_stopping_patience"])
    return hp


def _refuse_unported(checkpoint_dir, distributed, state_dir) -> None:
    if checkpoint_dir is not None:
        raise NotImplementedError("checkpoint_dir: fleet checkpoint and resume is not ported yet")
    if distributed:
        raise NotImplementedError("distributed: the multi-host gang is not ported yet")
    if state_dir is not None:
        raise NotImplementedError("state_dir: gang heartbeats are not ported yet")
    if os.environ.get("GORDO_FAULTS"):
        raise NotImplementedError("GORDO_FAULTS: fault points are not ported yet")
    if (os.environ.get("GORDO_GANG_WIDTH") or "auto").strip().lower() not in ("auto", "1"):
        raise NotImplementedError("GORDO_GANG_WIDTH: gang worker threads are not ported yet")


def build_fleet(
    machines: List[Any],
    output_dir: str,
    model_register_dir: Optional[str] = None,
    replace_cache: bool = False,
    checkpoint_dir: Optional[str] = None,
    distributed: bool = False,
    state_dir: Optional[str] = None,
    group_retries: Optional[int] = None,
    device="cuda",
) -> FleetBuildReport:
    """Build every machine (a ``Machine`` or its dict) on ``device``;
    returns a :class:`FleetBuildReport`."""
    device = resolve_device(device)
    _refuse_unported(checkpoint_dir, distributed, state_dir)
    if group_retries is None:
        group_retries = int(os.environ.get("GORDO_BUILD_GROUP_RETRIES", "1"))
    results = FleetBuildReport()
    groups: Dict[Tuple, List[Tuple[Machine, Dict[str, Any]]]] = {}
    for machine in machines:
        if isinstance(machine, dict):
            machine = Machine.from_dict(machine)
        ae_kwargs = extract_fleetable(machine.model)
        # a dataset with target tags supervises X -> y, and cross_val_only
        # wants an untrained artifact: both take the single-build path
        if ae_kwargs is not None and (machine.dataset or {}).get("target_tag_list"):
            ae_kwargs = None
        if ae_kwargs is not None and (machine.evaluation or {}).get("cv_mode") == "cross_val_only":
            ae_kwargs = None
        if ae_kwargs is None:
            logger.info("Machine %s: bespoke config, single-build path", machine.name)
            try:
                results[machine.name] = provide_saved_model(
                    machine.name, machine.model, machine.dataset, machine.metadata,
                    output_dir=os.path.join(output_dir, machine.name),
                    model_register_dir=model_register_dir, replace_cache=replace_cache,
                    evaluation_config=machine.evaluation or None, device=device,
                )
            except Exception as exc:  # one machine's failure stays its own
                results.failed[machine.name] = f"{type(exc).__name__}: {exc}"
                logger.error("Machine %s: single build FAILED (%s); the others continue",
                             machine.name, exc, exc_info=True)
            continue
        try:
            check_evaluation(machine.evaluation or None)
        except NotImplementedError as exc:
            results.failed[machine.name] = f"{type(exc).__name__}: {exc}"
            continue
        groups.setdefault(_group_key(ae_kwargs), []).append((machine, ae_kwargs))

    for group in groups.values():
        for attempt in range(group_retries + 1):
            try:
                _build_fleet_group(group, output_dir, model_register_dir, replace_cache,
                                   results, device)
                break
            except Exception as exc:
                if attempt < group_retries:
                    results.group_retries += 1
                    logger.warning("Fleet group of %d member(s) failed (attempt %d/%d): %s; retrying",
                                   len(group), attempt + 1, group_retries + 1, exc)
                    continue
                error = f"{type(exc).__name__}: {exc}"
                for m, _kw in group:
                    if m.name not in results:
                        results.failed[m.name] = error
                logger.error("Fleet group of %d member(s) FAILED after %d attempt(s): %s",
                             len(group), group_retries + 1, error, exc_info=True)
    return results


def _build_fleet_group(
    group: List[Tuple[Machine, Dict[str, Any]]],
    output_dir: str,
    model_register_dir: Optional[str],
    replace_cache: bool,
    results: Dict[str, str],
    device,
) -> None:
    ae_kwargs = copy.deepcopy(group[0][1])
    pending: List[Machine] = []
    member_hparams: Dict[str, Dict[str, Any]] = {}
    for machine, kw in group:
        key = calculate_model_key(machine.name, machine.model, machine.dataset, machine.metadata)
        cached = None if replace_cache else cached_artifact(model_register_dir, key)
        if cached is not None:
            logger.info("Machine %s: cache hit", machine.name)
            _mirror_artifact(cached, os.path.join(output_dir, machine.name))
            results[machine.name] = cached
            continue
        pending.append(machine)
        member_hparams[machine.name] = _member_hparams_of(kw)
    if not pending:
        return

    trainer_kwargs = {k: ae_kwargs.pop(k) for k in _TRAINER_KEYS if k in ae_kwargs}
    trainer = FleetTrainer(device=device, **trainer_kwargs, **ae_kwargs)
    t0 = time.time()
    loaded = stage_members([dict(m.dataset) for m in pending])
    member_data = {m.name: X for m, (X, _meta) in zip(pending, loaded)}
    datasets_meta = {m.name: meta for m, (_X, meta) in zip(pending, loaded)}
    load_elapsed = time.time() - t0

    t1 = time.time()
    fleet_models = trainer.fit(member_data, member_hparams=member_hparams)
    train_elapsed = time.time() - t1

    for machine in pending:
        name = machine.name
        fm = fleet_models[name]
        det = fm.to_estimator()
        key = calculate_model_key(name, machine.model, machine.dataset, machine.metadata)
        metadata = {
            "name": name,
            "checked_at": metadata_timestamp(),
            "dataset": datasets_meta[name],
            "model": {
                "model_config": machine.model,
                "fleet_trained": True,
                "fleet_stats": trainer.last_stats,
                "data_query_duration_sec": load_elapsed / len(pending),
                "model_training_duration_sec": train_elapsed / len(pending),
                "history": fm.history,
                "model_builder_cache_key": key,
                "trained": True,
                **det.get_metadata(),
            },
            "user-defined": machine.metadata,
        }
        dest = os.path.join(model_register_dir, key) if model_register_dir else os.path.join(output_dir, name)
        serializer.dump(det, dest, metadata=metadata)
        _mirror_artifact(dest, os.path.join(output_dir, name))
        results[name] = dest
        logger.info("Machine %s: fleet-built -> %s", name, dest)
