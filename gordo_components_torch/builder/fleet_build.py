"""Fleet builder: build every machine of a fleet in one process.

Counterpart of ``gordo_components_tpu/builder/fleet_build.py``. Machines
whose model config is exactly the canonical anomaly pipeline
(``extract_fleetable``) train together, one ``FleetTrainer`` stack per
group of identical estimator kwargs (so dense, variational, LSTM and conv
machines, and sequence machines of different model types or lookbacks,
train apart); every other machine takes the single-model path
(``provide_saved_model``). Both paths share the config-hash build cache,
and a failure stays with its machine or group: a bespoke build that raises,
or a group that fails ``group_retries + 1`` times (default 1 retry, env
``GORDO_BUILD_GROUP_RETRIES``), lands in the report's ``failed`` while the
rest ship.

Gang worker threads (``GORDO_GANG_WIDTH``, :func:`resolve_gang_width`):
groups of more than ``GANG_SMALL_MAX`` members train first, one at a time;
the small groups then train on a pool of that many threads, all on the
current stream. ``auto`` is one thread on the card too, where the JAX
package runs four: a small group's fit is paced by its host launches, and
on an H100 four threads built small gangs at 0.69-0.88x one thread's
models/hour (PERF.md, section 6). Each worker enters the build trace
itself (a thread does not inherit the context), and every group's members
draw from their own generators, so a build's artifacts do not depend on
the width.

Cross-validation in a gang: each machine that asks for it adds its
``TimeSeriesSplit`` folds' training rows as extra members of its gang's
``FleetTrainer.fit`` (named with a NUL separator no machine name can hold,
trained with the machine's own learning rate and patience); each fold
member then scores its test rows, and its scores land in the machine's
metadata with ``fleet_cv: True``. Fold members are never written,
registered or reported. A ``cross_val_only`` machine, and a machine whose
folds are too short for its family, take the single-build path.

Preemption and progress, as the JAX builder does them: ``checkpoint_dir``
makes every gang checkpoint its training every ``checkpoint_every`` epochs
and resume it after a restart (``parallel/checkpoint.py``; CV fold members
included); ``state_dir`` publishes the gang's heartbeat
(``workflow/gang_state.py``) through the phases starting, loading,
training (with the epoch), building and done, partial or failed;
``GORDO_FAULTS`` arms the fault points (``resilience/faults.py``, this
module's site ``fleet_build.group`` among them) at entry. Each run records
one build trace, a ``fit:`` span a bucket with its ``checkpoint`` and
``compile`` children, written to ``<output_dir>/build_trace.json`` as
Chrome trace-event JSON (on the crash path too), and counts its models in
``gordo_build_models_built_total{path}`` and
``gordo_build_cache_hits_total`` of the process registry. Under
``GORDO_PROFILE_DIR`` each gang's fit is captured as
``fleet-gang-<n>m`` (``utils/profiling.py``).

Not ported yet, and raising: the distributed gang (``distributed``).
"""

import concurrent.futures
import copy
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from gordo_components_torch import serializer
from gordo_components_torch.builder.build_model import (
    _mirror_artifact,
    _normalize_evaluation,
    _wants_cv,
    cached_artifact,
    cached_cv_satisfied,
    calculate_model_key,
    provide_saved_model,
    summarize_cv_folds,
)
from gordo_components_torch.builder.splits import TimeSeriesSplit
from gordo_components_torch.device import resolve_device
from gordo_components_torch.observability.metrics import get_registry
from gordo_components_torch.observability.tracing import chrome_trace, get_tracer, use_trace
from gordo_components_torch.parallel.fleet import DEFAULT_LEARNING_RATE, FleetTrainer, _family_defaults
from gordo_components_torch.resilience.faults import configure_from_env, faultpoint
from gordo_components_torch.utils import metadata_timestamp
from gordo_components_torch.utils.profiling import device_memory_stats, maybe_profile
from gordo_components_torch.utils.staging import stage_members
from gordo_components_torch.workflow.config import Machine
from gordo_components_torch.workflow.gang_state import GangHeartbeat

logger = logging.getLogger(__name__)

# one poisoned group's training degrades to a partial manifest, never
# aborts the gang
_FP_GROUP = faultpoint("fleet_build.group")

# groups of at most this many members are small: their wall time is mostly
# host work (staging, stacking, launches), so several train at once; larger
# groups fill the card alone and train one at a time
GANG_SMALL_MAX = 32
GANG_WIDTH_ENV = "GORDO_GANG_WIDTH"


def resolve_gang_width(n_groups: int) -> int:
    """Worker threads for the small groups. ``GORDO_GANG_WIDTH``: an
    integer pins the width (clamped to the group count); ``auto`` or unset
    gives 1 (the JAX package's ``min(4, n_groups)`` on an accelerator host
    is slower here: see the module docstring)."""
    raw = (os.environ.get(GANG_WIDTH_ENV) or "auto").strip().lower()
    if raw not in ("", "auto"):
        width = int(raw)
        if width < 1:
            raise ValueError(f"{GANG_WIDTH_ENV} must be >= 1, got {width}")
        return min(width, max(1, n_groups))
    return 1


class _LockedHeartbeat:
    """Serializes the heartbeat's read-modify-write updates."""

    def __init__(self, hb: GangHeartbeat):
        self._hb = hb
        self._lock = threading.Lock()

    def update(self, **kw):
        with self._lock:
            self._hb.update(**kw)

    def finish(self, *a, **kw):
        with self._lock:
            self._hb.finish(*a, **kw)


def _finish_build_trace(trace, output_dir: str, **attrs: Any) -> None:
    """Close the build trace and write it beside the manifest as Chrome
    trace-event JSON; best-effort, and on the crash path too."""
    if trace is None:
        return
    trace.finish(**attrs)
    try:
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.join(output_dir, "build_trace.json")
        with open(path, "w") as f:
            json.dump(chrome_trace([trace]), f)
        logger.info("build trace (fit/compile/checkpoint spans per bucket) -> %s (trace_id=%s)",
                    path, trace.trace_id)
    except Exception:
        logger.warning("failed to write build trace", exc_info=True)


def _build_counters():
    """The builder's counters in the process registry: models built, by
    path, and builds the cache spared."""
    reg = get_registry()
    return {
        "built": reg.counter("gordo_build_models_built_total", "Models built (artifact written)", ("path",)),
        "cache_hits": reg.counter("gordo_build_cache_hits_total",
                                  "Builds skipped because the register cache satisfied them"),
    }


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
        self._lock = threading.Lock()  # gang workers count retries at once

    def note_retry(self) -> None:
        with self._lock:
            self.group_retries += 1

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


# the separator of a fold member's name: NUL, which no machine name holds
_CV_SEP = "\x00cv\x00"


def _cv_key(name: str, fold: int) -> str:
    return f"{_CV_SEP}{fold}{_CV_SEP}{name}"


def _plan_cv_folds(
    pending: List[Machine],
    member_data: Dict[str, Any],
    ae_kwargs: Dict[str, Any],
) -> Tuple[Dict[str, Tuple[List, np.ndarray]], Dict[str, np.ndarray], List[Machine]]:
    """The TimeSeriesSplit folds of every machine of a gang that asks for
    cross-validation: ``(plan, fold_data, infeasible)``. ``plan`` maps a
    name to (its splits, its rows as float32), ``fold_data`` a fold
    member's key to its training rows. A machine whose folds cannot be cut,
    or whose training or test rows are fewer than its family needs (a
    sequence model's ``lookback + target_offset``), is infeasible: it takes
    the single-build path."""
    from gordo_components_torch import models as _models

    model_type = ae_kwargs.get("model_type", "AutoEncoder")
    if model_type == "AutoEncoder":
        min_rows = 1
    else:
        lookback = ae_kwargs.get("lookback_window")
        if lookback is None:
            _, lookback = _family_defaults(model_type)
        min_rows = int(lookback) + int(getattr(_models, model_type)._target_offset)

    plan: Dict[str, Tuple[List, np.ndarray]] = {}
    fold_data: Dict[str, np.ndarray] = {}
    infeasible: List[Machine] = []
    for machine in pending:
        ev = _normalize_evaluation(machine.evaluation or None)
        if not _wants_cv(ev):
            continue
        X = member_data[machine.name]
        Xv = np.asarray(X.values if hasattr(X, "values") else X, np.float32)
        try:
            splits = list(TimeSeriesSplit(n_splits=int(ev.get("n_splits", 3))).split(Xv))
        except ValueError:
            splits = None
        if splits is None or any(len(tr) < min_rows or len(te) < min_rows for tr, te in splits):
            infeasible.append(machine)
            continue
        plan[machine.name] = (splits, Xv)
        for fold, (tr, _te) in enumerate(splits):
            fold_data[_cv_key(machine.name, fold)] = Xv[tr]
    return plan, fold_data, infeasible


def _score_cv_folds(
    plan: Dict[str, Tuple[List, np.ndarray]],
    fleet_models: Dict[str, Any],
) -> Dict[str, Dict[str, Any]]:
    """Each planned machine's cross-validation metadata: every fold member,
    as the detector pipeline the single build scores, scored on its test
    rows (the metadata keys of ``build_model._cross_validate``, with
    ``fleet_cv``; ``cv_duration_sec`` covers the scoring alone)."""
    out: Dict[str, Dict[str, Any]] = {}
    for name, (splits, Xv) in plan.items():
        t0 = time.time()
        folds = [fleet_models[_cv_key(name, fold)].to_estimator().score_metrics(Xv[te])
                 for fold, (_tr, te) in enumerate(splits)]
        out[name] = {"cv_duration_sec": time.time() - t0, "fleet_cv": True, **summarize_cv_folds(folds)}
    return out


def build_fleet(
    machines: List[Any],
    output_dir: str,
    model_register_dir: Optional[str] = None,
    replace_cache: bool = False,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    distributed: bool = False,
    state_dir: Optional[str] = None,
    gang_id: Optional[str] = None,
    group_retries: Optional[int] = None,
    device="cuda",
) -> FleetBuildReport:
    """Build every machine (a ``Machine`` or its dict) on ``device``;
    returns a :class:`FleetBuildReport`. ``checkpoint_dir`` resumes
    preempted gangs, ``state_dir`` publishes the heartbeat ``gang_id``
    (default host-pid), which ends ``done`` (nothing failed), ``partial``
    or ``failed`` (nothing built). ``results.gang_width`` records the
    small groups' worker threads. ``distributed`` is not ported and
    raises."""
    device = resolve_device(device)
    if distributed:
        raise NotImplementedError("distributed: the multi-host gang is not ported yet")
    configure_from_env()  # GORDO_FAULTS
    if group_retries is None:
        group_retries = int(os.environ.get("GORDO_BUILD_GROUP_RETRIES", "1"))
    # one trace a run, kept whatever the sampling (GORDO_TRACE_SAMPLE=0
    # still turns it off)
    trace = get_tracer().start_trace("fleet_build", force=True)
    counters = _build_counters()
    results = FleetBuildReport()
    heartbeat = None
    if state_dir:
        heartbeat = _LockedHeartbeat(GangHeartbeat(state_dir, gang_id))
        heartbeat.update(phase="starting", n_machines=len(machines), built=0, distributed=bool(distributed))
    try:
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
                else:
                    counters["built"].labels("single").inc()
                if heartbeat is not None:
                    heartbeat.update(phase="building", built=len(results), failed_members=len(results.failed))
                continue
            groups.setdefault(_group_key(ae_kwargs), []).append((machine, ae_kwargs))

        def train_group(group):
            # a group that fails group_retries + 1 times records its members
            # as failed; the other groups still ship
            for attempt in range(group_retries + 1):
                try:
                    # the trainer's bucket loop reads the trace from the
                    # context, which a pool thread does not inherit
                    with use_trace(trace):
                        _build_fleet_group(group, output_dir, model_register_dir, replace_cache,
                                           results, device, checkpoint_dir=checkpoint_dir,
                                           checkpoint_every=checkpoint_every, heartbeat=heartbeat,
                                           counters=counters)
                    return
                except Exception as exc:
                    if attempt < group_retries:
                        results.note_retry()
                        logger.warning("Fleet group of %d member(s) failed (attempt %d/%d): %s; retrying",
                                       len(group), attempt + 1, group_retries + 1, exc)
                        continue
                    error = f"{type(exc).__name__}: {exc}"
                    for m, _kw in group:
                        # members already shipped (cache hits, single builds of
                        # infeasible folds) are built, not failed
                        if m.name not in results:
                            results.failed[m.name] = error
                    logger.error("Fleet group of %d member(s) FAILED after %d attempt(s): %s",
                                 len(group), group_retries + 1, error, exc_info=True)

        gang_width = resolve_gang_width(len(groups))
        results.gang_width = gang_width
        large = [g for g in groups.values() if len(g) > GANG_SMALL_MAX]
        small = [g for g in groups.values() if len(g) <= GANG_SMALL_MAX]
        for group in large:
            train_group(group)
        if gang_width > 1 and len(small) > 1:
            with concurrent.futures.ThreadPoolExecutor(gang_width, thread_name_prefix="gordo-gang") as pool:
                futures = [pool.submit(train_group, g) for g in small]
                for future in futures:
                    future.result()  # train_group records build failures: this raises only a fault of its own
        else:
            for group in small:
                train_group(group)
    except BaseException as exc:
        # what the isolation above does not hold: a signal, a broken volume
        if heartbeat is not None:
            heartbeat.finish("failed", built=len(results), error=f"{type(exc).__name__}: {exc}")
        _finish_build_trace(trace, output_dir, error=True)
        raise
    _finish_build_trace(trace, output_dir, n_built=len(results), n_failed=len(results.failed),
                        gang_width=results.gang_width)
    if heartbeat is not None:
        if not results.failed:
            heartbeat.finish("done", built=len(results))
        elif results:
            heartbeat.finish("partial", built=len(results), failed_members=len(results.failed),
                             error=next(iter(results.failed.values())))
        else:
            heartbeat.finish("failed", built=0, failed_members=len(results.failed),
                             error=next(iter(results.failed.values())))
    return results


def _build_fleet_group(
    group: List[Tuple[Machine, Dict[str, Any]]],
    output_dir: str,
    model_register_dir: Optional[str],
    replace_cache: bool,
    results: Dict[str, str],
    device,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    heartbeat=None,
    counters=None,
) -> None:
    _FP_GROUP.fire()
    if counters is None:  # a direct caller, outside build_fleet
        counters = _build_counters()
    ae_kwargs = copy.deepcopy(group[0][1])
    pending: List[Machine] = []
    member_hparams: Dict[str, Dict[str, Any]] = {}
    for machine, kw in group:
        key = calculate_model_key(machine.name, machine.model, machine.dataset, machine.metadata)
        cached = None if replace_cache else cached_artifact(model_register_dir, key)
        evaluation = _normalize_evaluation(machine.evaluation or None)
        if cached is not None and cached_cv_satisfied(cached, evaluation):
            logger.info("Machine %s: cache hit", machine.name)
            _mirror_artifact(cached, os.path.join(output_dir, machine.name))
            results[machine.name] = cached
            counters["cache_hits"].inc()
            continue
        pending.append(machine)
        member_hparams[machine.name] = _member_hparams_of(kw)
    if not pending:
        return

    trainer_kwargs = {k: ae_kwargs.pop(k) for k in _TRAINER_KEYS if k in ae_kwargs}
    epoch_cb = None
    if heartbeat is not None:
        heartbeat.update(phase="loading", group_members=len(pending))

        def epoch_cb(info):
            heartbeat.update(phase="training", bucket=[int(info["n_features"]), int(info["padded_rows"])],
                             epoch=int(info["epoch"]), n_active=int(info["n_active"]))

    trainer = FleetTrainer(device=device, checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
                           epoch_callback=epoch_cb, **trainer_kwargs, **ae_kwargs)
    t0 = time.time()
    loaded = stage_members([dict(m.dataset) for m in pending])
    member_data = {m.name: X for m, (X, _meta) in zip(pending, loaded)}
    datasets_meta = {m.name: meta for m, (_X, meta) in zip(pending, loaded)}
    load_elapsed = time.time() - t0

    # fold training rows join the gang as members; a machine whose folds
    # the gang cannot train builds alone (reloading its data)
    cv_plan, fold_data, infeasible = _plan_cv_folds(pending, member_data, ae_kwargs)
    for machine in infeasible:
        logger.info("Machine %s: CV folds infeasible for the gang, single-build path", machine.name)
        pending = [m for m in pending if m.name != machine.name]
        for d in (member_data, datasets_meta, member_hparams):
            d.pop(machine.name, None)
        results[machine.name] = provide_saved_model(
            machine.name, machine.model, machine.dataset, machine.metadata,
            output_dir=os.path.join(output_dir, machine.name),
            model_register_dir=model_register_dir, replace_cache=replace_cache,
            evaluation_config=machine.evaluation or None, device=device,
        )
        counters["built"].labels("single").inc()
    if not pending:
        return

    # fold members train with their machine's learning rate and patience
    for name, (splits, _Xv) in cv_plan.items():
        for fold in range(len(splits)):
            member_hparams[_cv_key(name, fold)] = member_hparams[name]
    t1 = time.time()
    with maybe_profile(f"fleet-gang-{len(pending)}m"):
        fleet_models = trainer.fit({**member_data, **fold_data}, member_hparams=member_hparams)
    train_elapsed = time.time() - t1
    trainer.last_stats["device_memory"] = device_memory_stats(device)
    if fold_data:
        trainer.last_stats["cv_fold_members"] = len(fold_data)
    cv_meta = _score_cv_folds(cv_plan, fleet_models)

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
        if name in cv_meta:
            metadata["model"]["cross-validation"] = cv_meta[name]
        dest = os.path.join(model_register_dir, key) if model_register_dir else os.path.join(output_dir, name)
        serializer.dump(det, dest, metadata=metadata)
        _mirror_artifact(dest, os.path.join(output_dir, name))
        results[name] = dest
        counters["built"].labels("fleet").inc()
        logger.info("Machine %s: fleet-built -> %s", name, dest)
    if heartbeat is not None:
        heartbeat.update(phase="building", built=len(results))
