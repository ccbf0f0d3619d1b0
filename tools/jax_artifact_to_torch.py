#!/usr/bin/env python3
"""Convert a JAX package artifact directory into a PyTorch port artifact.

    python tools/jax_artifact_to_torch.py SRC_DIR DEST_DIR

``SRC_DIR`` is an artifact the JAX package wrote (``model.pkl``, and
``metadata.json`` when it was built). The model in it may be a
``DiffBasedAnomalyDetector``, a bare ``Pipeline`` of transformers and an
estimator, a ``TransformedTargetRegressor`` or a bare estimator. The
transformers may be the JAX scalers, sklearn's ``MinMaxScaler``,
``StandardScaler``, ``RobustScaler``, ``MaxAbsScaler`` and ``PCA`` with
their arguments, and ``FeatureUnion`` over them; a detector over a
pipeline that is not affine (PCA, FeatureUnion, a clipping scaler) is
carried as its pipeline, the others as a bank entry. ``DEST_DIR`` receives the port's artifact
of the same model (``serializer/artifacts.py`` of
``gordo_components_torch``), the weights carried across by the port's
``convert`` functions, with the same ``metadata.json``. A directory of
artifact directories converts each of them into a subdirectory of the same
name.

Unpickling ``model.pkl`` needs the JAX package and JAX, so this tool runs
where they are installed; the port reads what it writes without either.
"""

import argparse
import json
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gordo_components_torch import serializer  # noqa: E402
from gordo_components_torch.convert import entry_from_numpy, estimator_from_numpy  # noqa: E402
from gordo_components_torch.models import compose, transformers  # noqa: E402
from gordo_components_torch.models.anomaly.diff import DiffBasedAnomalyDetector as PortDetector  # noqa: E402
from gordo_components_torch.ops.scaler import ScalerParams  # noqa: E402

# JAX and sklearn scaler classes -> the port's
_SCALERS = {"MinMaxScaler": transformers.MinMaxScaler, "JaxMinMaxScaler": transformers.MinMaxScaler,
            "StandardScaler": transformers.StandardScaler, "JaxStandardScaler": transformers.StandardScaler,
            "RobustScaler": transformers.RobustScaler, "MaxAbsScaler": transformers.MaxAbsScaler}
# the sklearn attributes each port class keeps beside its affine
_ATTRS = {"RobustScaler": ("center_", "scale_"), "MaxAbsScaler": ("max_abs_", "scale_")}


def _tree(params):
    import jax

    return jax.tree.map(np.asarray, params)


def convert_estimator(est, device="cpu"):
    """A fitted JAX estimator as the port's estimator."""
    params = dict(est.get_params())
    return estimator_from_numpy(
        type(est).__name__, est.kind, dict(est.factory_kwargs), int(est.n_features_),
        _tree(est.params_), lookback=int(getattr(est, "lookback_window", 1)),
        target_offset=int(getattr(est, "_target_offset", 0)),
        compute_dtype=str(getattr(est, "compute_dtype", "float32")),
        estimator_params=params, device=device,
    )


def _kwargs(step, port_cls):
    """The step's constructor arguments that the port's class takes."""
    import inspect

    names = set(inspect.signature(port_cls.__init__).parameters) - {"self"}
    return {k: v for k, v in step.get_params(deep=False).items() if k in names}


def convert_step(step):
    """A fitted JAX or sklearn transformer step (or ``"drop"``) as the
    port's."""
    from gordo_components_tpu.server.bank import _affine_from_scaler

    if isinstance(step, str):
        return step
    cls = type(step).__name__
    if cls in _SCALERS:
        affine = _affine_from_scaler(step, getattr(step, "n_features_in_", None))
        if affine is None:
            raise ValueError(f"the port has no scaler for {cls} with {step.get_params()}")
        port = _SCALERS[cls](**_kwargs(step, _SCALERS[cls]))
        state = {"shift": affine[0], "scale": affine[1]}
        state.update({a: getattr(step, a) for a in _ATTRS.get(cls, ()) if getattr(step, a, None) is not None})
        return port.set_fitted_state(state)
    if cls == "PCA":
        port = transformers.PCA(**_kwargs(step, transformers.PCA))
        return port.set_fitted_state({a: np.asarray(getattr(step, a)) for a in transformers.PCA._ATTRS})
    if cls == "FeatureUnion":
        return compose.FeatureUnion([(name, convert_step(t)) for name, t in step.transformer_list],
                                    **{k: v for k, v in _kwargs(step, compose.FeatureUnion).items()
                                       if k != "transformer_list"})
    raise ValueError(f"the port has no transformer for {cls}")


def _convert_pipeline(pipeline, device):
    *pre, (est_name, est) = pipeline.steps
    return transformers.Pipeline([(name, convert_step(step)) for name, step in pre]
                                 + [(est_name, convert_estimator(est, device))])


def _thresholds(model):
    if model.feature_thresholds_ is None:
        return None
    return {
        "feature-thresholds": {t: float(v) for t, v in zip(model.tags_, model.feature_thresholds_)},
        "total-anomaly-threshold": float(model.total_threshold_),
        "threshold-method": model.threshold_method_ or "exact",
    }


def convert_model(model, device="cpu"):
    """A JAX model as what the port's ``serializer.dump`` writes: a bank
    entry for a detector over affine steps, a port detector over its
    pipeline for one with a step that is not affine, a port ``Pipeline``,
    ``TransformedTargetRegressor`` or estimator otherwise."""
    from gordo_components_tpu.models.anomaly.diff import DiffBasedAnomalyDetector
    from gordo_components_tpu.server.bank import _extract_entry

    if isinstance(model, DiffBasedAnomalyDetector):
        base = model.base_estimator
        if hasattr(base, "steps"):
            det = PortDetector(base_estimator=_convert_pipeline(base, device),
                               require_thresholds=model.require_thresholds,
                               threshold_quantile=model.threshold_quantile)
            if det.non_affine_step is not None:
                det.error_scaler_ = ScalerParams(*(np.asarray(a, np.float32) for a in model.error_scaler_))
                det.tags_ = list(model.tags_)
                if model.feature_thresholds_ is not None:  # one a model-space column
                    det.feature_thresholds_ = np.asarray(model.feature_thresholds_, np.float64)
                    det.total_threshold_ = float(model.total_threshold_)
                    det.threshold_method_ = model.threshold_method_ or "exact"
                return det
        e, reason = _extract_entry("model", model)
        if e is None:
            raise ValueError(f"the detector cannot be converted: {reason}")
        return entry_from_numpy(
            "model", e.registry_type, e.kind, e.factory_kwargs, e.n_features, e.params,
            e.in_shift, e.in_scale, e.err_shift, e.err_scale, tags=model.tags_, thresholds=_thresholds(model),
            lookback=e.lookback, target_offset=e.target_offset, compute_dtype=e.compute_dtype,
        )
    if type(model).__name__ == "TransformedTargetRegressor":
        reg = model.regressor_
        port = compose.TransformedTargetRegressor(
            regressor=_convert_pipeline(reg, device) if hasattr(reg, "steps") else convert_estimator(reg, device),
            transformer=None if model.transformer_ is None else convert_step(model.transformer_),
            check_inverse=model.check_inverse)
        port._training_dim = model._training_dim
        return port
    if hasattr(model, "steps"):
        return _convert_pipeline(model, device)
    return convert_estimator(model, device)


def convert_dir(src: str, dest: str) -> None:
    """The JAX artifact at ``src`` as the port's artifact at ``dest``."""
    with open(os.path.join(src, "model.pkl"), "rb") as f:
        model = pickle.load(f)
    metadata = None
    if os.path.exists(os.path.join(src, "metadata.json")):
        with open(os.path.join(src, "metadata.json")) as f:
            metadata = json.load(f)
    serializer.dump(convert_model(model), dest, metadata=metadata)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("src", help="a JAX artifact directory, or a directory of them")
    parser.add_argument("dest", help="where the port's artifact(s) go")
    args = parser.parse_args(argv)
    if os.path.exists(os.path.join(args.src, "model.pkl")):
        convert_dir(args.src, args.dest)
        print(args.dest)
        return 0
    names = sorted(n for n in os.listdir(args.src) if os.path.exists(os.path.join(args.src, n, "model.pkl")))
    if not names:
        print(f"no JAX artifact under {args.src}", file=sys.stderr)
        return 1
    for name in names:
        convert_dir(os.path.join(args.src, name), os.path.join(args.dest, name))
        print(os.path.join(args.dest, name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
