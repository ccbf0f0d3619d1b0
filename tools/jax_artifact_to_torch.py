#!/usr/bin/env python3
"""Convert a JAX package artifact directory into a PyTorch port artifact.

    python tools/jax_artifact_to_torch.py SRC_DIR DEST_DIR

``SRC_DIR`` is an artifact the JAX package wrote (``model.pkl``, and
``metadata.json`` when it was built). The model in it may be a
``DiffBasedAnomalyDetector``, a bare ``Pipeline`` of scalers and an
estimator, or a bare estimator. ``DEST_DIR`` receives the port's artifact
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
from gordo_components_torch.convert import (  # noqa: E402
    entry_from_numpy,
    estimator_from_numpy,
    scaler_from_numpy,
)
from gordo_components_torch.models.transformers import Pipeline  # noqa: E402

# JAX and sklearn scaler classes -> the port's, for default arguments
_SCALERS = {"MinMaxScaler": "MinMaxScaler", "JaxMinMaxScaler": "MinMaxScaler",
            "StandardScaler": "StandardScaler", "JaxStandardScaler": "StandardScaler"}


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


def convert_scaler(step, n_features: int):
    """A fitted JAX or sklearn scaler step as the port's scaler."""
    from gordo_components_tpu.server.bank import _affine_from_scaler

    cls = type(step).__name__
    params = step.get_params()
    kwargs = {"feature_range": list(params["feature_range"])} if "feature_range" in params else {}
    # arguments the port's scalers have no counterpart for, unless at their defaults
    defaults = {"clip": False, "with_mean": True, "with_std": True}
    extra = {k: v for k, v in params.items() if k not in ("copy", "feature_range") and defaults.get(k) != v}
    affine = _affine_from_scaler(step, n_features) if cls in _SCALERS else None
    if affine is None or extra:
        raise ValueError(f"the port has no scaler for {cls} with {extra or params}")
    return scaler_from_numpy(_SCALERS[cls], affine[0], affine[1], kwargs)


def convert_model(model, device="cpu"):
    """A JAX model as what the port's ``serializer.dump`` writes: a bank
    entry for a detector, a port ``Pipeline`` or estimator otherwise."""
    from gordo_components_tpu.models.anomaly.diff import DiffBasedAnomalyDetector
    from gordo_components_tpu.server.bank import _extract_entry

    if isinstance(model, DiffBasedAnomalyDetector):
        e, reason = _extract_entry("model", model)
        if e is None:
            raise ValueError(f"the detector cannot be converted: {reason}")
        thresholds = None
        if model.feature_thresholds_ is not None:
            thresholds = {
                "feature-thresholds": {t: float(v) for t, v in zip(model.tags_, model.feature_thresholds_)},
                "total-anomaly-threshold": float(model.total_threshold_),
                "threshold-method": model.threshold_method_ or "exact",
            }
        return entry_from_numpy(
            "model", e.registry_type, e.kind, e.factory_kwargs, e.n_features, e.params,
            e.in_shift, e.in_scale, e.err_shift, e.err_scale, tags=model.tags_, thresholds=thresholds,
            lookback=e.lookback, target_offset=e.target_offset, compute_dtype=e.compute_dtype,
        )
    if hasattr(model, "steps"):
        *pre, (est_name, est) = model.steps
        port_est = convert_estimator(est, device)
        steps = [(name, convert_scaler(step, port_est.n_features_)) for name, step in pre]
        return Pipeline(steps + [(est_name, port_est)])
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
