"""Config-definition language: dotted import paths + nested kwargs.

Counterpart of ``import_locate``/``from_definition`` in
``gordo_components_tpu/serializer/definitions.py``. A definition is:

- a dotted path string -> the class, instantiated with defaults;
- a one-key dict ``{dotted.path: {kwargs}}`` -> instantiated with kwargs,
  resolving kwarg values that are themselves definitions;
- a list -> each element resolved (``Pipeline(steps=...)``), bare pipeline
  steps auto-named ``step_0..``.

The port's alias table makes one configuration resolve to port classes:
the JAX package's paths (``gordo_components_tpu.models.*``), the
reference-era ``gordo_components.model.*`` paths, and the three sklearn
classes the reference's configurations name, for which the port has its
own stand-ins (it imports no sklearn).
"""

import importlib
from typing import Any, Dict, List, Union

_M = "gordo_components_torch.models"
_PATH_ALIASES = {
    "gordo_components.model.models.KerasAutoEncoder": f"{_M}.AutoEncoder",
    "gordo_components.model.models.KerasLSTMAutoEncoder": f"{_M}.LSTMAutoEncoder",
    "gordo_components.model.models.KerasLSTMForecast": f"{_M}.LSTMForecast",
    "gordo_components.model.anomaly.DiffBasedAnomalyDetector": f"{_M}.DiffBasedAnomalyDetector",
    "gordo_components.model.anomaly.diff.DiffBasedAnomalyDetector": f"{_M}.DiffBasedAnomalyDetector",
    "gordo_components_tpu.models.transformers.JaxMinMaxScaler": f"{_M}.transformers.MinMaxScaler",
    "gordo_components_tpu.models.transformers.JaxStandardScaler": f"{_M}.transformers.StandardScaler",
    "sklearn.pipeline.Pipeline": f"{_M}.transformers.Pipeline",
    "sklearn.preprocessing.MinMaxScaler": f"{_M}.transformers.MinMaxScaler",
    "sklearn.preprocessing.StandardScaler": f"{_M}.transformers.StandardScaler",
}
# any other path under these prefixes maps onto the port's package
_PREFIXES = ("gordo_components_tpu.", "gordo_components.")


def resolve_path(path: str) -> str:
    """The port path a configuration's dotted path stands for."""
    path = _PATH_ALIASES.get(path, path)
    for prefix in _PREFIXES:
        if path.startswith(prefix):
            return "gordo_components_torch." + path[len(prefix):]
    if path.startswith("sklearn."):
        raise ImportError(
            f"{path}: the port resolves only sklearn.pipeline.Pipeline, "
            "sklearn.preprocessing.MinMaxScaler and sklearn.preprocessing.StandardScaler"
        )
    return path


def import_locate(path: str) -> Any:
    """Import an object from a dotted path, applying the port's aliases."""
    path = resolve_path(path)
    module_path, _, name = path.rpartition(".")
    if not module_path:
        raise ImportError(f"Not a dotted path: {path!r}")
    try:
        return getattr(importlib.import_module(module_path), name)
    except AttributeError:
        # the "module" part may itself be a class (nested attribute)
        return getattr(import_locate(module_path), name)


def _looks_like_path(key: Any) -> bool:
    return isinstance(key, str) and "." in key


def from_definition(definition: Union[str, Dict, List]) -> Any:
    """Instantiate an object (usually a detector over a pipeline) from a
    definition."""
    if isinstance(definition, str):
        if _looks_like_path(definition):
            return import_locate(definition)()
        raise ValueError(f"Cannot interpret definition string: {definition!r}")
    if isinstance(definition, list):
        return [from_definition(d) if _is_definition(d) else d for d in definition]
    if isinstance(definition, dict):
        if len(definition) != 1:
            raise ValueError(
                f"Definition dict must have exactly one dotted-path key, got {sorted(definition)}"
            )
        (path, kwargs), = definition.items()
        cls = import_locate(path)
        return cls(**{k: _resolve_value(k, v) for k, v in dict(kwargs or {}).items()})
    raise ValueError(f"Cannot interpret definition of type {type(definition)}")


def _is_definition(v: Any) -> bool:
    if isinstance(v, str) and _looks_like_path(v):
        path = v
    elif isinstance(v, dict) and len(v) == 1 and _looks_like_path(next(iter(v))):
        path = next(iter(v))
    else:
        return False
    try:
        import_locate(path)
        return True
    except (ImportError, AttributeError):
        return False


def _resolve_value(key: str, value: Any) -> Any:
    # steps may be bare definitions or (name, definition) pairs; bare
    # entries are auto-named. A step that does not resolve raises here
    # (ImportError naming it), not later inside the pipeline.
    if key == "steps" and isinstance(value, list):
        out = []
        for i, entry in enumerate(value):
            if (isinstance(entry, (list, tuple)) and len(entry) == 2
                    and isinstance(entry[0], str) and not _is_definition(entry[0])):
                out.append((entry[0], from_definition(entry[1])))
            else:
                out.append((f"step_{i}", from_definition(entry)))
        return out
    if _is_definition(value):
        return from_definition(value)
    if isinstance(value, list):
        return [from_definition(v) if _is_definition(v) else v for v in value]
    return value
