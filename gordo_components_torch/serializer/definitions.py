"""Config-definition language: dotted import paths + nested kwargs.

Counterpart of ``import_locate``/``from_definition`` in
``gordo_components_tpu/serializer/definitions.py``. A definition is:

- a dotted path string -> the class, instantiated with defaults;
- a one-key dict ``{dotted.path: {kwargs}}`` -> instantiated with kwargs,
  resolving kwarg values that are themselves definitions;
- a list -> each element resolved (``Pipeline(steps=...)``), bare
  ``steps`` and ``transformer_list`` entries auto-named ``step_0..``.

:func:`into_definition` is the inverse (JAX ``into_definition``): an
object's captured constructor arguments (``_params``) as a definition. The
port's stand-ins for the sklearn classes write the sklearn path with their
non-default arguments, as the JAX package writes the sklearn objects
themselves, and ``device`` (where a model runs, not what it is) is left
out, so the port writes the JAX package's definition with its own package
name.

The port's alias table makes one configuration resolve to port classes:
the JAX package's paths (``gordo_components_tpu.models.*``), the
reference-era ``gordo_components.model.*`` paths, and the sklearn classes
the port has stand-ins for (it imports no sklearn), under their public
paths and the private module paths an object's class names
(``sklearn.preprocessing._data``, ``sklearn.decomposition._pca``,
``sklearn.compose._target``): ``Pipeline``, ``FeatureUnion``,
``MinMaxScaler``, ``StandardScaler``, ``RobustScaler``, ``MaxAbsScaler``,
``PCA`` and ``TransformedTargetRegressor``. Any other sklearn path raises
``ImportError`` listing these.
"""

import importlib
import inspect
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
}
# the sklearn classes the port has stand-ins for: public path -> (private
# module, the port's class)
_SKLEARN = {
    "sklearn.pipeline.Pipeline": (None, f"{_M}.transformers.Pipeline"),
    "sklearn.pipeline.FeatureUnion": (None, f"{_M}.compose.FeatureUnion"),
    "sklearn.preprocessing.MinMaxScaler": ("sklearn.preprocessing._data", f"{_M}.transformers.MinMaxScaler"),
    "sklearn.preprocessing.StandardScaler": ("sklearn.preprocessing._data", f"{_M}.transformers.StandardScaler"),
    "sklearn.preprocessing.RobustScaler": ("sklearn.preprocessing._data", f"{_M}.transformers.RobustScaler"),
    "sklearn.preprocessing.MaxAbsScaler": ("sklearn.preprocessing._data", f"{_M}.transformers.MaxAbsScaler"),
    "sklearn.decomposition.PCA": ("sklearn.decomposition._pca", f"{_M}.transformers.PCA"),
    "sklearn.compose.TransformedTargetRegressor": ("sklearn.compose._target",
                                                   f"{_M}.compose.TransformedTargetRegressor"),
}
_PATH_ALIASES.update({public: port for public, (_, port) in _SKLEARN.items()})
_PATH_ALIASES.update({f"{module}.{public.rpartition('.')[2]}": port
                      for public, (module, port) in _SKLEARN.items() if module is not None})
# any other path under these prefixes maps onto the port's package
_PREFIXES = ("gordo_components_tpu.", "gordo_components.")


def resolve_path(path: str) -> str:
    """The port path a configuration's dotted path stands for."""
    path = _PATH_ALIASES.get(path, path)
    for prefix in _PREFIXES:
        if path.startswith(prefix):
            return "gordo_components_torch." + path[len(prefix):]
    if path.startswith("sklearn."):
        raise ImportError(f"{path}: the port resolves only {', '.join(sorted(_SKLEARN))}")
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
    if key in ("steps", "transformer_list") and isinstance(value, list):
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


# ---------------------------------------------------------------------- #
# inverse: object -> definition
# ---------------------------------------------------------------------- #

# the port's stand-ins for the sklearn classes, under the sklearn paths
_STAND_IN_PATHS = {port: sk for sk, (_, port) in _SKLEARN.items()}


def _dotted_path(obj: Any) -> str:
    cls = type(obj)
    return f"{cls.__module__}.{cls.__qualname__}"


def _ctor_defaults(obj: Any) -> Dict[str, Any]:
    sig = inspect.signature(type(obj).__init__)
    return {k: p.default for k, p in sig.parameters.items() if p.default is not inspect.Parameter.empty}


def into_definition(obj: Any) -> Union[str, Dict]:
    """Serialize an object back into the definition language:
    ``{dotted.path: {kwargs}}``, or the bare path when there are none."""
    path = _dotted_path(obj)
    params = {k: v for k, v in getattr(obj, "_params", {}).items() if k != "device"}
    if path in _STAND_IN_PATHS:
        path = _STAND_IN_PATHS[path]
        defaults = _ctor_defaults(obj)
        params = {k: v for k, v in params.items() if not (k in defaults and _same(defaults[k], v))}
    params = {k: _encode_value(v) for k, v in params.items()}
    return {path: params} if params else path


def _same(a: Any, b: Any) -> bool:
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return list(a) == list(b)
    return a == b


def _encode_value(v: Any) -> Any:
    # (name, object) pairs of Pipeline.steps
    if isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], str) and hasattr(v[1], "_params"):
        return [v[0], into_definition(v[1])]
    if isinstance(v, (list, tuple)):
        return [_encode_value(x) for x in v]
    if hasattr(v, "_params"):
        return into_definition(v)
    return v


# the reference's function names
pipeline_from_definition = from_definition
pipeline_into_definition = into_definition
