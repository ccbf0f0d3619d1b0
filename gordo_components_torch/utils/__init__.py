"""Small helpers of the port: constructor-argument capture for config
round-tripping, the build metadata's timestamp and the numeric env knobs
(counterparts of ``gordo_components_tpu/utils/capture.py``,
``utils/metadata.py`` and ``utils.env_num``)."""

import datetime
import functools
import inspect
import os
from typing import Any, Callable, Dict


def capture_args(init: Callable) -> Callable:
    """Decorator for ``__init__`` methods: records the call's arguments,
    defaults included and ``**kwargs`` flattened in, into ``self._params``."""
    sig = inspect.signature(init)

    @functools.wraps(init)
    def wrapper(self, *args, **kwargs):
        bound = sig.bind(self, *args, **kwargs)
        bound.apply_defaults()
        params: Dict[str, Any] = {}
        for name, value in bound.arguments.items():
            if name == "self":
                continue
            kind = sig.parameters[name].kind
            if kind is inspect.Parameter.VAR_KEYWORD:
                params.update(value)
            elif kind is inspect.Parameter.VAR_POSITIONAL:
                params[name] = list(value)
            else:
                params[name] = value
        self._params = params
        return init(self, *args, **kwargs)

    return wrapper


def metadata_timestamp() -> str:
    """UTC ISO-8601 timestamp used in build metadata."""
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


def env_num(name: str, default, cast):
    """A numeric env knob; unset or empty keeps ``default``, a malformed
    value raises naming the knob."""
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return cast(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}") from None
