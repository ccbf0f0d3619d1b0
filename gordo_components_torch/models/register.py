"""Model-architecture registry.

Counterpart of ``gordo_components_tpu/models/register.py``: maps an
estimator type name to ``{factory name: factory}``, so a configuration's
``AutoEncoder(kind="feedforward_hourglass")`` resolves to a factory. The
port's factories return ``torch.nn.Module``s.
"""

from typing import Callable, Dict

# estimator-class-name -> factory-name -> factory callable
FACTORY_REGISTRY: Dict[str, Dict[str, Callable]] = {}


def register_model_builder(type: str) -> Callable:
    """``@register_model_builder(type="AutoEncoder")`` on a factory
    function registers it under that estimator type by its ``__name__``."""

    def decorator(factory: Callable) -> Callable:
        FACTORY_REGISTRY.setdefault(type, {})[factory.__name__] = factory
        return factory

    return decorator


def lookup_factory(type: str, kind: str) -> Callable:
    """Resolve a factory for an estimator type, with helpful errors."""
    try:
        by_kind = FACTORY_REGISTRY[type]
    except KeyError:
        raise ValueError(
            f"No factories registered for estimator type {type!r}; known: {sorted(FACTORY_REGISTRY)}"
        )
    try:
        return by_kind[kind]
    except KeyError:
        raise ValueError(f"Unknown kind {kind!r} for {type!r}; known: {sorted(by_kind)}")
