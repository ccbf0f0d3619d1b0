"""Model-architecture registry.

Counterpart of ``gordo_components_tpu/models/register.py``: maps an
estimator type name to ``{factory name: factory}``, so a configuration's
``AutoEncoder(kind="feedforward_hourglass")`` resolves to a factory. The
port's factories return ``torch.nn.Module``s.
"""

from typing import Any, Callable, Dict, Mapping

# estimator-class-name -> factory-name -> factory callable
FACTORY_REGISTRY: Dict[str, Dict[str, Callable]] = {}


def register_model_builder(type: str) -> Callable:
    """``@register_model_builder(type="AutoEncoder")`` on a factory
    function registers it under that estimator type by its ``__name__``."""

    def decorator(factory: Callable) -> Callable:
        FACTORY_REGISTRY.setdefault(type, {})[factory.__name__] = factory
        return factory

    return decorator


def by_family(table: Mapping[str, Any], module, what: str) -> Any:
    """``table[module.family]``. Each module class a factory builds names
    its family once (``family``: ``"dense"``, ``"vae"``, ``"lstm"``,
    ``"conv"``), and the port's per-family tables are keyed on that name:
    the training stacks (``train_core``), the bank's buckets
    (``server.bank``) and the weight converters (``convert``). A module
    without a family, or one that ``table`` lacks, raises here."""
    family = getattr(module, "family", None)
    if family not in table:
        raise TypeError(f"no {what} for a {type(module).__name__} (family {family!r})")
    return table[family]


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
