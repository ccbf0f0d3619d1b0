"""Carry fitted weights across from the Flax layout.

Flax names a module's dense layers ``Dense_0``, ``Dense_1``, ... with
``kernel`` ``(in, out)`` and ``bias`` ``(out,)``; ``nn.Linear.weight`` is
``(out, in)``. The functions here take numpy arrays only, so the port needs
neither JAX nor the JAX package to use them.
"""

import re
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np

_DENSE = re.compile(r"^Dense_(\d+)$")


def _dense_layers(params: Mapping[str, Any]):
    tree = params.get("params", params)
    layers = sorted(
        (int(m.group(1)), v) for k, v in tree.items() if (m := _DENSE.match(k))
    )
    if not layers or [i for i, _ in layers] != list(range(len(layers))):
        raise ValueError(f"expected Dense_0..Dense_n layers, got {sorted(tree)}")
    return [v for _, v in layers]


def feedforward_from_flax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Flax param tree of numpy arrays (``{"params": {"Dense_i": {"kernel",
    "bias"}}}``, with or without the ``"params"`` level) -> the state dict
    of :class:`~.models.factories.feedforward.FeedForwardAutoEncoder`."""
    out: Dict[str, np.ndarray] = {}
    for i, layer in enumerate(_dense_layers(params)):
        out[f"layers.{i}.weight"] = np.ascontiguousarray(np.asarray(layer["kernel"], np.float32).T)
        out[f"layers.{i}.bias"] = np.array(layer["bias"], np.float32)
    return out


def feedforward_to_flax(state_dict: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """Inverse of :func:`feedforward_from_flax`, with the ``"params"`` level."""
    n = sum(1 for k in state_dict if k.endswith(".weight"))
    return {
        "params": {
            f"Dense_{i}": {
                "kernel": np.ascontiguousarray(np.asarray(state_dict[f"layers.{i}.weight"]).T),
                "bias": np.asarray(state_dict[f"layers.{i}.bias"]),
            }
            for i in range(n)
        }
    }


def entry_from_numpy(
    name: str,
    registry_type: str,
    kind: str,
    factory_kwargs: Mapping[str, Any],
    n_features: int,
    params: Mapping[str, Any],
    in_shift,
    in_scale,
    err_shift,
    err_scale,
    tags: Optional[Sequence[str]] = None,
    thresholds: Optional[Dict[str, Any]] = None,
):
    """A bank entry (``server/bank._BankEntry``) from numpy pieces;
    ``params`` is a Flax param tree."""
    from gordo_components_torch.server.bank import _BankEntry

    def vec(a, what):
        a = np.asarray(a, np.float32)
        if a.shape != (n_features,):
            raise ValueError(f"{name}: {what} has shape {a.shape}, expected ({n_features},)")
        return a

    return _BankEntry(
        name=name,
        registry_type=registry_type,
        kind=kind,
        factory_kwargs=dict(factory_kwargs),
        n_features=int(n_features),
        params=feedforward_from_flax(params),
        in_shift=vec(in_shift, "in_shift"),
        in_scale=vec(in_scale, "in_scale"),
        err_shift=vec(err_shift, "err_shift"),
        err_scale=vec(err_scale, "err_scale"),
        tags=list(tags) if tags else [f"feature-{i}" for i in range(n_features)],
        thresholds=thresholds,
    )
