"""Carry fitted weights across from the Flax layout.

Flax names a module's dense layers ``Dense_0``, ``Dense_1``, ... with
``kernel`` ``(in, out)`` and ``bias`` ``(out,)``; ``nn.Linear.weight`` is
``(out, in)``. An LSTM stack's layers are ``OptimizedLSTMCell_0``, ... with
per-gate input kernels ``ii/if/ig/io`` ``(in, H)`` and hidden kernels and
biases ``hi/hf/hg/ho`` ``(H, H)``, ``(H,)``; the port concatenates the gates
in that order i, f, g, o. The functions here take numpy arrays only, so the
port needs neither JAX nor the JAX package to use them.
"""

import re
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np

_DENSE = re.compile(r"^Dense_(\d+)$")
_CELL = re.compile(r"^OptimizedLSTMCell_(\d+)$")
_GATES = ("i", "f", "g", "o")  # Flax OptimizedLSTMCell split order
SEQUENCE_TYPES = ("LSTMAutoEncoder", "LSTMForecast")


def _numbered(params: Mapping[str, Any], pattern: "re.Pattern", what: str):
    tree = params.get("params", params)
    layers = sorted(
        (int(m.group(1)), v) for k, v in tree.items() if (m := pattern.match(k))
    )
    if not layers or [i for i, _ in layers] != list(range(len(layers))):
        raise ValueError(f"expected {what}_0..{what}_n layers, got {sorted(tree)}")
    return [v for _, v in layers]


def _dense_layers(params: Mapping[str, Any]):
    return _numbered(params, _DENSE, "Dense")


def _f32(a) -> np.ndarray:
    return np.array(a, dtype=np.float32, order="C")  # an owned, writable copy


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


def lstm_from_flax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Flax ``LSTMStack`` param tree of numpy arrays (with or without the
    ``"params"`` level; every leaf may carry a leading member axis) -> the
    state dict of :class:`~.models.factories.lstm.LSTMStack`: per layer
    ``layers.{i}.Wi`` (in, 4H), ``layers.{i}.Wh`` (H, 4H), ``layers.{i}.b``
    (4H,), and ``head.kernel`` (H, F), ``head.bias`` (F,)."""
    out: Dict[str, np.ndarray] = {}
    for i, cell in enumerate(_numbered(params, _CELL, "OptimizedLSTMCell")):
        out[f"layers.{i}.Wi"] = _f32(np.concatenate([cell[f"i{g}"]["kernel"] for g in _GATES], -1))
        out[f"layers.{i}.Wh"] = _f32(np.concatenate([cell[f"h{g}"]["kernel"] for g in _GATES], -1))
        out[f"layers.{i}.b"] = _f32(np.concatenate([cell[f"h{g}"]["bias"] for g in _GATES], -1))
    heads = _dense_layers(params)
    if len(heads) != 1:
        raise ValueError(f"an LSTM stack has one Dense head, got {len(heads)}")
    out["head.kernel"] = _f32(heads[0]["kernel"])
    out["head.bias"] = _f32(heads[0]["bias"])
    return out


def lstm_to_flax(state_dict: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """Inverse of :func:`lstm_from_flax`, with the ``"params"`` level."""
    tree: Dict[str, Any] = {}
    n = sum(1 for k in state_dict if k.endswith(".Wh"))
    for i in range(n):
        cell: Dict[str, Any] = {}
        for side, key in (("i", "Wi"), ("h", "Wh"), ("b", "b")):
            parts = np.split(np.asarray(state_dict[f"layers.{i}.{key}"]), 4, axis=-1)
            for g, part in zip(_GATES, parts):
                if side == "b":
                    cell[f"h{g}"]["bias"] = part
                else:
                    cell.setdefault(f"{side}{g}", {})["kernel"] = part
        tree[f"OptimizedLSTMCell_{i}"] = cell
    tree["Dense_0"] = {
        "kernel": np.asarray(state_dict["head.kernel"]),
        "bias": np.asarray(state_dict["head.bias"]),
    }
    return {"params": tree}


def params_from_flax(registry_type: str, params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The port state dict for a registry type's Flax param tree."""
    if registry_type in SEQUENCE_TYPES:
        return lstm_from_flax(params)
    if registry_type == "AutoEncoder":
        return feedforward_from_flax(params)
    raise ValueError(f"unsupported registry type {registry_type!r}")


def params_to_flax(registry_type: str, state_dict: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """Inverse of :func:`params_from_flax`."""
    if registry_type in SEQUENCE_TYPES:
        return lstm_to_flax(state_dict)
    if registry_type == "AutoEncoder":
        return feedforward_to_flax(state_dict)
    raise ValueError(f"unsupported registry type {registry_type!r}")


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
    lookback: int = 1,
    target_offset: int = 0,
):
    """A bank entry (``server/bank._BankEntry``) from numpy pieces;
    ``params`` is a Flax param tree of the registry type's model. Sequence
    models (``LSTMAutoEncoder``, ``LSTMForecast``) score windows of
    ``lookback`` rows; ``target_offset`` is 0 for reconstruction and 1 for
    a t+1 forecast. Feedforward models keep the defaults."""
    from gordo_components_torch.server.bank import _BankEntry

    def vec(a, what):
        a = np.asarray(a, np.float32)
        if a.shape != (n_features,):
            raise ValueError(f"{name}: {what} has shape {a.shape}, expected ({n_features},)")
        return a

    lookback, target_offset = int(lookback), int(target_offset)
    if lookback < 1 or target_offset < 0:
        raise ValueError(f"{name}: lookback={lookback}, target_offset={target_offset}")
    if registry_type not in SEQUENCE_TYPES and (lookback, target_offset) != (1, 0):
        raise ValueError(f"{name}: {registry_type} scores rows, not windows")
    return _BankEntry(
        name=name,
        registry_type=registry_type,
        kind=kind,
        factory_kwargs=dict(factory_kwargs),
        n_features=int(n_features),
        params=params_from_flax(registry_type, params),
        in_shift=vec(in_shift, "in_shift"),
        in_scale=vec(in_scale, "in_scale"),
        err_shift=vec(err_shift, "err_shift"),
        err_scale=vec(err_scale, "err_scale"),
        tags=list(tags) if tags else [f"feature-{i}" for i in range(n_features)],
        thresholds=thresholds,
        lookback=lookback,
        target_offset=target_offset,
    )
