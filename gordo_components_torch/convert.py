"""Carry fitted weights across from the Flax layout.

Flax names a module's dense layers ``Dense_0``, ``Dense_1``, ... with
``kernel`` ``(in, out)`` and ``bias`` ``(out,)``; ``nn.Linear.weight`` is
``(out, in)``. An LSTM stack's layers are ``OptimizedLSTMCell_0``, ... with
per-gate input kernels ``ii/if/ig/io`` ``(in, H)`` and hidden kernels and
biases ``hi/hf/hg/ho`` ``(H, H)``, ``(H,)``; the port concatenates the gates
in that order i, f, g, o. The conv autoencoder (``Conv_i``,
``ConvTranspose_j``) and the variational one (``enc_i``, ``mu``, ``logvar``,
``dec_j``, ``out``) keep Flax's names and layout in their state dicts
(``Conv_0.kernel`` (K, F_in, C), ``mu.kernel`` (in, out)). The functions
here take numpy arrays only, so the port needs neither JAX nor the JAX
package to use them.
"""

import json
import re
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np

from gordo_components_torch.device import resolve_compute_dtype

_DENSE = re.compile(r"^Dense_(\d+)$")
_CELL = re.compile(r"^OptimizedLSTMCell_(\d+)$")
_GATES = ("i", "f", "g", "o")  # Flax OptimizedLSTMCell split order
SEQUENCE_TYPES = ("LSTMAutoEncoder", "LSTMForecast", "ConvAutoEncoder")


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


_CONV = re.compile(r"^(Conv|ConvTranspose)_(\d+)$")
_VAE = re.compile(r"^(enc_\d+|mu|logvar|dec_\d+|out)$")


def _named_from_flax(params: Mapping[str, Any], pattern: "re.Pattern", what: str):
    """``{layer: {"kernel", "bias"}}`` -> ``{"layer.kernel", "layer.bias"}``,
    the Flax layout kept, every layer name matching ``pattern``."""
    tree = params.get("params", params)
    if not tree or any(not pattern.match(k) for k in tree):
        raise ValueError(f"expected the layers of a {what}, got {sorted(tree)}")
    return {f"{name}.{leaf}": _f32(layer[leaf]) for name, layer in tree.items() for leaf in ("kernel", "bias")}


def _named_to_flax(state_dict: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        name, leaf = key.rsplit(".", 1)
        tree.setdefault(name, {})[leaf] = np.asarray(value)
    return {"params": tree}


def conv_from_flax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Flax ``Conv1DAutoEncoder`` param tree (``Conv_i``, ``ConvTranspose_j``,
    each ``kernel`` (K, F_in, C) and ``bias`` (C,)) -> the state dict of
    :class:`~.models.factories.conv.Conv1DAutoEncoder`, which keeps that
    layout: ``Conv_i.kernel``, ``Conv_i.bias``, ..."""
    return _named_from_flax(params, _CONV, "Conv1DAutoEncoder")


def conv_to_flax(state_dict: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """Inverse of :func:`conv_from_flax`, with the ``"params"`` level."""
    return _named_to_flax(state_dict)


def vae_from_flax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Flax ``VariationalAutoEncoder`` param tree (``enc_i``, ``mu``,
    ``logvar``, ``dec_j``, ``out``, each ``kernel`` (in, out) and ``bias``)
    -> the state dict of
    :class:`~.models.factories.variational.VariationalAutoEncoder`, which
    keeps that layout: ``enc_0.kernel``, ``enc_0.bias``, ..."""
    return _named_from_flax(params, _VAE, "VariationalAutoEncoder")


def vae_to_flax(state_dict: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """Inverse of :func:`vae_from_flax`, with the ``"params"`` level."""
    return _named_to_flax(state_dict)


# each model family's converters (``models.register.by_family``'s names),
# with a layer name that only its trees hold: Flax's and the port's. The
# LSTM comes before the dense family, whose Dense_0 an LSTM's head shares.
_CONVERTERS = {
    "lstm": ("OptimizedLSTMCell_0", "layers.0.Wi", lstm_from_flax, lstm_to_flax),
    "conv": ("Conv_0", "Conv_0.kernel", conv_from_flax, conv_to_flax),
    "vae": ("mu", "mu.kernel", vae_from_flax, vae_to_flax),
    "dense": ("Dense_0", "layers.0.weight", feedforward_from_flax, feedforward_to_flax),
}


def params_from_flax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The port state dict of a Flax param tree of any ported family, told
    apart by the tree's layer names (never by the registry type: an
    ``LSTMAutoEncoder`` may be a conv model)."""
    tree = params.get("params", params)
    for flax_name, _port_key, from_flax, _to_flax in _CONVERTERS.values():
        if flax_name in tree:
            return from_flax(params)
    raise ValueError(f"no ported model family has the layers {sorted(tree)}")


def params_to_flax(state_dict: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """Inverse of :func:`params_from_flax`, told apart by the state dict's
    keys."""
    for _flax_name, port_key, _from_flax, to_flax in _CONVERTERS.values():
        if port_key in state_dict:
            return to_flax(state_dict)
    raise ValueError(f"no ported model family has the parameters {sorted(state_dict)}")


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
    compute_dtype: str = "float32",
):
    """A bank entry (``server/bank._BankEntry``) from numpy pieces;
    ``params`` is a Flax param tree of the registry type's model. Sequence
    models (``LSTMAutoEncoder``, ``LSTMForecast``, ``ConvAutoEncoder``) score windows of
    ``lookback`` rows; ``target_offset`` is 0 for reconstruction and 1 for
    a t+1 forecast. Feedforward models keep the defaults. ``compute_dtype``
    is the model's, ``"float32"`` or ``"bfloat16"``."""
    from gordo_components_torch.server.bank import _BankEntry

    def vec(a, what):
        a = np.asarray(a, np.float32)
        if a.shape != (n_features,):
            raise ValueError(f"{name}: {what} has shape {a.shape}, expected ({n_features},)")
        return a

    resolve_compute_dtype(compute_dtype)  # raises for a dtype the port does not compute in
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
        params=params_from_flax(params),
        in_shift=vec(in_shift, "in_shift"),
        in_scale=vec(in_scale, "in_scale"),
        err_shift=vec(err_shift, "err_shift"),
        err_scale=vec(err_scale, "err_scale"),
        tags=list(tags) if tags else [f"feature-{i}" for i in range(n_features)],
        thresholds=thresholds,
        lookback=lookback,
        target_offset=target_offset,
        compute_dtype=str(compute_dtype),
    )


def estimator_from_numpy(
    registry_type: str,
    kind: str,
    factory_kwargs: Mapping[str, Any],
    n_features: int,
    params: Mapping[str, Any],
    lookback: int = 1,
    target_offset: int = 0,
    compute_dtype: str = "float32",
    estimator_params: Optional[Mapping[str, Any]] = None,
    device="cuda",
):
    """A fitted port estimator (``AutoEncoder``, ``LSTMAutoEncoder``,
    ``LSTMForecast`` or ``ConvAutoEncoder``) from numpy pieces: ``params``
    is a Flax param tree of its model, ``estimator_params`` the
    constructor's arguments (its ``get_params()``; ``kind``, the factory
    kwargs, ``compute_dtype`` and ``lookback`` when absent). The weights are
    checked against the factory's module; the module itself is built on
    ``device`` at the first ``predict``."""
    from gordo_components_torch.models import models

    cls = getattr(models, registry_type, None)
    if not (isinstance(cls, type) and issubclass(cls, models.BaseEstimator)) or cls is models.BaseEstimator:
        raise ValueError(f"{registry_type!r} is not an estimator of the port")
    kwargs = dict(estimator_params if estimator_params is not None else
                  {"kind": kind, "compute_dtype": compute_dtype, **factory_kwargs})
    kwargs.pop("device", None)
    if registry_type in SEQUENCE_TYPES:
        kwargs.setdefault("lookback_window", int(lookback))
    est = cls(**kwargs, device=device)
    got = (est.kind, dict(est.factory_kwargs), str(est.compute_dtype),
           int(getattr(est, "lookback_window", 1)), est._target_offset)
    want = (kind, dict(factory_kwargs), str(compute_dtype), int(lookback), int(target_offset))
    if json.dumps(got) != json.dumps(want, default=list):
        raise ValueError(f"{registry_type}: its arguments give {got}, the artifact says {want}")
    state = params_from_flax(params)
    shapes = {k: tuple(v.shape) for k, v in est._build_module(int(n_features)).state_dict().items()}
    if {k: tuple(np.shape(v)) for k, v in state.items()} != shapes:
        raise ValueError(f"{registry_type}({kind!r}) at {n_features} features wants {shapes}")
    est.params_ = state
    est.n_features_ = int(n_features)
    return est
