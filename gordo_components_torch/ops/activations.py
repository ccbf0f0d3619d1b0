"""Elementwise activations by name, as the reference's factories name them
(``gordo_components_tpu/models/factories/feedforward.py``)."""

from typing import Callable

import torch
import torch.nn.functional as tF

_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": tF.relu,
    "sigmoid": torch.sigmoid,
    "elu": tF.elu,
    "linear": lambda x: x,
    "softplus": tF.softplus,
}


def resolve_activation(name: str) -> Callable:
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"Unknown activation {name!r}; known: {sorted(_ACTIVATIONS)}")
