"""Elementwise activations by name, as the reference's factories name them
(``gordo_components_tpu/models/factories/feedforward.py``).

In bfloat16, ``sigmoid`` and ``softplus`` round as XLA computes them for a
bfloat16 input, every operation of their expansion rounded to bfloat16
(the logistic as ``1 / (1 + exp(-x))``, ``softplus`` as ``logaddexp(x,
0)``); the others round their float32 result once, as XLA does too.
"""

from typing import Callable

import torch
import torch.nn.functional as tF


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def softplus(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        return tF.softplus(x)
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": tF.relu,
    "sigmoid": sigmoid,
    "elu": tF.elu,
    "linear": lambda x: x,
    "softplus": softplus,
}


def resolve_activation(name: str) -> Callable:
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"Unknown activation {name!r}; known: {sorted(_ACTIVATIONS)}")
