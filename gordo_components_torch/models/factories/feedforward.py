"""Feedforward autoencoder factories.

Counterpart of ``gordo_components_tpu/models/factories/feedforward.py``:
dense encoder/decoder stacks, where ``feedforward_hourglass`` (the default
model) shrinks the encoder dims by ``compression_factor`` over
``encoding_layers``. Layers are ``nn.Linear`` with float32 parameters; the
module computes in ``compute_dtype`` (float32, or bfloat16 as Flax's
``Dense(dtype=bfloat16)`` rounds, ``ops/dense.py``) and returns float32.
"""

from typing import List, Sequence, Tuple

import torch
from torch import nn

from gordo_components_torch.device import resolve_compute_dtype
from gordo_components_torch.models.register import register_model_builder
from gordo_components_torch.ops.activations import resolve_activation
from gordo_components_torch.ops.dense import dense_chain


class FeedForwardAutoEncoder(nn.Module):
    """Dense autoencoder: encoder dims, then decoder dims, then an output
    layer back to ``n_features``. ``layers[i]`` is Flax's ``Dense_i``."""

    family = "dense"  # keys the port's per-family tables (models.register.by_family)
    windowed = False  # the model reads rows

    def __init__(
        self,
        n_features: int,
        encoding_dim: Tuple[int, ...],
        decoding_dim: Tuple[int, ...],
        encoding_func: Tuple[str, ...],
        decoding_func: Tuple[str, ...],
        out_func: str = "linear",
        compute_dtype: str = "float32",
    ):
        super().__init__()
        self.n_features = n_features
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        dims = [n_features, *encoding_dim, *decoding_dim, n_features]
        self.funcs: List[str] = [*encoding_func, *decoding_func, out_func]
        self.activations = [resolve_activation(f) for f in self.funcs]
        self.layers = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(dims[:-1], dims[1:])
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the bank's dense chain with one member, so that a detector and
        # its bank bucket compute alike
        chain = [(layer.weight.T[None], layer.bias[None], act)
                 for layer, act in zip(self.layers, self.activations)]
        return dense_chain(x[None], chain, self.compute_dtype)[0].float()

    def serving_chain(self, state) -> list:
        """The forward as ``(kernel (in, out), bias, activation)`` layers
        from a state dict (the bank's dense chain)."""
        return [(state[f"layers.{i}.weight"].T, state[f"layers.{i}.bias"], act)
                for i, act in enumerate(self.activations)]


def _norm_funcs(funcs, n, default):
    if funcs is None:
        return (default,) * n
    funcs = tuple(funcs)
    if len(funcs) != n:
        raise ValueError(f"Need {n} activation funcs, got {len(funcs)}")
    return funcs


@register_model_builder(type="AutoEncoder")
def feedforward_model(
    n_features: int,
    encoding_dim: Sequence[int] = (256, 128, 64),
    decoding_dim: Sequence[int] = (64, 128, 256),
    encoding_func: Sequence[str] = None,
    decoding_func: Sequence[str] = None,
    out_func: str = "linear",
    compute_dtype: str = "float32",
    **_ignored,
) -> FeedForwardAutoEncoder:
    """Fully specified dense autoencoder (reference: ``feedforward_model``)."""
    return FeedForwardAutoEncoder(
        n_features=n_features,
        encoding_dim=tuple(encoding_dim),
        decoding_dim=tuple(decoding_dim),
        encoding_func=_norm_funcs(encoding_func, len(encoding_dim), "tanh"),
        decoding_func=_norm_funcs(decoding_func, len(decoding_dim), "tanh"),
        out_func=out_func,
        compute_dtype=compute_dtype,
    )


@register_model_builder(type="AutoEncoder")
def feedforward_symmetric(
    n_features: int,
    dims: Sequence[int] = (256, 128, 64),
    funcs: Sequence[str] = None,
    compute_dtype: str = "float32",
    **_ignored,
) -> FeedForwardAutoEncoder:
    """Symmetric dense autoencoder: decoder mirrors the encoder
    (reference: ``feedforward_symmetric``)."""
    if not dims:
        raise ValueError("dims must be non-empty")
    funcs = _norm_funcs(funcs, len(dims), "tanh")
    return feedforward_model(
        n_features,
        encoding_dim=tuple(dims),
        decoding_dim=tuple(reversed(dims)),
        encoding_func=funcs,
        decoding_func=tuple(reversed(funcs)),
        compute_dtype=compute_dtype,
    )


def hourglass_calc_dims(compression_factor: float, encoding_layers: int, n_features: int):
    """Linearly interpolated layer dims from ``n_features`` down to
    ``n_features * compression_factor`` (reference hourglass geometry)."""
    if not 0 <= compression_factor <= 1:
        raise ValueError("compression_factor must be 0..1")
    if encoding_layers < 1:
        raise ValueError("encoding_layers must be >= 1")
    smallest = max(1, round(n_features * compression_factor))
    dims = [
        max(1, round(n_features - (n_features - smallest) * (i / encoding_layers)))
        for i in range(1, encoding_layers + 1)
    ]
    return tuple(dims)


@register_model_builder(type="AutoEncoder")
def feedforward_hourglass(
    n_features: int,
    encoding_layers: int = 3,
    compression_factor: float = 0.5,
    func: str = "tanh",
    compute_dtype: str = "float32",
    **_ignored,
) -> FeedForwardAutoEncoder:
    """Hourglass dense autoencoder — the reference's default model
    (reference: ``feedforward_hourglass``)."""
    dims = hourglass_calc_dims(compression_factor, encoding_layers, n_features)
    return feedforward_symmetric(
        n_features, dims=dims, funcs=(func,) * len(dims), compute_dtype=compute_dtype
    )
