"""LSTM autoencoder/forecast factories.

Counterpart of ``gordo_components_tpu/models/factories/lstm.py``: stacked
LSTMs over a ``lookback`` window of timesteps, each layer's whole output
sequence (through its activation) feeding the next, and a Dense head on the
last layer's final hidden state back to ``n_features``. The recurrence runs
through :func:`~gordo_components_torch.ops.seq_scan.lstm_time_major_forward`
(the fused-step CUDA kernel on the card), never ``nn.LSTM``/cuDNN.

Parameters keep Flax ``OptimizedLSTMCell``'s layout: per layer ``Wi``
(in, 4H), ``Wh`` (H, 4H) and ``b`` (4H,) in gate order i, f, g, o, with the
bias on the hidden half only; the head is ``kernel`` (H, F), ``bias`` (F,).
"""

from typing import Sequence, Tuple

import torch
from torch import nn

from gordo_components_torch.models.factories.feedforward import (
    _check_dtype,
    _norm_funcs,
    hourglass_calc_dims,
)
from gordo_components_torch.models.register import register_model_builder
from gordo_components_torch.ops.seq_scan import Weights, lstm_time_major_forward


def _frozen(*shape) -> nn.Parameter:
    # the kernel is forward-only, so no parameter asks for a gradient
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


class _LSTMLayer(nn.Module):
    def __init__(self, n_in: int, hidden: int):
        super().__init__()
        self.Wi = _frozen(n_in, 4 * hidden)
        self.Wh = _frozen(hidden, 4 * hidden)
        self.b = _frozen(4 * hidden)


class _Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.kernel = _frozen(n_in, n_out)
        self.bias = _frozen(n_out)


class LSTMStack(nn.Module):
    """Stacked LSTMs over windows (N, lookback, n_features) -> (N, n_features).
    ``layers[i]`` is Flax's ``OptimizedLSTMCell_i``, ``head`` its ``Dense_0``.
    Weights start at zero and stay frozen: the module scores fitted weights;
    training runs on the stacked parameters of
    ``models/train_core.StackedLSTM``, whose gradient step goes through
    ``ops/seq_scan.lstm_train_forward``."""

    def __init__(
        self,
        n_features: int,
        dims: Tuple[int, ...],
        funcs: Tuple[str, ...],
        out_func: str = "linear",
    ):
        super().__init__()
        self.n_features = n_features
        self.dims = tuple(dims)
        self.funcs = tuple(funcs)
        self.out_func = out_func
        ins = (n_features, *self.dims[:-1])
        self.layers = nn.ModuleList(_LSTMLayer(i, h) for i, h in zip(ins, self.dims))
        self.head = _Dense(self.dims[-1], n_features)

    def weights(self) -> Weights:
        """``(layers, (Wd, bd))`` with a leading member axis of 1."""
        return (
            [(l.Wi[None], l.Wh[None], l.b[None]) for l in self.layers],
            (self.head.kernel[None], self.head.bias[None]),
        )

    def forward(self, windows: torch.Tensor) -> torch.Tensor:
        return lstm_time_major_forward(
            self.weights(), windows[None], self.funcs, self.out_func
        )[0]


@register_model_builder(type="LSTMAutoEncoder")
@register_model_builder(type="LSTMForecast")
def lstm_model(
    n_features: int,
    dims: Sequence[int] = (64, 64),
    funcs: Sequence[str] = None,
    out_func: str = "linear",
    compute_dtype: str = "float32",
    **_ignored,
) -> LSTMStack:
    """Fully specified LSTM stack (reference: ``lstm_model``)."""
    _check_dtype(compute_dtype)
    dims = tuple(dims)
    if not dims:
        raise ValueError("dims must be non-empty")
    return LSTMStack(n_features, dims, _norm_funcs(funcs, len(dims), "tanh"), out_func)


@register_model_builder(type="LSTMAutoEncoder")
@register_model_builder(type="LSTMForecast")
def lstm_symmetric(
    n_features: int,
    dims: Sequence[int] = (64, 32),
    funcs: Sequence[str] = None,
    out_func: str = "linear",
    compute_dtype: str = "float32",
    **_ignored,
) -> LSTMStack:
    """Symmetric LSTM autoencoder: encoder dims then mirrored decoder dims
    (reference: ``lstm_symmetric``)."""
    dims = tuple(dims)
    if not dims:
        raise ValueError("dims must be non-empty")
    funcs = _norm_funcs(funcs, len(dims), "tanh")
    return lstm_model(
        n_features, dims=dims + dims[::-1], funcs=funcs + funcs[::-1],
        out_func=out_func, compute_dtype=compute_dtype,
    )


@register_model_builder(type="LSTMAutoEncoder")
@register_model_builder(type="LSTMForecast")
def lstm_hourglass(
    n_features: int,
    encoding_layers: int = 3,
    compression_factor: float = 0.5,
    func: str = "tanh",
    out_func: str = "linear",
    compute_dtype: str = "float32",
    **_ignored,
) -> LSTMStack:
    """Hourglass LSTM — the reference's default sequence model (reference:
    ``lstm_hourglass``): layer sizes shrink by ``compression_factor`` then
    mirror back up."""
    dims = hourglass_calc_dims(compression_factor, encoding_layers, n_features)
    return lstm_symmetric(
        n_features, dims=dims, funcs=(func,) * len(dims), out_func=out_func,
        compute_dtype=compute_dtype,
    )
