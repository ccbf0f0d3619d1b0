"""Conv1D autoencoder factory.

Counterpart of ``gordo_components_tpu/models/factories/conv.py``
(``BASELINE.json`` config 4): over lookback windows (N, lookback,
n_features), a strided Conv1D encoder halves the time axis per layer, a
ConvTranspose decoder doubles it back, a stride-1 convolution returns to
``n_features``, and the model's output is the last time step, so the conv
family trains and scores on the windows the LSTM families use.

Every (transposed) convolution is computed one way, for every member of a
stack at once: pad (SAME), take the taps as a strided view
(``Tensor.unfold``), then one ``torch.baddbmm`` of ``(M, N * L_out, F_in *
K) @ (M, F_in * K, C)``. The JAX package offers two formulations of the
same convolution, ``conv_impl="matmul"`` (slices and products) and
``"lax"`` (XLA's conv ops), with the same parameters; the port accepts both
names and computes this one for either. A transposed convolution of stride
2 is the convolution of the input dilated by 2, padded "ceil-major" (the
low pad is ``pad_total - pad_total // 2``), as the JAX package calibrates
it against Flax; other strides raise, as there.

Parameters keep Flax's names and layout: ``Conv_i.kernel`` (K, F_in, C),
``Conv_i.bias`` (C,), ``ConvTranspose_j.kernel``/``.bias``, the final
convolution last (``Conv_{len(channels)}``).

In bfloat16 (``compute_dtype``) the windows, kernels and biases are cast
to bfloat16 and each (transposed) convolution is one ``torch.bmm`` over
the taps, accumulated in float32 and rounded once, with the bias then added
in bfloat16, as ``nn.Conv(dtype=bfloat16)`` rounds (JAX ``conv.py:126-174``;
the JAX package's ``"matmul"`` formulation rounds after every tap, within
the bfloat16 band of ``tests/test_conv_impl.py``); the output is float32.
"""

import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as tF
from torch import nn

from gordo_components_torch.device import resolve_compute_dtype
from gordo_components_torch.models.register import register_model_builder
from gordo_components_torch.ops.activations import resolve_activation
from gordo_components_torch.ops.dense import dense

# names the default conv_impl, as in the JAX package; the value is resolved
# and validated as there (a bad one raises), then ignored: both names compute
# the same convolution here
CONV_IMPL_ENV = "GORDO_CONV_IMPL"
_CONV_IMPLS = ("lax", "matmul")

ConvWeights = List[Tuple[torch.Tensor, torch.Tensor]]  # per layer (kernel (M, K, F_in, C), bias (M, C))


def conv1d(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, stride: int) -> torch.Tensor:
    """SAME-padded strided convolution of every member at once: ``x`` (M, N,
    L, F_in), ``kernel`` (M, K, F_in, C), ``bias`` (M, C) -> (M, N,
    ceil(L / stride), C); the low pad is ``pad_total // 2``."""
    M, N, L, F = x.shape
    K = kernel.shape[1]
    out_len = -(-L // stride)
    pad_total = max((out_len - 1) * stride + K - L, 0)
    lo = pad_total // 2
    return _taps(tF.pad(x, (0, 0, lo, pad_total - lo)), kernel, bias, stride, out_len)


def conv_transpose1d(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                     stride: int = 2) -> torch.Tensor:
    """SAME-padded stride-2 transposed convolution, (M, N, L, F_in) -> (M,
    N, 2L, C): the convolution of the input dilated by 2 (zeros between the
    rows), padded ceil-major. The padding split is calibrated against Flax
    for stride 2 only (JAX ``MatmulConvTranspose``): other strides raise."""
    if stride != 2:
        raise NotImplementedError("MatmulConvTranspose parity is calibrated for stride 2")
    M, N, L, F = x.shape
    K = kernel.shape[1]
    dil = torch.stack([x, torch.zeros_like(x)], dim=3).reshape(M, N, 2 * L, F)[:, :, : 2 * L - 1]
    out_len = 2 * L
    pad_total = out_len - (2 * L - 1) + K - 1
    lo = pad_total - pad_total // 2
    return _taps(tF.pad(dil, (0, 0, lo, pad_total - lo)), kernel, bias, 1, out_len)


def _taps(xp, kernel, bias, stride: int, out_len: int) -> torch.Tensor:
    """``y[:, :, o] = bias + sum_k xp[:, :, o * stride + k] @ kernel[:, k]``
    as one batched product over the taps' strided view, in ``xp``'s dtype."""
    M, N, _, F = xp.shape
    K, C = kernel.shape[1], kernel.shape[-1]
    taps = xp.unfold(2, K, stride)[:, :, :out_len]  # (M, N, out_len, F, K), a view
    W = kernel.transpose(1, 2).reshape(M, F * K, C)  # row f * K + k is kernel[k, f]
    y = dense(taps.reshape(M, N * out_len, F * K), W, bias)
    return y.view(M, N, out_len, C)


def conv_autoencoder_forward(weights: ConvWeights, x: torch.Tensor, n_encoder: int, act,
                             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The conv autoencoder for ``M`` members at once, computed in
    ``dtype``: windows ``x`` (M, N, lookback, F) -> float32 (M, N, F), the
    last step of the reconstruction. ``weights`` are the layers in parameter
    order: ``n_encoder`` strided convolutions, as many transposed ones, then
    the final convolution."""
    x = x.to(dtype)
    for kernel, bias in weights[:n_encoder]:
        x = act(conv1d(x, kernel, bias, 2))
    for kernel, bias in weights[n_encoder:-1]:
        x = act(conv_transpose1d(x, kernel, bias))
    kernel, bias = weights[-1]
    # only the last step of the final (stride-1, SAME) convolution is kept:
    # compute that step alone, from the last K rows of the padded input
    K = kernel.shape[1]
    lo = (K - 1) // 2
    xp = tF.pad(x, (0, 0, lo, K - 1 - lo))[:, :, -K:]
    return _taps(xp, kernel, bias, 1, 1)[:, :, 0].float()


class _ConvLayer(nn.Module):
    def __init__(self, kernel_size: int, n_in: int, n_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kernel_size, n_in, n_out))
        self.bias = nn.Parameter(torch.zeros(n_out))


class Conv1DAutoEncoder(nn.Module):
    """Windows (N, lookback, n_features) -> (N, n_features). A lookback that
    is not a multiple of ``2 ** len(channels)`` is legal: the decoder's
    length then differs from the lookback, and the last step is taken."""

    family = "conv"  # keys the port's per-family tables (models.register.by_family)
    windowed = True  # the model reads windows of rows

    def __init__(self, n_features: int, channels: Tuple[int, ...], kernel_size: int, func: str,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.n_features = n_features
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.channels = tuple(channels)
        self.kernel_size = int(kernel_size)
        self.func = func
        self.activation = resolve_activation(func)
        widths = [n_features, *self.channels]
        for i, (n_in, n_out) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"Conv_{i}", _ConvLayer(kernel_size, n_in, n_out))
        back = [self.channels[-1], *reversed(self.channels)]
        for j, (n_in, n_out) in enumerate(zip(back[:-1], back[1:])):
            self.add_module(f"ConvTranspose_{j}", _ConvLayer(kernel_size, n_in, n_out))
        self.add_module(f"Conv_{len(self.channels)}", _ConvLayer(kernel_size, self.channels[0], n_features))

    def layer_names(self) -> List[str]:
        """The layers in parameter (and forward) order."""
        n = len(self.channels)
        return [f"Conv_{i}" for i in range(n)] + [f"ConvTranspose_{j}" for j in range(n)] + [f"Conv_{n}"]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weights = [(getattr(self, n).kernel[None], getattr(self, n).bias[None]) for n in self.layer_names()]
        return conv_autoencoder_forward(weights, x[None], len(self.channels), self.activation,
                                        self.compute_dtype)[0]


@register_model_builder(type="ConvAutoEncoder")
@register_model_builder(type="LSTMAutoEncoder")
def conv1d_autoencoder(
    n_features: int,
    channels: Sequence[int] = (32, 16),
    kernel_size: int = 3,
    func: str = "relu",
    compute_dtype: str = "float32",
    conv_impl: Optional[str] = None,
    **_ignored,
) -> Conv1DAutoEncoder:
    """Conv1D window autoencoder (reference: ``conv1d_autoencoder``).
    ``conv_impl`` is ``"matmul"`` or ``"lax"`` (default: ``GORDO_CONV_IMPL``,
    else ``"matmul"``), accepted so that the JAX package's configurations
    load; it is validated and ignored, both naming the same convolution."""
    if conv_impl is None:
        conv_impl = os.environ.get(CONV_IMPL_ENV, "").strip().lower() or "matmul"
    if conv_impl not in _CONV_IMPLS:
        raise ValueError(f"conv_impl must be 'lax' or 'matmul', got {conv_impl!r}")
    channels = tuple(channels)
    if not channels:
        raise ValueError("channels must be non-empty")
    return Conv1DAutoEncoder(n_features, channels, kernel_size, func, compute_dtype)
