"""Affine feature scaling, ``transform(x) = (x - shift) * scale``.

Counterpart of ``gordo_components_tpu/ops/scaler.py``: the struct, the
transforms and the fits. Min-max, standard and identity scalers are all
this one affine form, so a bank stacks them as two ``(M, F)`` tensors and a
fleet fits ``M`` of them at once: every fit reduces over the row axis
(``-2``) and keeps any leading member axis.

All fits ignore NaN rows, so a fleet that masks its padding rows with NaN
fits each member on its real rows only.
"""

from typing import NamedTuple

import torch


class ScalerParams(NamedTuple):
    shift: torch.Tensor  # (..., n_features)
    scale: torch.Tensor  # (..., n_features)


def fit_minmax(X: torch.Tensor, feature_range=(0.0, 1.0), eps: float = 1e-12) -> ScalerParams:
    """Min-max scaler fit over the rows of ``X`` (..., n_samples, n_features).

    sklearn's ``MinMaxScaler`` semantics for the default (0, 1) range;
    constant features map to the range minimum (the span is guarded by
    ``eps``)."""
    lo, hi = feature_range
    finite = ~torch.isnan(X)
    xmin = torch.where(finite, X, torch.inf).amin(dim=-2)
    xmax = torch.where(finite, X, -torch.inf).amax(dim=-2)
    span = xmax - xmin
    span = torch.where(span.abs() < eps, torch.ones_like(span), span)
    scale = (hi - lo) / span
    # transform = (x - xmin) * scale + lo  ==  (x - (xmin - lo/scale)) * scale
    return ScalerParams(shift=xmin - lo / scale, scale=scale)


def fit_standard(X: torch.Tensor, eps: float = 1e-12) -> ScalerParams:
    """Standard (z-score) scaler fit over the rows of ``X``."""
    mean = torch.nanmean(X, dim=-2)
    std = torch.sqrt(torch.nanmean((X - mean.unsqueeze(-2)) ** 2, dim=-2))
    std = torch.where(std < eps, torch.ones_like(std), std)
    return ScalerParams(shift=mean, scale=1.0 / std)


def identity_scaler(n_features: int, device=None) -> ScalerParams:
    return ScalerParams(
        shift=torch.zeros(n_features, device=device), scale=torch.ones(n_features, device=device)
    )


def scaler_transform(params: ScalerParams, X: torch.Tensor) -> torch.Tensor:
    return (X - params.shift) * params.scale


def scaler_inverse_transform(params: ScalerParams, X: torch.Tensor) -> torch.Tensor:
    return X / params.scale + params.shift
