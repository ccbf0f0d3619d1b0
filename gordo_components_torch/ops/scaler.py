"""Affine feature scaling, ``transform(x) = (x - shift) * scale``.

Counterpart of ``gordo_components_tpu/ops/scaler.py``: the struct, the
transforms and the fits. Min-max, standard and identity scalers are all
this one affine form, so a bank stacks them as two ``(M, F)`` tensors and a
fleet fits ``M`` of them at once: every fit reduces over the row axis
(``-2``) and keeps any leading member axis.

All fits ignore NaN rows, so a fleet that masks its padding rows with NaN
fits each member on its real rows only.

The robust and max-abs fits (:func:`fit_robust`, :func:`fit_maxabs`) are
sklearn's, on numpy arrays in the input's dtype: the numpy functions
sklearn 1.9's ``RobustScaler`` and ``MaxAbsScaler`` call (``np.nanmedian``,
``np.nanpercentile`` column by column with the default linear method,
``np.nanmax``) and its ``_handle_zeros_in_scale`` rule, so their fitted
attributes are sklearn's to the bit. ``unit_variance`` divides by the
normal quantile gap from ``statistics.NormalDist().inv_cdf``, where sklearn
takes ``scipy.stats.norm.ppf``.
"""

from statistics import NormalDist
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
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


def fit_standard(X: torch.Tensor, eps: float = 1e-12, with_mean: bool = True,
                 with_std: bool = True) -> ScalerParams:
    """Standard (z-score) scaler fit over the rows of ``X``; without
    ``with_mean`` the shift is 0, without ``with_std`` the scale is 1
    (sklearn's ``StandardScaler`` arguments)."""
    mean = torch.nanmean(X, dim=-2)
    std = torch.sqrt(torch.nanmean((X - mean.unsqueeze(-2)) ** 2, dim=-2))
    std = torch.where(std < eps, torch.ones_like(std), std)
    return ScalerParams(shift=mean if with_mean else torch.zeros_like(mean),
                        scale=1.0 / std if with_std else torch.ones_like(std))


def handle_zeros_in_scale(scale: np.ndarray) -> np.ndarray:
    """sklearn's ``_handle_zeros_in_scale``: scales below ten machine
    epsilons of their dtype (near-constant features) become 1."""
    scale = np.array(scale, copy=True)
    scale[scale < 10 * np.finfo(scale.dtype).eps] = 1.0
    return scale


def fit_robust(X: np.ndarray, with_centering: bool = True, with_scaling: bool = True,
               quantile_range: Sequence[float] = (25.0, 75.0), unit_variance: bool = False
               ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """sklearn's ``RobustScaler.fit`` on (n_samples, n_features): ``(center_,
    scale_)``, each None when its step is off."""
    q_min, q_max = quantile_range
    if not 0 <= q_min <= q_max <= 100:
        raise ValueError(f"Invalid quantile range: {tuple(quantile_range)}")
    center = np.nanmedian(X, axis=0) if with_centering else None
    if not with_scaling:
        return center, None
    quantiles = np.transpose([np.nanpercentile(X[:, j], quantile_range) for j in range(X.shape[1])])
    scale = handle_zeros_in_scale(quantiles[1] - quantiles[0])
    if unit_variance:
        normal = NormalDist()
        scale = scale / np.float64(normal.inv_cdf(q_max / 100.0) - normal.inv_cdf(q_min / 100.0))
    return center, scale


def fit_maxabs(X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """sklearn's ``MaxAbsScaler.fit`` on (n_samples, n_features):
    ``(max_abs_, scale_)``."""
    max_abs = np.nanmax(np.abs(X), axis=0)
    return max_abs, handle_zeros_in_scale(max_abs)


def identity_scaler(n_features: int, device=None) -> ScalerParams:
    return ScalerParams(
        shift=torch.zeros(n_features, device=device), scale=torch.ones(n_features, device=device)
    )


def scaler_transform(params: ScalerParams, X: torch.Tensor) -> torch.Tensor:
    return (X - params.shift) * params.scale


def scaler_inverse_transform(params: ScalerParams, X: torch.Tensor) -> torch.Tensor:
    return X / params.scale + params.shift
