"""Losses and scores for autoencoder training and evaluation.

Counterpart of ``gordo_components_tpu/ops/losses.py``: the masked mean
squared error the train core minimizes (``mask`` drops padded rows out of
the loss without dynamic shapes) and sklearn's explained variance, r2, MSE
and MAE for scoring, with sklearn's 0/0 convention for constant columns.
"""

from typing import Optional

import torch


def mse_loss(
    pred: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean squared error over the last two axes' rows; ``mask`` is
    ``(..., n_samples)`` with 1 for real rows and 0 for padding. Leading
    axes (a member axis) are kept, so a stacked fleet gets one loss per
    member: ``pred`` (M, B, F) and ``mask`` (M, B) give (M,)."""
    err = (pred - target) ** 2
    if mask is None:
        return err.mean(dim=(-2, -1))
    denom = torch.clamp(mask.sum(-1), min=1.0) * err.shape[-1]
    return (err * mask[..., None]).sum(dim=(-2, -1)) / denom


def _ratio_score(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """sklearn's 0/0 convention for variance-ratio scores: 1 - num/den,
    but a zero-variance output scores 1.0 when predicted perfectly
    (num == 0) and 0.0 otherwise."""
    safe = torch.where(den > 0, den, torch.ones_like(den))
    return torch.where(
        den > 0, 1.0 - num / safe,
        torch.where(num == 0, torch.ones_like(num), torch.zeros_like(num)),
    )


def _var(x: torch.Tensor) -> torch.Tensor:
    return ((x - x.mean(dim=0)) ** 2).mean(dim=0)


def explained_variance(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Uniform-average explained variance, matching
    ``sklearn.metrics.explained_variance_score`` defaults (including the
    0/0 -> 1.0 constant-column convention)."""
    diff = y_true - y_pred
    return _ratio_score(_var(diff), _var(y_true)).mean()


def regression_metrics(y_true: torch.Tensor, y_pred: torch.Tensor) -> dict:
    """The reference's evaluation metric set over (rows, features) tensors,
    uniform-averaged over outputs with sklearn-default semantics: explained
    variance, r2, MSE, MAE, as Python floats for metadata."""
    diff = y_true - y_pred
    mse_per = (diff**2).mean(dim=0)
    den = _var(y_true)
    return {
        "explained-variance": float(explained_variance(y_true, y_pred)),
        "r2-score": float(_ratio_score(mse_per, den).mean()),
        "mean-squared-error": float(mse_per.mean()),
        "mean-absolute-error": float(diff.abs().mean()),
    }
