"""Sliding-window construction for sequence models.

Counterpart of ``gordo_components_tpu/ops/windows.py``: windows are a batch
dimension, so one LSTM step runs over every window at once. Here they are a
strided view (``Tensor.unfold``), copied only when a consumer needs them
contiguous.
"""

import torch


def num_windows(n_samples: int, lookback: int) -> int:
    """Number of complete lookback windows in a series of ``n_samples``."""
    return max(0, n_samples - lookback + 1)


def sliding_windows(X: torch.Tensor, lookback: int) -> torch.Tensor:
    """``(..., n_samples, n_features)`` -> ``(..., n_windows, lookback,
    n_features)``; window ``i`` covers rows ``[i, i + lookback)``. Leading
    dimensions (a batch of series) are kept. Needs ``n_samples >= lookback``."""
    return X.unfold(-2, lookback, 1).transpose(-1, -2)
