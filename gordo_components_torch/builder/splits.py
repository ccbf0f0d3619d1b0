"""Time-series cross-validation folds in numpy.

Counterpart of ``sklearn.model_selection.TimeSeriesSplit`` with its default
arguments, which the JAX package's builders call: the same fold indices,
and ``ValueError`` where sklearn raises one.
"""

import numbers
from typing import Iterator, Tuple

import numpy as np


class TimeSeriesSplit:
    """``n_splits`` folds over ordered rows: fold k trains on every row
    before its test block, and the test blocks are the last ``n_splits``
    blocks of ``n_samples // (n_splits + 1)`` rows (the first fold's
    training rows take the remainder)."""

    def __init__(self, n_splits: int = 5):
        if not isinstance(n_splits, numbers.Integral):
            raise ValueError(f"The number of folds must be of Integral type, got {n_splits!r}")
        if n_splits <= 1:
            raise ValueError(f"cross-validation requires at least two splits, got n_splits={n_splits}")
        self.n_splits = int(n_splits)

    def split(self, X) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n_samples = len(X)
        n_folds = self.n_splits + 1
        if n_folds > n_samples:
            raise ValueError(f"Cannot have number of folds={n_folds} greater than the number of "
                             f"samples={n_samples}.")
        test_size = n_samples // n_folds
        indices = np.arange(n_samples)
        for start in range(n_samples - self.n_splits * test_size, n_samples, test_size):
            yield indices[:start], indices[start:start + test_size]
