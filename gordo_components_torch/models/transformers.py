"""Scalers and the pipeline a model configuration names.

Counterpart of ``gordo_components_tpu/models/transformers.py``, and the
port's stand-ins for the three sklearn classes the reference's configs name
(``serializer/definitions.py`` resolves ``sklearn.pipeline.Pipeline``,
``sklearn.preprocessing.MinMaxScaler`` and
``sklearn.preprocessing.StandardScaler`` to the classes here; the port
imports no sklearn).

A fitted scaler exposes its fit as ``scaler_params_``, a
:class:`~gordo_components_torch.ops.scaler.ScalerParams` of numpy arrays, so
a fitted detector composes its input affine for the bank directly.
Transforms compute ``(x - shift) * scale`` in float32, the bank's own
arithmetic. sklearn's ``MinMaxScaler`` computes ``x * scale_ + min_``
instead, which rounds differently in the last bits: the two agree within
float32 rounding of the scaled values (a few ULP), not bitwise.
"""

from typing import Optional

import numpy as np
import torch

from gordo_components_torch.ops.scaler import (
    ScalerParams,
    fit_minmax,
    fit_standard,
    scaler_inverse_transform,
    scaler_transform,
)
from gordo_components_torch.utils import capture_args


def _f32(X) -> np.ndarray:
    return np.array(X.values if hasattr(X, "values") else X, dtype=np.float32)  # an owned copy


class _AffineScaler:
    """A per-feature affine scaler fitted on the CPU; subclasses name the fit."""

    def __init__(self):
        self.scaler_params_: Optional[ScalerParams] = None
        self.n_features_: Optional[int] = None

    def _fit_params(self, X: torch.Tensor) -> ScalerParams:
        raise NotImplementedError

    def set_fitted(self, params: ScalerParams, n_features: int):
        """Adopt externally fitted (e.g. fleet-stacked) scaler params."""
        self.scaler_params_ = ScalerParams(
            shift=np.asarray(params.shift, np.float32), scale=np.asarray(params.scale, np.float32)
        )
        self.n_features_ = int(n_features)
        return self

    def fit(self, X, y=None):
        X = _f32(X)
        params = self._fit_params(torch.from_numpy(X))
        return self.set_fitted(ScalerParams(params.shift.numpy(), params.scale.numpy()), X.shape[-1])

    def _apply(self, fn, X) -> np.ndarray:
        if self.scaler_params_ is None:
            raise RuntimeError(f"{type(self).__name__} is not fitted")
        params = ScalerParams(*(torch.from_numpy(a) for a in self.scaler_params_))
        return fn(params, torch.from_numpy(_f32(X))).numpy()

    def transform(self, X) -> np.ndarray:
        return self._apply(scaler_transform, X)

    def inverse_transform(self, X) -> np.ndarray:
        return self._apply(scaler_inverse_transform, X)

    def fit_transform(self, X, y=None) -> np.ndarray:
        return self.fit(X, y).transform(X)

    def get_params(self, deep=True):
        return dict(getattr(self, "_params", {}))


class MinMaxScaler(_AffineScaler):
    """Min-max scaler to ``feature_range`` (NaN rows ignored)."""

    @capture_args
    def __init__(self, feature_range=(0.0, 1.0)):
        super().__init__()
        self.feature_range = tuple(feature_range)

    def _fit_params(self, X):
        return fit_minmax(X, feature_range=self.feature_range)


class StandardScaler(_AffineScaler):
    """Z-score scaler (NaN rows ignored)."""

    @capture_args
    def __init__(self):
        super().__init__()

    def _fit_params(self, X):
        return fit_standard(X)


class Pipeline:
    """``steps`` of ``(name, object)``: every step but the last transforms,
    the last one estimates (the subset of ``sklearn.pipeline.Pipeline`` the
    reference's configurations use)."""

    @capture_args
    def __init__(self, steps):
        self.steps = [tuple(s) for s in steps]

    def _transform(self, X):
        for _, step in self.steps[:-1]:
            X = step.transform(X)
        return X

    def fit(self, X, y=None):
        for _, step in self.steps[:-1]:
            X = step.fit_transform(X)
        self.steps[-1][1].fit(X, y)
        return self

    def predict(self, X):
        return self.steps[-1][1].predict(self._transform(X))

    def transform(self, X):
        return self.steps[-1][1].transform(self._transform(X))

    def score(self, X, y=None) -> float:
        return self.steps[-1][1].score(self._transform(X), y)

    def get_metadata(self):
        """The final estimator's metadata under ``final_step``, as the JAX
        builder records a Pipeline's (``build_model._pipeline_metadata``)."""
        final = self.steps[-1][1]
        return {"final_step": final.get_metadata()} if hasattr(final, "get_metadata") else {}

    def get_params(self, deep=True):
        return dict(getattr(self, "_params", {}))
