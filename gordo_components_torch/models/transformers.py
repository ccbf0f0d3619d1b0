"""Scalers, PCA and the pipeline a model configuration names.

Counterpart of ``gordo_components_tpu/models/transformers.py``, and the
port's stand-ins for the sklearn classes the reference's configs name
(``serializer/definitions.py`` resolves ``sklearn.pipeline.Pipeline``,
``sklearn.preprocessing.{MinMax,Standard,Robust,MaxAbs}Scaler`` and
``sklearn.decomposition.PCA`` to the classes here, and ``FeatureUnion`` and
``TransformedTargetRegressor`` to ``models/compose.py``; the port imports
no sklearn). Each takes the sklearn class's constructor arguments.

The four scalers are affine: a fitted one exposes its fit as
``scaler_params_``, a
:class:`~gordo_components_torch.ops.scaler.ScalerParams` of numpy arrays,
and :func:`affine_params` gives it to a detector, which composes its input
affine for the bank directly. Transforms compute ``(x - shift) * scale`` in
float32, the bank's own arithmetic. sklearn computes ``x * scale_ + min_``
(min-max) or ``(x - center) / scale_`` instead, which rounds differently in
the last bits: the two agree within float32 rounding of the scaled values
(a few ULP), not bitwise. A scaler that clips (``clip=True``) is not
affine: :func:`affine_params` gives None for it, so a detector over it
scores in model space on the per-model path, as for ``PCA``.

The min-max and standard fits run in float32 on torch (``ops/scaler.py``);
the robust and max-abs fits, and ``PCA``, in the input's float dtype with
the numpy functions sklearn 1.9 calls, and keep sklearn's fitted
attributes (``center_``, ``scale_``, ``max_abs_``; ``components_``,
``mean_``, ``explained_variance_``, ...).

Every transformer gives its fitted state as flat numpy arrays
(``fitted_state``) and takes it back (``set_fitted_state``), which is what
the serializer writes; and names its output columns as sklearn's
``get_feature_names_out`` does (``pca0``, ``pca1``, ... for PCA).
"""

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gordo_components_torch.ops.scaler import (
    ScalerParams,
    fit_maxabs,
    fit_minmax,
    fit_robust,
    fit_standard,
    scaler_inverse_transform,
    scaler_transform,
)
from gordo_components_torch.utils import capture_args


def _f32(X) -> np.ndarray:
    return np.array(X.values if hasattr(X, "values") else X, dtype=np.float32)  # an owned copy


def _float(X) -> np.ndarray:
    """X as sklearn's ``validate_data`` gives it to a fit: float32 and
    float64 kept, anything else float64."""
    X = np.asarray(X.values if hasattr(X, "values") else X)
    return X if X.dtype in (np.float32, np.float64) else X.astype(np.float64)


def affine_params(step) -> Optional[ScalerParams]:
    """``(shift, scale)`` of a fitted step that computes ``(x - shift) *
    scale``, else None (a step that is not affine, or not fitted)."""
    fn = getattr(step, "affine_params", None)
    return fn() if fn is not None else None


class _AffineScaler:
    """A per-feature affine scaler fitted on the CPU; subclasses name the
    fit and the sklearn attributes they keep."""

    _ATTRS: Sequence[str] = ()  # sklearn's fitted attributes, kept beside the affine
    clip = False

    def __init__(self):
        self.scaler_params_: Optional[ScalerParams] = None
        self.n_features_: Optional[int] = None

    def _fit_params(self, X) -> ScalerParams:
        """The fit of X (the raw input) as float32 numpy ``(shift, scale)``."""
        raise NotImplementedError

    def set_fitted(self, params: ScalerParams, n_features: int):
        """Adopt externally fitted (e.g. fleet-stacked) scaler params."""
        self.scaler_params_ = ScalerParams(
            shift=np.asarray(params.shift, np.float32), scale=np.asarray(params.scale, np.float32)
        )
        self.n_features_ = int(n_features)
        return self

    def fit(self, X, y=None):
        params = self._fit_params(X)
        return self.set_fitted(params, len(params.shift))

    def affine_params(self) -> Optional[ScalerParams]:
        return None if self.clip else self.scaler_params_

    def _clip_range(self):
        return None

    def _apply(self, fn, X) -> np.ndarray:
        if self.scaler_params_ is None:
            raise RuntimeError(f"{type(self).__name__} is not fitted")
        params = ScalerParams(*(torch.from_numpy(a) for a in self.scaler_params_))
        return fn(params, torch.from_numpy(_f32(X))).numpy()

    def transform(self, X) -> np.ndarray:
        out = self._apply(scaler_transform, X)
        return np.clip(out, *self._clip_range()) if self.clip else out

    def inverse_transform(self, X) -> np.ndarray:
        return self._apply(scaler_inverse_transform, X)

    def fit_transform(self, X, y=None) -> np.ndarray:
        return self.fit(X, y).transform(X)

    def get_feature_names_out(self, input_features: Sequence[str]) -> List[str]:
        return [str(f) for f in input_features]

    def fitted_state(self) -> Dict[str, np.ndarray]:
        if self.scaler_params_ is None:
            raise RuntimeError(f"{type(self).__name__} is not fitted")
        state = {"shift": self.scaler_params_.shift, "scale": self.scaler_params_.scale}
        state.update({a: np.asarray(getattr(self, a)) for a in self._ATTRS if getattr(self, a, None) is not None})
        return state

    def set_fitted_state(self, state: Dict[str, np.ndarray]):
        self.set_fitted(ScalerParams(state["shift"], state["scale"]), len(state["shift"]))
        for a in self._ATTRS:
            setattr(self, a, state.get(a))
        return self

    def get_params(self, deep=True):
        return dict(getattr(self, "_params", {}))


class MinMaxScaler(_AffineScaler):
    """Min-max scaler to ``feature_range`` (NaN rows ignored); ``clip``
    clips transformed values to the range."""

    @capture_args
    def __init__(self, feature_range=(0.0, 1.0), copy=True, clip=False):
        super().__init__()
        self.feature_range = tuple(feature_range)
        self.clip = bool(clip)

    def _fit_params(self, X):
        p = fit_minmax(torch.from_numpy(_f32(X)), feature_range=self.feature_range)
        return ScalerParams(p.shift.numpy(), p.scale.numpy())

    def _clip_range(self):
        return self.feature_range


class StandardScaler(_AffineScaler):
    """Z-score scaler (NaN rows ignored); ``with_mean=False`` does not
    center, ``with_std=False`` does not scale."""

    @capture_args
    def __init__(self, copy=True, with_mean=True, with_std=True):
        super().__init__()
        self.with_mean = bool(with_mean)
        self.with_std = bool(with_std)

    def _fit_params(self, X):
        p = fit_standard(torch.from_numpy(_f32(X)), with_mean=self.with_mean, with_std=self.with_std)
        return ScalerParams(p.shift.numpy(), p.scale.numpy())


class RobustScaler(_AffineScaler):
    """``(x - median) / (q_max - q_min)`` per feature, sklearn's
    ``RobustScaler`` fit to the bit (``ops/scaler.fit_robust``)."""

    _ATTRS = ("center_", "scale_")

    @capture_args
    def __init__(self, with_centering=True, with_scaling=True, quantile_range=(25.0, 75.0), copy=True,
                 unit_variance=False):
        super().__init__()
        self.with_centering = bool(with_centering)
        self.with_scaling = bool(with_scaling)
        self.quantile_range = tuple(quantile_range)
        self.unit_variance = bool(unit_variance)
        self.center_: Optional[np.ndarray] = None
        self.scale_: Optional[np.ndarray] = None

    def _fit_params(self, X):
        X = _float(X)
        self.center_, self.scale_ = fit_robust(X, self.with_centering, self.with_scaling, self.quantile_range,
                                               self.unit_variance)
        n = X.shape[1]
        # the JAX bank's affine of a RobustScaler (bank._affine_from_scaler)
        shift = np.zeros(n, np.float32) if self.center_ is None else np.asarray(self.center_, np.float32)
        scale = (np.ones(n, np.float32) if self.scale_ is None
                 else np.float32(1.0) / np.asarray(self.scale_, np.float32))
        return ScalerParams(shift, scale)


class MaxAbsScaler(_AffineScaler):
    """``x / max|x|`` per feature, sklearn's ``MaxAbsScaler`` fit to the
    bit (``ops/scaler.fit_maxabs``); ``clip`` clips to [-1, 1]."""

    _ATTRS = ("max_abs_", "scale_")

    @capture_args
    def __init__(self, copy=True, clip=False):
        super().__init__()
        self.clip = bool(clip)
        self.max_abs_: Optional[np.ndarray] = None
        self.scale_: Optional[np.ndarray] = None

    def _fit_params(self, X):
        self.max_abs_, self.scale_ = fit_maxabs(_float(X))
        scale = np.float32(1.0) / np.asarray(self.scale_, np.float32)
        return ScalerParams(np.zeros(len(scale), np.float32), scale)

    def _clip_range(self):
        return (-1.0, 1.0)


class PCA:
    """sklearn 1.9's ``PCA`` with its ``full`` and ``covariance_eigh``
    solvers and ``auto``'s choice between them, in numpy, in the input's
    float dtype.

    ``auto`` takes ``covariance_eigh`` for ``n_features <= 1000`` and
    ``n_samples >= 10 * n_features`` (the usual shape of sensor data),
    else ``full`` where sklearn takes it (``max(shape) <= 500``, or a float
    ``n_components``, or an int one of at least ``0.8 * min(shape)``).
    ``randomized`` and ``arpack``, asked for or picked by ``auto``, and
    ``n_components="mle"`` raise ``NotImplementedError``. The SVD is
    numpy's, where sklearn's ``full`` takes scipy's: the components agree
    to rounding, after the same sign rule (``svd_flip(u_based_decision=
    False)``: the largest entry of each row of ``components_`` positive)."""

    _ATTRS = ("components_", "mean_", "explained_variance_", "explained_variance_ratio_", "singular_values_",
              "noise_variance_", "n_components_", "n_samples_")

    @capture_args
    def __init__(self, n_components=None, copy=True, whiten=False, svd_solver="auto", tol=0.0,
                 iterated_power="auto", n_oversamples=10, power_iteration_normalizer="auto", random_state=None):
        self.n_components = n_components
        self.whiten = bool(whiten)
        self.svd_solver = svd_solver
        self.components_: Optional[np.ndarray] = None

    def _solver(self, n_samples: int, n_features: int, n_components) -> str:
        solver = self.svd_solver
        if solver == "auto":
            if n_features <= 1000 and n_samples >= 10 * n_features:
                solver = "covariance_eigh"
            elif max(n_samples, n_features) <= 500 or n_components == "mle":
                solver = "full"
            elif 1 <= n_components < 0.8 * min(n_samples, n_features):
                solver = "randomized"
            else:
                solver = "full"
        if solver not in ("full", "covariance_eigh"):
            raise NotImplementedError(
                f"PCA svd_solver={solver!r}{' (picked by auto)' if self.svd_solver == 'auto' else ''}: "
                "the port has the 'full' and 'covariance_eigh' solvers only")
        return solver

    def _fit(self, X):
        X = _float(X)
        if X.ndim != 2:
            raise ValueError(f"PCA expects 2-D input, got shape {X.shape}")
        if not np.isfinite(X).all():
            raise ValueError("Input X contains NaN or infinity")
        n, F = X.shape
        k = min(n, F) if self.n_components is None else self.n_components
        if k == "mle":
            raise NotImplementedError("PCA n_components='mle' is not ported")
        solver = self._solver(n, F, k)
        if not 0 <= k <= min(n, F):
            raise ValueError(f"n_components={k} must be between 0 and min(n_samples, n_features)={min(n, F)} "
                             f"with svd_solver={solver!r}")
        self.mean_ = np.mean(X, axis=0)
        if solver == "full":
            U, S, Vt = np.linalg.svd(X - self.mean_, full_matrices=False)
            explained_variance = (S ** 2) / (n - 1)
        else:
            C = X.T @ X
            C -= n * np.reshape(self.mean_, (-1, 1)) * np.reshape(self.mean_, (1, -1))
            C /= n - 1
            eigenvals, eigenvecs = np.linalg.eigh(C)
            eigenvals, eigenvecs = np.flip(eigenvals, axis=0), np.flip(eigenvecs, axis=1)
            eigenvals[eigenvals < 0.0] = 0.0
            explained_variance = eigenvals
            S = np.sqrt(eigenvals * (n - 1))
            U, Vt = None, eigenvecs.T
        # svd_flip(u_based_decision=False): each row's largest |entry| positive
        signs = np.sign(Vt[np.arange(Vt.shape[0]), np.argmax(np.abs(Vt), axis=1)])
        Vt = Vt * signs[:, np.newaxis]
        if U is not None:
            U = U * signs[np.newaxis, :]
        ratio = explained_variance / np.sum(explained_variance)
        if 0 < k < 1.0:  # the share of variance to keep
            k = int(np.searchsorted(np.cumsum(ratio), k, side="right") + 1)
        k = int(k)
        self.noise_variance_ = np.mean(explained_variance[k:]) if k < min(F, n) else 0.0
        self.n_samples_ = n
        self.n_components_ = k
        self.components_ = Vt[:k].copy()
        self.explained_variance_ = explained_variance[:k].copy()
        self.explained_variance_ratio_ = ratio[:k].copy()
        self.singular_values_ = S[:k].copy()
        return U, S, X

    def fit(self, X, y=None):
        self._fit(X)
        return self

    def fit_transform(self, X, y=None) -> np.ndarray:
        """sklearn's: ``U * S`` of the ``full`` SVD (``U * sqrt(n - 1)``
        whitened), the projection for ``covariance_eigh``."""
        U, S, X = self._fit(X)
        if U is None:
            return self.transform(X)
        k = self.n_components_
        return U[:, :k] * (np.sqrt(X.shape[0] - 1) if self.whiten else S[:k])

    def _check(self):
        if self.components_ is None:
            raise RuntimeError("PCA is not fitted")

    def transform(self, X) -> np.ndarray:
        self._check()
        X = _float(X)
        out = X @ self.components_.T
        out -= np.reshape(self.mean_, (1, -1)) @ self.components_.T
        if self.whiten:
            scale = np.sqrt(self.explained_variance_)
            scale[scale < np.finfo(scale.dtype).eps] = np.finfo(scale.dtype).eps
            out /= scale
        return out

    def inverse_transform(self, X) -> np.ndarray:
        self._check()
        X = _float(X)
        if self.whiten:
            return X @ (np.sqrt(self.explained_variance_[:, np.newaxis]) * self.components_) + self.mean_
        return X @ self.components_ + self.mean_

    def get_feature_names_out(self, input_features: Sequence[str]) -> List[str]:
        self._check()
        return [f"pca{i}" for i in range(self.n_components_)]

    def fitted_state(self) -> Dict[str, np.ndarray]:
        self._check()
        return {a: np.asarray(getattr(self, a)) for a in self._ATTRS}

    def set_fitted_state(self, state: Dict[str, np.ndarray]):
        for a in self._ATTRS:
            setattr(self, a, state[a])
        self.n_components_ = int(self.n_components_)
        self.n_samples_ = int(self.n_samples_)
        self.noise_variance_ = state["noise_variance_"][()]
        return self

    def get_params(self, deep=True):
        return dict(getattr(self, "_params", {}))


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
