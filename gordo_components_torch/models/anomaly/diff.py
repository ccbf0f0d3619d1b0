"""Reconstruction-error anomaly detector.

Counterpart of ``DiffBasedAnomalyDetector`` in
``gordo_components_tpu/models/anomaly/diff.py``: a base estimator (usually
``Pipeline(scaler, AutoEncoder)``) whose ``fit`` also learns a per-feature
min-max scaling of the training reconstruction error ``|target - output|``
in model space, and thresholds at the ``threshold_quantile`` of the scaled
training errors (exact ``np.quantile``; ``threshold_method_ = "exact"``).

``anomaly(X)`` returns the reference's six column groups as arrays, with
the epilogue (diff, scaled diff, both row norms) in one
:func:`fused_anomaly_score_packed` call (the CUDA kernel on the card) whose
one buffer comes back to the host in one transfer. It scores through the
detector's bank entry (:meth:`to_entry`): the input affine composed from the
pipeline's scaler steps, the model's weights and the error scaler, which is
also what the serializer writes and the bank stacks.

Sequence models score windows of ``lookback`` rows: output row i belongs to
input row ``i + offset``, with ``offset = lookback - 1 + target_offset``
(``target_offset`` 1 for a t+1 forecast), so the outputs, the target and
``model-input`` are the rows from ``offset`` on, as in the reference.
"""

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from gordo_components_torch.device import resolve_device
from gordo_components_torch.models.anomaly.base import AnomalyDetectorBase
from gordo_components_torch.models.base import GordoBase, score_metrics_of, transform_through_steps
from gordo_components_torch.models.factories.lstm import LSTMStack
from gordo_components_torch.models.register import lookup_factory
from gordo_components_torch.ops.scaler import ScalerParams, fit_minmax, scaler_transform
from gordo_components_torch.ops.score import fused_anomaly_score_packed, unpack_scores
from gordo_components_torch.ops.windows import sliding_windows
from gordo_components_torch.utils import capture_args

ANOMALY_KEYS = (
    "model-input",
    "model-output",
    "tag-anomaly-unscaled",
    "tag-anomaly-scaled",
    "total-anomaly-unscaled",
    "total-anomaly-scaled",
)


def _as_f32(X) -> np.ndarray:
    # a frame's values may be read-only: copy them, as torch wants to own
    X = np.array(X.values, np.float32) if hasattr(X, "values") else np.asarray(X, np.float32)
    return X[:, None] if X.ndim == 1 else X


class _Scorer(NamedTuple):
    """A detector's scoring pieces on its device."""

    model: nn.Module
    input_scaler: ScalerParams
    error_scaler: ScalerParams
    lookback: int
    target_offset: int


class DiffBasedAnomalyDetector(AnomalyDetectorBase):
    """Anomaly = norm of (per-feature scaled) |y - reconstruction|."""

    @capture_args
    def __init__(
        self,
        base_estimator: Optional[GordoBase] = None,
        require_thresholds: bool = False,
        threshold_quantile: float = 1.0,
    ):
        if base_estimator is None:  # the reference's default model
            from gordo_components_torch.models.models import AutoEncoder

            base_estimator = AutoEncoder(kind="feedforward_hourglass")
        self.base_estimator = base_estimator
        self.require_thresholds = require_thresholds
        self.threshold_quantile = float(threshold_quantile)
        self.error_scaler_: Optional[ScalerParams] = None
        self.feature_thresholds_: Optional[np.ndarray] = None
        self.total_threshold_: Optional[float] = None
        self.threshold_method_: Optional[str] = None
        self.tags_: Optional[list] = None
        self._entry = None  # a loaded detector's bank entry (from_entry)
        self._device: Optional[torch.device] = None  # a loaded detector's device
        self._scorer: Optional[_Scorer] = None

    @classmethod
    def from_entry(cls, entry, device="cuda") -> "DiffBasedAnomalyDetector":
        """A detector that scores a bank entry (``server/bank._BankEntry``)
        on ``device``; it keeps no base estimator to refit."""
        det = cls()
        det._device = resolve_device(device)
        det.base_estimator = None
        det._entry = entry
        det.error_scaler_ = ScalerParams(entry.err_shift, entry.err_scale)
        det.tags_ = list(entry.tags)
        th = entry.thresholds or {}
        if "total-anomaly-threshold" in th:
            det.feature_thresholds_ = np.array(
                [th["feature-thresholds"][t] for t in det.tags_], np.float64
            )
            det.total_threshold_ = float(th["total-anomaly-threshold"])
            det.threshold_method_ = th.get("threshold-method", "exact")
        return det

    # ------------------------------------------------------------------ #

    @property
    def _final_estimator(self):
        est = self.base_estimator
        return est.steps[-1][1] if hasattr(est, "steps") else est

    @property
    def device(self) -> torch.device:
        if self._device is not None:
            return self._device
        return resolve_device(getattr(self._final_estimator, "device", "cuda"))

    @property
    def offset(self) -> int:
        """Rows consumed by the sequence warm-up: output row i belongs to
        input row ``i + offset`` (0 for feedforward)."""
        if self._entry is not None:
            return self._entry.offset
        est = self._final_estimator
        return getattr(est, "lookback_window", 1) - 1 + getattr(est, "_target_offset", 0)

    def _model_space(self, X: np.ndarray) -> np.ndarray:
        """Raw values through the pipeline's pre-model transformers, so the
        diff is computed where the model reconstructs."""
        est = self.base_estimator
        if hasattr(est, "steps"):
            X = transform_through_steps(est, X)
        return np.asarray(X, dtype=np.float32)

    def _predict_model_space(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(self._final_estimator.predict(self._model_space(X)), np.float32)

    # ------------------------------------------------------------------ #

    def fit(self, X, y=None, **kwargs):
        Xv = _as_f32(X)
        self.tags_ = (
            [str(c) for c in X.columns] if hasattr(X, "columns")
            else [f"feature-{i}" for i in range(Xv.shape[-1])]
        )
        self.base_estimator.fit(Xv, None if y is None else _as_f32(y))
        self._scorer = None

        # per-feature error scaling learned from the training residuals
        output = self._predict_model_space(Xv)
        target = self._model_space(Xv if y is None else _as_f32(y))
        target = target[self.offset:][: output.shape[0]]
        diff = torch.from_numpy(np.abs(target - output))
        es = fit_minmax(diff)
        self.error_scaler_ = ScalerParams(es.shift.numpy(), es.scale.numpy())

        # thresholds: quantile of the scaled training errors
        scaled = scaler_transform(es, diff).numpy()
        q = self.threshold_quantile
        self.feature_thresholds_ = np.quantile(scaled, q, axis=0)
        self.total_threshold_ = float(np.quantile(np.linalg.norm(scaled, axis=-1), q))
        self.threshold_method_ = "exact"
        return self

    def predict(self, X):
        return self.base_estimator.predict(X)

    def score(self, X, y=None) -> float:
        return self.base_estimator.score(X, y)

    def score_metrics(self, X, y=None):
        return score_metrics_of(self.base_estimator, X, y)

    def _check_fitted(self):
        if self.error_scaler_ is None:
            raise RuntimeError("DiffBasedAnomalyDetector has not been fitted")
        if self.require_thresholds and self.total_threshold_ is None:
            raise RuntimeError("Thresholds required but not computed")

    def _thresholds(self) -> Optional[Dict[str, Any]]:
        if self.feature_thresholds_ is None:
            return None
        return {
            "feature-thresholds": {
                t: float(v) for t, v in zip(self.tags_ or [], self.feature_thresholds_)
            },
            "total-anomaly-threshold": self.total_threshold_,
            "threshold-method": self.threshold_method_ or "exact",
        }

    def to_entry(self, name: Optional[str] = None):
        """The fitted detector as a bank entry (``server/bank._BankEntry``):
        its pipeline's affine scaler steps composed into one input affine,
        the final estimator's weights, the error scaler, tags and
        thresholds. Raises for a preprocessing step that is not affine."""
        from gordo_components_torch.server.bank import _BankEntry

        if self._entry is not None:
            return self._entry if name is None else dataclasses.replace(self._entry, name=name)
        self._check_fitted()
        est = self._final_estimator
        if getattr(est, "params_", None) is None:
            raise RuntimeError("the base estimator is unfitted")
        F = int(est.n_features_)
        # compose the chained affine scalers into one: t(x) = (x - sh) * sc;
        # appending ((t - s) * k) gives (x - (sh + s / sc)) * (sc * k)
        in_shift = np.zeros(F, np.float32)
        in_scale = np.ones(F, np.float32)
        for step_name, step in getattr(self.base_estimator, "steps", [])[:-1]:
            params = getattr(step, "scaler_params_", None)
            if params is None:
                raise ValueError(f"non-affine preprocessing step {step_name!r}")
            safe = np.where(in_scale == 0, np.float32(1.0), in_scale)
            in_shift = in_shift + np.asarray(params.shift, np.float32) / safe
            in_scale = in_scale * np.asarray(params.scale, np.float32)
        return _BankEntry(
            name=name or "model",
            registry_type=type(est).__name__,
            kind=est.kind,
            factory_kwargs=dict(est.factory_kwargs),
            n_features=F,
            params={k: np.asarray(v, np.float32) for k, v in est.params_.items()},
            in_shift=in_shift,
            in_scale=in_scale,
            err_shift=np.asarray(self.error_scaler_.shift, np.float32),
            err_scale=np.asarray(self.error_scaler_.scale, np.float32),
            tags=list(self.tags_ or [f"feature-{i}" for i in range(F)]),
            thresholds=self._thresholds(),
            lookback=int(getattr(est, "lookback_window", 1)),
            target_offset=int(getattr(est, "_target_offset", 0)),
        )

    def _scoring(self) -> _Scorer:
        if self._scorer is None:
            entry, device = self.to_entry(), self.device
            model = lookup_factory(entry.registry_type, entry.kind)(
                entry.n_features, **entry.factory_kwargs
            )
            model.load_state_dict({k: torch.as_tensor(v) for k, v in entry.params.items()})

            def vec(a):
                return torch.as_tensor(np.array(a, np.float32), device=device)

            self._scorer = _Scorer(
                model.to(device).eval(),
                ScalerParams(vec(entry.in_shift), vec(entry.in_scale)),
                ScalerParams(vec(entry.err_shift), vec(entry.err_scale)),
                entry.lookback, entry.target_offset,
            )
        return self._scorer

    @torch.no_grad()
    def anomaly(self, X, y=None) -> Dict[str, np.ndarray]:
        """The reference's anomaly columns as arrays keyed by group name:
        ``model-input`` and ``model-output`` (rows, F), the per-tag
        ``tag-anomaly-unscaled``/``-scaled`` (rows, F), and the
        ``total-anomaly-unscaled``/``-scaled`` row norms (rows,), for the
        ``len(X) - offset`` output rows."""
        self._check_fitted()
        s = self._scoring()
        device = s.input_scaler.shift.device
        Xv = _as_f32(X)
        off = s.lookback - 1 + s.target_offset
        if len(Xv) <= off:
            raise ValueError(f"need more than {off} rows (sequence warm-up), got {len(Xv)}")
        x = torch.as_tensor(Xv, device=device)
        yv = x if y is None else torch.as_tensor(_as_f32(y), device=device)
        xs = scaler_transform(s.input_scaler, x)
        if isinstance(s.model, LSTMStack):
            W = sliding_windows(xs, s.lookback)
            output = s.model(W[: len(W) - s.target_offset])
        else:
            output = s.model(xs)
        n_out = output.shape[0]
        target = scaler_transform(s.input_scaler, yv)[off:][:n_out]
        scores = fused_anomaly_score_packed(
            target.contiguous(), output.contiguous(), s.error_scaler.shift, s.error_scaler.scale,
        )
        # one device-to-host transfer per buffer, then one wait for both
        output, scores = (t.to("cpu", non_blocking=True) for t in (output, scores))
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        arrays = [t.numpy() for t in (output, *unpack_scores(scores, n_out, output.shape[1]))]
        return dict(zip(ANOMALY_KEYS, [Xv[off:][:n_out], *arrays]))

    def get_metadata(self) -> Dict[str, Any]:
        est = self.base_estimator
        md: Dict[str, Any] = {
            "type": type(self).__name__,
            "base_estimator": (
                est.get_metadata() if hasattr(est, "get_metadata") else repr(est)
            ),
        }
        if self.feature_thresholds_ is not None:
            md.update(self._thresholds())
        return md
