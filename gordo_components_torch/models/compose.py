"""The port's stand-ins for ``sklearn.pipeline.FeatureUnion`` and
``sklearn.compose.TransformedTargetRegressor``.

``serializer/definitions.py`` resolves both sklearn paths (public and
private) to the classes here; the port imports no sklearn.

- :class:`FeatureUnion` fits each of its transformers on the same input
  and stacks their outputs side by side, in order, each times its
  ``transformer_weights`` entry; ``"drop"`` leaves a transformer out
  (``"passthrough"`` raises ``NotImplementedError``). It is not affine, so a detector over
  it scores in model space on the per-model path. ``n_jobs`` is accepted
  and ignored: the transformers run one after another.
- :class:`TransformedTargetRegressor` fits its ``transformer`` on ``y``
  (taken 2-D), its ``regressor`` on the transformed ``y``, and predicts
  ``transformer.inverse_transform(regressor.predict(X))``. Without a
  transformer ``y`` passes as it is (sklearn's identity
  ``FunctionTransformer``). ``func`` and ``inverse_func`` raise
  ``NotImplementedError``, and so does ``regressor=None`` (sklearn's
  ``LinearRegression``). It fits the objects it was given, where sklearn
  fits clones of them; ``regressor_`` and ``transformer_`` name them.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gordo_components_torch.ops.losses import regression_metrics
from gordo_components_torch.utils import capture_args

class FeatureUnion:
    """Outputs of ``transformer_list`` (``(name, transformer)`` pairs)
    side by side."""

    @capture_args
    def __init__(self, transformer_list, n_jobs=None, transformer_weights: Optional[Dict[str, float]] = None,
                 verbose=False, verbose_feature_names_out=True):
        self.transformer_list = [tuple(t) for t in transformer_list]
        for name, t in self.transformer_list:
            if isinstance(t, str) and t != "drop":
                raise NotImplementedError(f"FeatureUnion transformer {name!r}: {t!r} (the port takes 'drop')")
        self.transformer_weights = dict(transformer_weights or {})
        self.verbose_feature_names_out = bool(verbose_feature_names_out)

    def _kept(self):
        return [(name, t) for name, t in self.transformer_list if not (t is None or isinstance(t, str))]

    def _stack(self, outputs) -> np.ndarray:
        if not outputs:
            raise ValueError("FeatureUnion: every transformer is 'drop'")
        return np.hstack(outputs)

    def _weighted(self, name, out):
        weight = self.transformer_weights.get(name)
        return out if weight is None else out * weight

    def fit(self, X, y=None):
        self.fit_transform(X, y)
        return self

    def fit_transform(self, X, y=None) -> np.ndarray:
        return self._stack([self._weighted(name, t.fit_transform(X)) for name, t in self._kept()])

    def transform(self, X) -> np.ndarray:
        return self._stack([self._weighted(name, t.transform(X)) for name, t in self._kept()])

    def get_feature_names_out(self, input_features: Sequence[str]) -> List[str]:
        return [f"{name}__{n}" if self.verbose_feature_names_out else n
                for name, t in self._kept() for n in t.get_feature_names_out(input_features)]

    def get_params(self, deep=True):
        return dict(getattr(self, "_params", {}))


class TransformedTargetRegressor:
    """A regressor fitted on a transformed target, its predictions mapped
    back through the transformer's inverse."""

    @capture_args
    def __init__(self, regressor=None, transformer=None, func=None, inverse_func=None, check_inverse=True):
        for arg, value in (("func", func), ("inverse_func", inverse_func)):
            if value is not None:
                raise NotImplementedError(f"TransformedTargetRegressor({arg}=...): the port takes a transformer "
                                          "object only")
        if regressor is None:
            raise NotImplementedError("TransformedTargetRegressor(regressor=None): sklearn's LinearRegression "
                                      "is not ported")
        self.regressor = regressor
        self.transformer = transformer
        self.check_inverse = bool(check_inverse)
        self._training_dim: Optional[int] = None

    @property
    def regressor_(self):
        return self.regressor

    @property
    def transformer_(self):
        return self.transformer

    def fit(self, X, y=None, **kwargs):
        if y is None:
            raise ValueError("This TransformedTargetRegressor estimator requires y to be passed, but the target "
                             "y is None.")
        y = np.asarray(y.values if hasattr(y, "values") else y)
        self._training_dim = y.ndim
        y2 = y.reshape(-1, 1) if y.ndim == 1 else y
        if self.transformer is not None:
            y2 = self.transformer.fit_transform(y2)
        if y2.ndim == 2 and y2.shape[1] == 1 and self._training_dim == 1:
            y2 = y2[:, 0]
        self.regressor.fit(X, y2, **kwargs)
        return self

    def predict(self, X) -> np.ndarray:
        pred = self.regressor.predict(X)
        if self.transformer is None:
            return pred
        out = self.transformer.inverse_transform(pred.reshape(-1, 1) if pred.ndim == 1 else pred)
        if self._training_dim == 1 and out.ndim == 2 and out.shape[1] == 1:
            out = out[:, 0]
        return out

    def score(self, X, y=None) -> float:
        """r2 of the predictions against ``y`` (sklearn's regressor
        ``score``)."""
        if y is None:
            raise ValueError("TransformedTargetRegressor.score needs y")
        y = np.asarray(y.values if hasattr(y, "values") else y, np.float64)
        pred = np.asarray(self.predict(X), np.float64)
        as_2d = (lambda a: a.reshape(-1, 1) if a.ndim == 1 else a)
        return regression_metrics(torch.from_numpy(as_2d(y)), torch.from_numpy(as_2d(pred)))["r2-score"]

    def get_metadata(self):
        """Nothing, as the JAX builder records for sklearn's class, which has
        no metadata (``build_model._pipeline_metadata``)."""
        return {}

    def get_params(self, deep=True):
        return dict(getattr(self, "_params", {}))
