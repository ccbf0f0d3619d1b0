"""Abstract estimator contract.

Counterpart of ``gordo_components_tpu/models/base.py``: the surface every
model exposes so the builder, serializer and server treat all models
alike: ``fit``, ``get_metadata()``, ``score()``, ``get_params()``.
"""

import abc
from typing import Any, Dict, Optional

import numpy as np


class GordoBase(abc.ABC):
    """Base contract for all models of the port."""

    @abc.abstractmethod
    def fit(self, X: np.ndarray, y: Optional[np.ndarray] = None, **kwargs):
        """Fit the model to X (y defaults per estimator semantics)."""

    @abc.abstractmethod
    def get_metadata(self) -> Dict[str, Any]:
        """JSON-serializable metadata describing configuration and training
        history; written into the build artifact's ``metadata.json``."""

    @abc.abstractmethod
    def score(self, X: np.ndarray, y: Optional[np.ndarray] = None) -> float:
        """Explained-variance score of the model on (X, y)."""

    def get_params(self, deep=True) -> Dict[str, Any]:
        """Constructor params captured by ``capture_args`` (sklearn-style)."""
        return dict(getattr(self, "_params", {}))

    def set_params(self, **params):
        self._params = {**getattr(self, "_params", {}), **params}
        for k, v in params.items():
            setattr(self, k, v)
        return self


def transform_through_steps(est, X):
    """Apply all but the final step of a Pipeline-like object (y never
    transforms, matching ``Pipeline.score``)."""
    for _, step in est.steps[:-1]:
        X = step.transform(X)
    return X


def score_metrics_of(est, X, y=None) -> dict:
    """The reference's full evaluation metric set from any estimator:
    ``score_metrics`` where the estimator (or a Pipeline's final step) has
    it, else ``score()``'s explained variance alone."""
    if hasattr(est, "score_metrics"):
        return est.score_metrics(X, y)
    if hasattr(est, "steps"):
        final = est.steps[-1][1]
        if hasattr(final, "score_metrics"):
            return final.score_metrics(transform_through_steps(est, X), y)
    return {"explained-variance": float(est.score(X, y))}
