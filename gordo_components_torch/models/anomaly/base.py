"""Abstract anomaly-detector contract (counterpart of
``gordo_components_tpu/models/anomaly/base.py``)."""

import abc

from gordo_components_torch.models.base import GordoBase


class AnomalyDetectorBase(GordoBase, abc.ABC):
    @abc.abstractmethod
    def anomaly(self, X, y=None):
        """Score X: per-tag scaled and unscaled anomalies and the total
        anomaly next to the model's input and output, as served by
        ``POST /anomaly/prediction``."""
