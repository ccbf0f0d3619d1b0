"""Model factories, estimators and detectors of the port.

Importing this package registers the feedforward factories under the
``"AutoEncoder"`` registry type and the LSTM factories under
``"LSTMAutoEncoder"`` and ``"LSTMForecast"``.
"""

from gordo_components_torch.models import factories  # noqa: F401  (registers factories)
from gordo_components_torch.models.anomaly.diff import DiffBasedAnomalyDetector
from gordo_components_torch.models.models import (
    AutoEncoder,
    BaseEstimator,
    ConvAutoEncoder,
    LSTMAutoEncoder,
    LSTMForecast,
)
from gordo_components_torch.models.register import lookup_factory, register_model_builder

__all__ = [
    "AutoEncoder",
    "BaseEstimator",
    "ConvAutoEncoder",
    "DiffBasedAnomalyDetector",
    "LSTMAutoEncoder",
    "LSTMForecast",
    "lookup_factory",
    "register_model_builder",
]
