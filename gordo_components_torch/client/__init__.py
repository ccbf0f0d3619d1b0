"""The port's bulk-prediction client (counterpart of
``gordo_components_tpu/client/``), on the standard library and numpy;
``PushSubscriber`` (``subscribe.py``) consumes the server's push stream."""

from gordo_components_torch.client.client import Client, PredictionResult
from gordo_components_torch.client.subscribe import PushSubscriber
from gordo_components_torch.client.forwarders import (
    ForwardPredictionsIntoInflux,
    ForwardPredictionsIntoParquet,
)

__all__ = [
    "Client",
    "PredictionResult",
    "PushSubscriber",
    "ForwardPredictionsIntoInflux",
    "ForwardPredictionsIntoParquet",
]
