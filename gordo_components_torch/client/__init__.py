"""The port's bulk-prediction client (counterpart of
``gordo_components_tpu/client/``), on the standard library and numpy.
``PushSubscriber`` waits for the server's ``/results/stream`` (ROADMAP
A8)."""

from gordo_components_torch.client.client import Client, PredictionResult
from gordo_components_torch.client.forwarders import (
    ForwardPredictionsIntoInflux,
    ForwardPredictionsIntoParquet,
)

__all__ = [
    "Client",
    "PredictionResult",
    "ForwardPredictionsIntoInflux",
    "ForwardPredictionsIntoParquet",
]
