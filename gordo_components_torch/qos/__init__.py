"""Multi-tenant QoS of the port: request classification (``classify.py``),
admission (``admission.py``) and the weighted-fair queue (``fair.py``).

Counterpart of ``gordo_components_tpu/qos/``; the tensor wire's
``__meta__`` sidecar is not ported yet.
"""

from gordo_components_torch.qos.admission import AdmissionController, QosShed, TokenBucket
from gordo_components_torch.qos.classify import RequestClass, classify_headers
from gordo_components_torch.qos.fair import DEFAULT_WEIGHTS, WeightedFairQueue, parse_weights

__all__ = [
    "AdmissionController", "DEFAULT_WEIGHTS", "QosShed", "RequestClass", "TokenBucket",
    "WeightedFairQueue", "classify_headers", "parse_weights",
]
