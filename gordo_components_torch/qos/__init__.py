"""Multi-tenant QoS of the port: request classification (``classify.py``),
admission (``admission.py``) and the weighted-fair queue (``fair.py``).

Counterpart of ``gordo_components_tpu/qos/``.
"""

from gordo_components_torch.qos.admission import AdmissionController, QosShed, TokenBucket
from gordo_components_torch.qos.classify import RequestClass, classify_headers, classify_meta
from gordo_components_torch.qos.fair import DEFAULT_WEIGHTS, WeightedFairQueue, parse_weights

__all__ = [
    "AdmissionController", "DEFAULT_WEIGHTS", "QosShed", "RequestClass", "TokenBucket",
    "WeightedFairQueue", "classify_headers", "classify_meta", "parse_weights",
]
