"""Multi-tenant QoS of the port: request classification (``classify.py``).

Counterpart of ``gordo_components_tpu/qos/``; admission and the
weighted-fair queue are not ported yet.
"""

from gordo_components_torch.qos.classify import RequestClass, classify_headers

__all__ = ["RequestClass", "classify_headers"]
