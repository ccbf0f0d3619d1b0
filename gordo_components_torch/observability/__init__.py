"""Observability of the port: the metrics registry (``metrics.py``).

Counterpart of ``gordo_components_tpu/observability/``; tracing, goodput,
SLOs, heat, costs, events and history are not ported yet.
"""

from gordo_components_torch.observability.metrics import (
    Histogram,
    MetricsRegistry,
    get_registry,
    parse_prometheus_text,
    render_samples,
)

__all__ = ["Histogram", "MetricsRegistry", "get_registry", "parse_prometheus_text", "render_samples"]
