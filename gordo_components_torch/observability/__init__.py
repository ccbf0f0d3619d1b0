"""Observability of the port: the metrics registry (``metrics.py``), request
tracing (``tracing.py``), the goodput ledger (``goodput.py``), SLO burn
rates (``slo.py``), per-bucket device cost (``cost.py``), access heat
(``heat.py``), metric history (``timeseries.py``) and the event log
(``events.py``).

Counterpart of ``gordo_components_tpu/observability/``. The watchman's
incident correlation lives in ``watchman/correlate.py``, as in the JAX
package, and its fleet rollups in ``watchman/server.py``.
"""

from gordo_components_torch.observability.metrics import (
    Histogram,
    MetricsRegistry,
    get_registry,
    parse_prometheus_text,
    render_samples,
)
from gordo_components_torch.observability.tracing import Tracer

__all__ = ["Histogram", "MetricsRegistry", "Tracer", "get_registry", "parse_prometheus_text", "render_samples"]
