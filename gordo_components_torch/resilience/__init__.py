"""Serving resilience of the port: per-request deadlines (``deadline.py``)
and the per-model quarantine breaker (``quarantine.py``).

Counterpart of those two modules of ``gordo_components_tpu/resilience/``;
fault points, retries and the watchdog are not ported yet.
"""

from gordo_components_torch.resilience.deadline import (
    DEADLINE_HEADER,
    MAX_DEADLINE_MS,
    Deadline,
    DeadlineExceeded,
    default_deadline_ms,
    parse_deadline_ms,
)
from gordo_components_torch.resilience.quarantine import DEFAULT_THRESHOLD, QuarantineSet

__all__ = [
    "DEADLINE_HEADER", "DEFAULT_THRESHOLD", "MAX_DEADLINE_MS", "Deadline", "DeadlineExceeded",
    "QuarantineSet", "default_deadline_ms", "parse_deadline_ms",
]
