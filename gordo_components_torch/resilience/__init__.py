"""Resilience of the port: per-request deadlines (``deadline.py``), the
per-model quarantine breaker (``quarantine.py``) and the client's retry
budget and backoff (``retry_budget.py``).

Counterpart of those three modules of ``gordo_components_tpu/resilience/``;
fault points and the watchdog are not ported yet.
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
from gordo_components_torch.resilience.retry_budget import RetryBudget, decorrelated_jitter

__all__ = [
    "DEADLINE_HEADER", "DEFAULT_THRESHOLD", "MAX_DEADLINE_MS", "Deadline", "DeadlineExceeded",
    "QuarantineSet", "RetryBudget", "decorrelated_jitter", "default_deadline_ms", "parse_deadline_ms",
]
