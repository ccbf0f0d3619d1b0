"""Resilience of the port: fault points (``faults.py``: named sites armed
from code or ``GORDO_FAULTS``), per-request deadlines (``deadline.py``), the
per-model quarantine breaker (``quarantine.py``) and the client's retry
budget and backoff (``retry_budget.py``).

Counterpart of the four modules of ``gordo_components_tpu/resilience/``.
"""

from gordo_components_torch.resilience.deadline import (
    DEADLINE_HEADER,
    MAX_DEADLINE_MS,
    Deadline,
    DeadlineExceeded,
    default_deadline_ms,
    parse_deadline_ms,
)
from gordo_components_torch.resilience.faults import (
    FaultInjected,
    FaultSpec,
    arm,
    configure_from_env,
    disarm,
    fault_stats,
    faultpoint,
    registered_sites,
    reset,
    set_fire_listener,
)
from gordo_components_torch.resilience.quarantine import DEFAULT_THRESHOLD, QuarantineSet
from gordo_components_torch.resilience.retry_budget import RetryBudget, decorrelated_jitter

__all__ = [
    "DEADLINE_HEADER", "DEFAULT_THRESHOLD", "MAX_DEADLINE_MS", "Deadline", "DeadlineExceeded",
    "FaultInjected", "FaultSpec", "QuarantineSet", "RetryBudget", "arm", "configure_from_env",
    "decorrelated_jitter", "default_deadline_ms", "disarm", "fault_stats", "faultpoint",
    "parse_deadline_ms", "registered_sites", "reset", "set_fire_listener",
]
