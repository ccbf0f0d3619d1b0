"""The per-model quarantine breaker of the serving path.

Counterpart of ``gordo_components_tpu/resilience/quarantine.py``.
:class:`QuarantineSet` counts each model's consecutive scoring failures
(exceptions, and non-finite scores for finite input); at ``threshold`` the
model leaves routing: its scoring POSTs answer 410 with the recorded
reason, ``/healthz`` says ``degraded`` and names it, and
``gordo_quarantined_models`` counts it. The breaker never moves a model to
another code path; it only stops routing to it. ``POST
.../quarantine/clear`` or a ``/reload`` that replaces the model clears it.

Threads: the port's server answers each request on its own thread, so
every method runs under the set's lock; three failures racing for one
model count three.
"""

import logging
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

DEFAULT_THRESHOLD = 3


class QuarantineSet:
    """Consecutive-failure breaker over model names; ``threshold <= 0``
    disables it (it records nothing and holds nothing)."""

    def __init__(self, threshold: int = DEFAULT_THRESHOLD):
        self.threshold = int(threshold)
        self._lock = threading.Lock()
        self._failures: Dict[str, int] = {}  # streaks below the threshold
        self._last_reason: Dict[str, str] = {}
        self._quarantined: Dict[str, Dict[str, Any]] = {}

    def record_failure(self, name: str, reason: str) -> bool:
        """Count one scoring failure; True when it newly quarantines the
        model."""
        with self._lock:
            if self.threshold <= 0 or name in self._quarantined:
                return False
            streak = self._failures.get(name, 0) + 1
            self._failures[name] = streak
            self._last_reason[name] = reason
            if streak < self.threshold:
                return False
            self._quarantined[name] = {"reason": reason, "failures": streak, "since": time.time()}
            self._failures.pop(name, None)
            self._last_reason.pop(name, None)
        logger.error("Model %r QUARANTINED after %d consecutive scoring failures (last: %s); "
                     "its scoring POSTs answer 410 until cleared", name, streak, reason)
        return True

    def record_success(self, name: str) -> None:
        """A good score resets the streak below the threshold."""
        with self._lock:
            self._failures.pop(name, None)
            self._last_reason.pop(name, None)

    def __contains__(self, name: str) -> bool:
        return name in self._quarantined

    def __len__(self) -> int:
        return len(self._quarantined)

    def reason(self, name: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            info = self._quarantined.get(name)
            return None if info is None else dict(info)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._quarantined)

    def snapshot(self) -> Dict[str, Any]:
        """The operator's view, for ``/stats`` and ``GET .../quarantine``."""
        with self._lock:
            return {
                "threshold": self.threshold,
                "quarantined": {name: dict(info) for name, info in sorted(self._quarantined.items())},
                "failing": {name: {"failures": n, "last_reason": self._last_reason.get(name, "")}
                            for name, n in sorted(self._failures.items())},
            }

    def clear(self, names: Optional[List[str]] = None) -> List[str]:
        """Clear the named models (every one when ``names`` is None); the
        names actually cleared. Their streaks restart from zero."""
        with self._lock:
            targets = sorted(self._quarantined) if names is None else names
            cleared = []
            for name in targets:
                if self._quarantined.pop(name, None) is not None:
                    cleared.append(name)
                self._failures.pop(name, None)
                self._last_reason.pop(name, None)
        if cleared:
            logger.warning("Quarantine cleared for: %s", ", ".join(cleared))
        return cleared

    def drop(self, name: str) -> None:
        """Forget everything about a removed or replaced model."""
        with self._lock:
            self._quarantined.pop(name, None)
            self._failures.pop(name, None)
            self._last_reason.pop(name, None)
