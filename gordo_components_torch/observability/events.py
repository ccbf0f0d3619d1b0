"""Structured event timeline: the flight recorder's "what happened" axis.

Counterpart of ``gordo_components_tpu/observability/events.py``. The
history store (``timeseries.py``) keeps continuous signals; this log keeps
the server's discrete state changes: bank swaps and failed swaps,
``/reload``, quarantine enter and clear. Each event is stamped with the
clock seam's wall and monotonic time, the bank generation, the replica
and the current trace's id when there is one.

Always on: changes are rare, so one append under a lock is noise, and the
scoring path never emits. The ring is bounded (``GORDO_EVENTS_CAPACITY``,
512) and drops the oldest first, counting what it dropped. ``emit`` never
raises: losing an event must not break the change that emitted it.
"""

import os
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

from gordo_components_torch.replay.clock import SYSTEM_CLOCK, Clock

__all__ = ["Event", "EventLog", "get_event_log", "set_event_log"]

DEFAULT_CAPACITY = 512

SEVERITIES = ("info", "warning", "error")


@dataclass(frozen=True)
class Event:
    seq: int
    type: str
    severity: str
    wall: float  # the clock seam's time
    mono: float  # the clock seam's monotonic time
    generation: Optional[int] = None
    replica: Optional[str] = None
    trace_id: Optional[str] = None
    attrs: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "seq": self.seq,
            "type": self.type,
            "severity": self.severity,
            "wall": self.wall,
            "mono": self.mono,
            "generation": self.generation,
            "replica": self.replica,
            "trace_id": self.trace_id,
            "attrs": self.attrs,
        }


class EventLog:
    """A bounded, thread-safe ring of typed events."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, clock: Clock = SYSTEM_CLOCK,
                 replica: Optional[str] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.clock = clock
        self.replica = replica
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.emitted = 0
        self._by_type: Dict[str, int] = {}

    def emit(self, etype: str, severity: str = "info", generation: Optional[int] = None,
             trace_id: Optional[str] = None, replica: Optional[str] = None, **attrs: Any) -> Optional[Event]:
        """Append an event (an unknown severity is ``info``); None if it
        could not be recorded."""
        try:
            if severity not in SEVERITIES:
                severity = "info"
            if trace_id is None:
                from gordo_components_torch.observability.tracing import current_trace

                trace = current_trace()
                trace_id = trace.trace_id if trace is not None else None
            wall = self.clock.time()
            mono = self.clock.monotonic()
            with self._lock:
                self._seq += 1
                ev = Event(seq=self._seq, type=str(etype), severity=severity, wall=wall, mono=mono,
                           generation=generation, replica=replica if replica is not None else self.replica,
                           trace_id=trace_id, attrs=dict(attrs))
                self._ring.append(ev)
                self.emitted += 1
                self._by_type[ev.type] = self._by_type.get(ev.type, 0) + 1
            return ev
        except Exception:
            return None

    def events(self, since_seq: int = 0, types: Optional[Iterable[str]] = None,
               since_wall: Optional[float] = None, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Event dicts, oldest first, after ``since_seq`` and at or after
        ``since_wall``, of ``types`` when given; ``limit`` keeps the newest
        (0 keeps all, as in the JAX log)."""
        typeset = None if types is None else {str(t) for t in types}
        with self._lock:
            out = [ev.to_dict() for ev in self._ring
                   if ev.seq > since_seq and (since_wall is None or ev.wall >= since_wall)
                   and (typeset is None or ev.type in typeset)]
        if limit is not None and limit >= 0:
            out = out[-limit:]  # as JAX: 0 keeps every event
        return out

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "capacity": self.capacity,
                "retained": len(self._ring),
                "emitted": self.emitted,
                "dropped": self.emitted - len(self._ring),
                "last_seq": self._seq,
                "replica": self.replica,
                "by_type": dict(self._by_type),
            }

    def attach_registry(self, registry) -> None:
        """``gordo_events_total{type}`` through ``registry``."""

        def collect():
            with self._lock:
                counts = dict(self._by_type)
            for etype, n in sorted(counts.items()):
                yield ("gordo_events_total", "counter", "Structured events emitted by type", {"type": etype},
                       float(n))

        registry.collector(collect, key="events")


def _capacity_from_env() -> int:
    raw = os.environ.get("GORDO_EVENTS_CAPACITY")
    if not raw:
        return DEFAULT_CAPACITY
    return max(1, int(raw))


# the process default, for emitters without an app; a server keeps its own
_DEFAULT: Optional[EventLog] = None
_DEFAULT_LOCK = threading.Lock()


def get_event_log() -> EventLog:
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = EventLog(capacity=_capacity_from_env())
        return _DEFAULT


def set_event_log(log: Optional[EventLog]) -> Optional[EventLog]:
    """Replace the process default; returns the previous one."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        prev = _DEFAULT
        _DEFAULT = log
        return prev
