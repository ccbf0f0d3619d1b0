"""Weighted-fair queueing for the batching engine.

Counterpart of ``gordo_components_tpu/qos/fair.py``, on threads: the JAX
queue wakes an asyncio consumer, the port's engine is a thread, so this
queue is a ``threading.Condition`` over per-class heaps with the surface
the engine used of ``queue.Queue`` (``put_nowait``, ``get(timeout=...)``,
``get_nowait``, ``qsize``, ``empty``), raising ``queue.Full`` and
``queue.Empty`` as that did. The order is the JAX order:

- each class ``c`` keeps a virtual clock ``vtime[c]``; popping one of its
  requests advances it by ``1 / weight[c]``;
- a pop serves the nonempty class with the smallest virtual clock (class
  order breaks ties), so over a busy interval class ``c`` gets
  ``weight[c] / sum(weights of the backlogged classes)`` of the dequeues:
  a best-effort flood delays interactive traffic by at most that share;
- a class waking from idle first catches its clock up to the lowest
  backlogged clock, so idleness banks no credit for a burst;
- inside a class, requests pop by deadline (earliest ``expires_at``
  first, those without one after), a FIFO sequence breaking ties.

With every request in one class (no QoS configuration) the order is FIFO.
``maxsize`` bounds the queue, tested under the queue's own lock, so
concurrent puts cannot overfill it.
"""

import heapq
import os
import queue
import threading
from typing import Any, Dict, Mapping, Optional

from gordo_components_torch.qos.classify import CLASSES, DEFAULT_CLASS

__all__ = ["DEFAULT_WEIGHTS", "WeightedFairQueue", "parse_weights"]

#: interactive gets 8 dequeues for every 1 of a best-effort backlog while
#: both are backlogged
DEFAULT_WEIGHTS: Dict[str, float] = {
    "interactive": 8.0,
    "batch": 2.0,
    "best_effort": 1.0,
}

_ENV_WEIGHTS = "GORDO_QOS_WEIGHTS"


def parse_weights(spec: Optional[str] = None) -> Dict[str, float]:
    """Class weights from ``GORDO_QOS_WEIGHTS``
    (``"interactive=8,batch=2,best_effort=1"``). Unknown classes and
    non-positive or malformed weights are ignored and missing classes keep
    their defaults: a malformed knob degrades to the default policy."""
    weights = dict(DEFAULT_WEIGHTS)
    if spec is None:
        spec = os.environ.get(_ENV_WEIGHTS, "")
    for part in spec.split(","):
        if "=" not in part:
            continue
        name, _, raw = part.partition("=")
        name = name.strip().lower().replace("-", "_")
        if name not in weights:
            continue
        try:
            value = float(raw)
        except ValueError:
            continue
        if value > 0:
            weights[name] = value
    return weights


class WeightedFairQueue:
    """A thread-safe queue that dequeues across priority classes by
    weighted virtual time and inside a class by deadline. An item's class
    is its ``qos_class`` (unknown: the default class), its deadline its
    ``deadline.expires_at``."""

    def __init__(self, weights: Optional[Mapping[str, float]] = None, maxsize: int = 0):
        merged = dict(DEFAULT_WEIGHTS)
        if weights:
            for name, value in weights.items():
                if name in merged and value > 0:
                    merged[name] = float(value)
        self.weights = merged
        self.maxsize = int(maxsize)
        self._cond = threading.Condition(threading.Lock())
        self._heaps: Dict[str, list] = {c: [] for c in CLASSES}
        self._vtime: Dict[str, float] = {c: 0.0 for c in CLASSES}
        self._size = 0
        self._seq = 0  # the FIFO tie-break among equal deadlines
        # dequeues a class since construction: the fairness evidence /qos reads
        self.dequeued: Dict[str, int] = {c: 0 for c in CLASSES}

    def qsize(self) -> int:
        with self._cond:
            return self._size

    def empty(self) -> bool:
        return self.qsize() == 0

    def put_nowait(self, item: Any) -> None:
        """Queue ``item``; ``queue.Full`` when ``maxsize`` items wait."""
        cls = getattr(item, "qos_class", None)
        if cls not in self._heaps:
            cls = DEFAULT_CLASS
        deadline = getattr(item, "deadline", None)
        expires = getattr(deadline, "expires_at", None) if deadline is not None else None
        if expires is None:
            expires = float("inf")
        with self._cond:
            if self.maxsize > 0 and self._size >= self.maxsize:
                raise queue.Full
            heap = self._heaps[cls]
            if not heap:
                # idle -> backlogged: the idle time banks no credit
                backlogged = [self._vtime[c] for c, h in self._heaps.items() if h]
                if backlogged:
                    self._vtime[cls] = max(self._vtime[cls], min(backlogged))
            self._seq += 1
            heapq.heappush(heap, (expires, self._seq, item))
            self._size += 1
            self._cond.notify()

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        """The next item by class and deadline, waiting up to ``timeout``
        seconds (None: until one comes); ``queue.Empty`` when none does."""
        with self._cond:
            if not block:
                if not self._size:
                    raise queue.Empty
            elif not self._cond.wait_for(lambda: self._size > 0, timeout):
                raise queue.Empty
            return self._pop()

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def _pop(self) -> Any:
        """The lock held and an item queued: serve the backlogged class of
        the least virtual time."""
        best = None
        for cls in CLASSES:
            if self._heaps[cls] and (best is None or self._vtime[cls] < self._vtime[best]):
                best = cls
        self._vtime[best] += 1.0 / self.weights[best]
        self.dequeued[best] += 1
        self._size -= 1
        return heapq.heappop(self._heaps[best])[2]

    def depths(self) -> Dict[str, int]:
        """The live backlog a class."""
        with self._cond:
            return {c: len(h) for c, h in self._heaps.items()}

    def snapshot(self) -> dict:
        """Weights, and a class's depth, virtual clock and dequeues (/qos)."""
        with self._cond:
            return {
                "weights": dict(self.weights),
                "depth": {c: len(h) for c, h in self._heaps.items()},
                "vtime": {c: round(v, 6) for c, v in self._vtime.items()},
                "dequeued": dict(self.dequeued),
            }
