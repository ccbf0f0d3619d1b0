"""Score-on-ingest push mode: results flow to subscribers, not pollers.

Counterpart of ``gordo_components_tpu/streaming/push.py``; the port's
long polls wait on their own handler threads (one a connection).

Request/response scoring makes every consumer of a member's anomaly
state re-pay the whole wire + dispatch cost per poll — at fleet scale,
polling MULTIPLIES work the streaming plane has already done. The push
plane inverts it: the ingest path (streaming/ingest.py) already holds
every member's fresh window, so each window is scored ONCE as its
watermark advances (batched through the same engine the request path
uses, OFF the request path) and the result fans out to however many
subscribers care.

Backpressure rules:

- per-subscriber queues are BOUNDED (``GORDO_PUSH_QUEUE``); a slow
  consumer drops its own OLDEST results (``gordo_push_dropped_total``
  counts them, and each long-poll response reports the subscriber's
  drop count) — fresh anomaly state beats complete stale history, and
  one wedged consumer can never grow server memory or slow the others;
- the subscriber table is bounded too (``GORDO_PUSH_SUBSCRIBERS_MAX``;
  the long-poll answers 429 past it) and subscribers idle beyond
  ``GORDO_PUSH_SUB_TTL_S`` are reaped;
- publishing never blocks the scoring loop: it is a lock-guarded deque
  append, O(subscribers) per window.

Default OFF (``GORDO_PUSH=0``): no broker exists, no ``gordo_push_*``
series render, and the ingest path pays one attribute check.
"""

import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["PushBroker"]


class PushBroker:
    """Bounded per-subscriber result queues with drop-oldest semantics.

    Thread-safe by a single condition variable: the streaming plane's
    push thread publishes, long-poll handlers wait on their own handler
    threads, and the reaper runs inside publish and subscribe.
    """

    def __init__(
        self,
        queue_max: int = 64,
        max_subscribers: int = 16,
        sub_ttl_s: float = 120.0,
        clock=None,
    ):
        from gordo_components_torch.replay.clock import SYSTEM_CLOCK

        self.queue_max = max(1, int(queue_max))
        self.max_subscribers = max(1, int(max_subscribers))
        self.sub_ttl_s = float(sub_ttl_s)
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        self._cond = threading.Condition()
        self._closed = False
        # (subscriber, target) -> {"queue": deque, "dropped": int,
        #                          "last_poll": float}
        self._subs: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.published_total = 0
        self.dropped_total = 0

    # ------------------------------------------------------------------ #

    def _reap_expired(self, now: float) -> None:
        """Drop subscribers idle past the TTL (called under the lock).
        Runs on BOTH publish and subscribe: a quiet stream publishes
        nothing, and without the subscribe-side sweep a burst of
        one-shot pollers would fill the table and 429 forever."""
        for key, st in list(self._subs.items()):
            if now - st["last_poll"] > self.sub_ttl_s:
                del self._subs[key]

    def subscribe(self, subscriber: str, target: str) -> bool:
        """Ensure the (subscriber, target) queue exists. False when the
        subscriber table is full (the long-poll answers 429)."""
        key = (subscriber, target)
        with self._cond:
            if key in self._subs:
                return True
            if len(self._subs) >= self.max_subscribers:
                self._reap_expired(self.clock.monotonic())
            if len(self._subs) >= self.max_subscribers:
                return False
            self._subs[key] = {
                "queue": deque(),
                "dropped": 0,
                "last_poll": self.clock.monotonic(),
            }
            return True

    def unsubscribe(self, subscriber: str, target: str) -> None:
        with self._cond:
            self._subs.pop((subscriber, target), None)

    def publish(self, target: str, result: Dict[str, Any]) -> int:
        """Fan one scored window out to every subscriber of ``target``
        (or the ``*`` wildcard). Returns how many queues received it."""
        delivered = 0
        now = self.clock.monotonic()
        with self._cond:
            # a consumer that stopped polling must not hold a queue
            # (and its table slot) forever
            self._reap_expired(now)
            for (sub, t), st in list(self._subs.items()):
                if t != target and t != "*":
                    continue
                q = st["queue"]
                if len(q) >= self.queue_max:
                    q.popleft()
                    st["dropped"] += 1
                    self.dropped_total += 1
                q.append(result)
                delivered += 1
            if delivered:
                self.published_total += 1
                self._cond.notify_all()
        return delivered

    def poll(
        self, subscriber: str, target: str, timeout: float
    ) -> Tuple[List[Dict[str, Any]], int]:
        """Drain the subscriber's queue, waiting up to ``timeout`` for
        the first result (the long-poll body). Returns ``(results,
        dropped_so_far)``. Runs on the long poll's handler thread."""
        key = (subscriber, target)
        deadline = self.clock.monotonic() + max(0.0, timeout)
        with self._cond:
            st = self._subs.get(key)
            if st is None:
                return [], 0
            st["last_poll"] = self.clock.monotonic()
            while not st["queue"] and not self._closed:
                remaining = deadline - self.clock.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
                if self._subs.get(key) is not st:
                    return [], st["dropped"]  # reaped mid-wait
            out = list(st["queue"])
            st["queue"].clear()
            st["last_poll"] = self.clock.monotonic()
            return out, st["dropped"]

    # ------------------------------------------------------------------ #

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            return {
                "subscribers": len(self._subs),
                "published_total": self.published_total,
                "dropped_total": self.dropped_total,
                "queue_max": self.queue_max,
                "max_subscribers": self.max_subscribers,
            }

    def close(self) -> None:
        """Shutdown: release every parked poller NOW. A bare notify
        would not do it — an awakened waiter with an empty queue and
        time left re-parks, and would hold its connection open for up to
        the longest poll timeout."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
