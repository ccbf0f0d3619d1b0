"""Push-mode subscriber: the client half of ``GET .../results/stream``.

Counterpart of ``gordo_components_tpu/client/subscribe.py``, over the
port's :class:`~gordo_components_torch.client.http.Session`. The server
(score-on-ingest push, ``GORDO_PUSH=1``) parks each long poll and answers
with every window scored since the subscriber's last poll. This loop
polls, delivers and reconnects. When a replica restarts, every
subscriber's poll fails at once; reconnects here sleep a
decorrelated-jitter delay (``resilience/retry_budget.decorrelated_jitter``,
the schedule the scoring retries use), so a herd of subscribers spreads
out after one failed poll each.
"""

import asyncio
import logging
import random
from typing import Any, Callable, Dict, List, Optional

from gordo_components_torch.resilience.retry_budget import decorrelated_jitter

logger = logging.getLogger(__name__)

__all__ = ["PushSubscriber"]


class PushSubscriber:
    """Long-poll consumer of one target's scored-window stream.

    ``base_url`` is the replica's base URL; ``rng`` seeds the jitter
    schedule (each subscriber its own: a shared one defeats the
    decorrelation)."""

    def __init__(
        self,
        base_url: str,
        project: str,
        target: str,
        *,
        subscriber: Optional[str] = None,
        poll_timeout_s: float = 10.0,
        reconnect_base_s: float = 0.05,
        reconnect_cap_s: float = 5.0,
        rng: Optional[random.Random] = None,
    ):
        self.base_url = (base_url or "").rstrip("/")
        self.project = project
        self.target = target
        self.subscriber = subscriber
        self.poll_timeout_s = float(poll_timeout_s)
        self.reconnect_base_s = float(reconnect_base_s)
        self.reconnect_cap_s = float(reconnect_cap_s)
        self._rng = rng
        self._prev_delay = self.reconnect_base_s
        self.results: List[Any] = []
        self.stats: Dict[str, int] = {"polls": 0, "failures": 0, "reconnects": 0, "dropped": 0}
        # every jittered reconnect delay, in order
        self.reconnect_delays: List[float] = []
        self.last_status: Optional[int] = None

    @property
    def url(self) -> str:
        return f"{self.base_url}/gordo/v0/{self.project}/{self.target}/results/stream"

    async def poll_once(self, session) -> List[Any]:
        """One long-poll round trip: the (possibly empty) batch of scored
        windows; raises on a transport failure or an answer other than 200
        (the reconnect schedule decides what follows)."""
        params: Dict[str, Any] = {"timeout": str(self.poll_timeout_s)}
        if self.subscriber:
            params["subscriber"] = self.subscriber
        resp = await session.get(self.url, params=params)
        self.last_status = resp.status
        if resp.status != 200:
            raise ConnectionError(f"results/stream answered {resp.status} for {self.target!r}")
        body = resp.json()
        # the server mints an id on the first anonymous poll and echoes it:
        # keep it, or every poll would register a new subscriber
        self.subscriber = body.get("subscriber") or self.subscriber
        self.stats["polls"] += 1
        self.stats["dropped"] += int(body.get("dropped") or 0)
        batch = body.get("results") or []
        self.results.extend(batch)
        return batch

    async def run(
        self,
        session,
        *,
        stop: Optional[asyncio.Event] = None,
        max_polls: Optional[int] = None,
        on_results: Optional[Callable[[List[Any]], None]] = None,
    ) -> Dict[str, int]:
        """Poll until ``stop`` is set (or ``max_polls`` successful polls).
        A failed poll sleeps a decorrelated-jitter delay and reconnects; a
        successful one resets the schedule to its base."""
        while (stop is None or not stop.is_set()) and (max_polls is None or self.stats["polls"] < max_polls):
            try:
                batch = await self.poll_once(session)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                self.stats["failures"] += 1
                if stop is not None and stop.is_set():
                    break
                delay = decorrelated_jitter(self.reconnect_base_s, self._prev_delay, cap=self.reconnect_cap_s,
                                            rng=self._rng)
                self._prev_delay = delay
                self.reconnect_delays.append(delay)
                self.stats["reconnects"] += 1
                logger.debug("subscriber %s poll failed (%s); reconnecting in %.3fs",
                             self.subscriber or "<anon>", exc, delay)
                await asyncio.sleep(delay)
                continue
            self._prev_delay = self.reconnect_base_s
            if batch and on_results is not None:
                on_results(batch)
        return dict(self.stats)
