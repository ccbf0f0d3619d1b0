"""Per-request deadlines.

Counterpart of ``gordo_components_tpu/resilience/deadline.py``. A client
stamps ``X-Gordo-Deadline-Ms`` (its remaining patience) on a scoring POST;
the server parses it, or applies the operator's default
``GORDO_DEFAULT_DEADLINE_MS``, into a :class:`Deadline`. The batching
engine refuses an expired request at admission and drops the expired
entries of a batch before any device work; ``ModelBank.score_many`` checks
the batch's earliest deadline between bucket groups. An expired request
answers 504 with :class:`DeadlineExceeded`, so the card computes only
answers someone still waits for.

:class:`DeadlineExceeded` subclasses the builtin ``TimeoutError`` (which
``asyncio.TimeoutError`` is on Python 3.11 and later, the JAX class's
base), so a caller that catches ``asyncio.TimeoutError`` catches a spent
deadline too. Deadlines are absolute ``time.monotonic()`` instants; the
header carries a relative budget. :meth:`Deadline.wait_for` bounds an
awaitable by the remaining budget: the bulk client's per-attempt bound and
its ``metadata-all`` fetch.
"""

import asyncio
import math
import os
import time
from typing import Any, Awaitable, Optional

__all__ = [
    "DEADLINE_HEADER",
    "Deadline",
    "DeadlineExceeded",
    "MAX_DEADLINE_MS",
    "default_deadline_ms",
    "parse_deadline_ms",
]

DEADLINE_HEADER = "X-Gordo-Deadline-Ms"
ENV_DEFAULT = "GORDO_DEFAULT_DEADLINE_MS"

# the most a client's budget may be: any HTTP peer sets the header, and a
# near-infinite value must not make a deadline that never expires
MAX_DEADLINE_MS = 24 * 3600 * 1e3


class DeadlineExceeded(TimeoutError):
    """The request's time budget ran out before the work completed (HTTP
    504, with the request id)."""


class Deadline:
    """An absolute monotonic expiry instant with its original budget."""

    __slots__ = ("expires_at", "budget_s")

    def __init__(self, seconds: float):
        self.budget_s = max(0.0, float(seconds))
        self.expires_at = time.monotonic() + self.budget_s

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        return cls(float(ms) / 1e3)

    def expired(self, now: Optional[float] = None) -> bool:
        """``now`` lets a batch loop reuse one clock read for N checks."""
        return (time.monotonic() if now is None else now) >= self.expires_at

    def remaining_s(self) -> float:
        """Seconds left, at least 0."""
        return max(0.0, self.expires_at - time.monotonic())

    def remaining_ms(self) -> float:
        return self.remaining_s() * 1e3

    async def wait_for(self, awaitable: Awaitable[Any]) -> Any:
        """``asyncio.wait_for`` bounded by the remaining budget, raising
        :class:`DeadlineExceeded` when it runs out."""
        try:
            return await asyncio.wait_for(awaitable, timeout=self.remaining_s())
        except asyncio.TimeoutError:
            raise DeadlineExceeded(f"deadline exceeded after {self.budget_s:.3f}s budget") from None

    def __repr__(self) -> str:
        return f"<Deadline budget={self.budget_s:.3f}s remaining={self.remaining_s():.3f}s>"


def parse_deadline_ms(raw: Optional[str]) -> Optional[float]:
    """Milliseconds from an ``X-Gordo-Deadline-Ms`` value, or None for a
    missing, malformed, non-finite or non-positive one (the request then
    runs under the server's default); at most :data:`MAX_DEADLINE_MS`."""
    if not raw:
        return None
    try:
        ms = float(raw.strip())
    except (TypeError, ValueError):
        return None
    if not math.isfinite(ms) or ms <= 0:
        return None
    return min(ms, MAX_DEADLINE_MS)


def default_deadline_ms() -> Optional[float]:
    """The operator's default budget from ``GORDO_DEFAULT_DEADLINE_MS``
    (milliseconds; unset or empty: none). A malformed value raises: a typo
    must not turn the protection off without a word."""
    raw = os.environ.get(ENV_DEFAULT, "").strip()
    if not raw:
        return None
    try:
        ms = float(raw)
    except ValueError:
        raise ValueError(f"{ENV_DEFAULT} must be a number of milliseconds, got {raw!r}") from None
    if not math.isfinite(ms) or ms <= 0:
        raise ValueError(f"{ENV_DEFAULT} must be a positive finite number of ms, got {raw!r}")
    return min(ms, MAX_DEADLINE_MS)
