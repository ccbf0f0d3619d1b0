"""Client-side retry budget and decorrelated-jitter backoff.

Counterpart of ``gordo_components_tpu/resilience/retry_budget.py``, the
same arithmetic: fed the same ``random.Random``, :func:`decorrelated_jitter`
gives the JAX module's sleeps bitwise. Two halves of one overload defense,
the client's side of the server's shedding and deadline drops:

- :class:`RetryBudget`, a token bucket bounding how much extra load a
  retrying client may add. Every first attempt deposits ``ratio`` tokens,
  every retry withdraws one whole token, so with ``ratio=0.1`` a client
  re-offers at most about 10% of its offered load however the fleet
  fails. One bucket is shared across a client's concurrent chunks: a
  thousand chunks failing together cannot each claim three retries.
- :func:`decorrelated_jitter`, the backoff schedule in place of
  ``backoff * 2**attempt``. A deterministic schedule synchronizes chunks
  that failed together, which then re-arrive together and re-create the
  overload they backed off from; ``uniform(base, prev * 3)``, capped,
  spreads each retry wave thinner than the last.
"""

import random
import threading
from typing import Dict, Optional

__all__ = ["RetryBudget", "decorrelated_jitter"]


def decorrelated_jitter(
    base: float,
    prev: float,
    cap: float = 60.0,
    rng: Optional[random.Random] = None,
) -> float:
    """The next sleep of a decorrelated-jitter schedule: ``base`` is the
    backoff floor, ``prev`` the previous sleep (``base`` on the first
    retry). It grows in expectation like exponential backoff, but two
    clients never share a schedule."""
    r = rng.uniform if rng is not None else random.uniform
    return min(max(0.0, cap), r(base, max(base, prev * 3.0)))


class RetryBudget:
    """Token-bucket retry admission shared across concurrent requests.

    ``note_request()`` (once a logical request) deposits ``ratio``
    tokens; ``try_spend()`` withdraws one a retry and says whether the
    retry may go. ``initial`` pre-fills the bucket, so a few early
    failures can retry before deposits accumulate; ``max_tokens`` bounds
    what a quiet period can bank for a later storm. Thread-safe.
    """

    def __init__(
        self,
        ratio: float = 0.1,
        initial: float = 10.0,
        max_tokens: float = 100.0,
    ):
        if ratio < 0:
            raise ValueError(f"ratio must be >= 0, got {ratio!r}")
        if max_tokens <= 0:
            raise ValueError(f"max_tokens must be positive, got {max_tokens!r}")
        self.ratio = float(ratio)
        self.max_tokens = float(max_tokens)
        self.tokens = min(float(initial), self.max_tokens)
        self.requests = 0
        self.allowed = 0  # retries the budget admitted
        self.denied = 0  # retries the budget refused
        self._lock = threading.Lock()

    def note_request(self) -> None:
        """One logical request offered: deposit the earned retry fraction."""
        with self._lock:
            self.requests += 1
            self.tokens = min(self.max_tokens, self.tokens + self.ratio)

    def try_spend(self) -> bool:
        """Withdraw one retry token; False: the budget is spent, do not
        retry (fail fast: the fleet is saturated with first offers)."""
        with self._lock:
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                self.allowed += 1
                return True
            self.denied += 1
            return False

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {
                "tokens": round(self.tokens, 3),
                "ratio": self.ratio,
                "requests": self.requests,
                "retries_allowed": self.allowed,
                "retries_denied": self.denied,
            }

    def __repr__(self) -> str:
        s = self.snapshot()
        return (
            f"<RetryBudget tokens={s['tokens']} ratio={s['ratio']} "
            f"allowed={s['retries_allowed']} denied={s['retries_denied']}>"
        )
