"""The clock seam: one injectable object behind every read of "now" that
measures the age or freshness of data and events.

Counterpart of ``gordo_components_tpu/replay/clock.py``. A replay
compresses months of event time into seconds of wall time, which only
works if the components whose meaning is defined in wall time (SLO window
ages, heat decay, history and event stamps, sampler cadences) read "now"
from the timeline the replayed events live on.

- :class:`SystemClock` reads ``time.time`` and ``time.monotonic``; the
  module's :data:`SYSTEM_CLOCK` is the default everywhere, one attribute
  lookup over calling the C functions.
- :class:`ReplayClock` is a virtual timeline stepped by its driver
  (:meth:`ReplayClock.advance`, :meth:`ReplayClock.advance_to`), never
  free-running, so a replay is deterministic. ``timescale`` is the
  nominal compression, which cadence-based consumers divide their real
  sleeps by.

The seam rule: quantities that measure how long work took (device
seconds, the swap's pause, a request's wall) never read this clock; they
stay on the real ``time.monotonic``. Quantities that measure the age or
freshness of data and events read the seam.
"""

import threading
import time

__all__ = ["Clock", "ReplayClock", "SystemClock", "SYSTEM_CLOCK"]


class Clock:
    """The seam's interface: ``time()`` epoch seconds, ``monotonic()`` a
    monotonic source on the same timeline, ``timescale`` the event seconds
    a wall second (1.0 = real time)."""

    timescale = 1.0

    def time(self) -> float:
        raise NotImplementedError

    def monotonic(self) -> float:
        raise NotImplementedError


_real_time, _real_monotonic = time.time, time.monotonic


class SystemClock(Clock):
    """Real time; the process default (:data:`SYSTEM_CLOCK`)."""

    time = staticmethod(_real_time)
    monotonic = staticmethod(_real_monotonic)


SYSTEM_CLOCK = SystemClock()


class ReplayClock(Clock):
    """A stepped virtual timeline anchored at ``start_epoch``.

    ``monotonic()`` starts at an arbitrary positive origin (only its
    differences mean anything, as with the real one) and advances with
    the virtual epoch. Time never rewinds: :meth:`advance` refuses a
    negative step and :meth:`advance_to` ignores an earlier epoch.
    Thread-safe: a driver advances it while samplers read it."""

    def __init__(self, start_epoch: float, speed: float = 100.0):
        if speed <= 0:
            raise ValueError(f"speed must be positive, got {speed!r}")
        self._epoch = float(start_epoch)
        self._mono = 1000.0
        self.timescale = float(speed)
        self._lock = threading.Lock()

    def time(self) -> float:
        return self._epoch

    def monotonic(self) -> float:
        return self._mono

    def advance(self, dt_s: float) -> float:
        """Step the timeline ``dt_s`` event seconds forward."""
        if dt_s < 0:
            raise ValueError(f"cannot advance by negative {dt_s!r}s")
        with self._lock:
            self._epoch += dt_s
            self._mono += dt_s
            return self._epoch

    def advance_to(self, epoch_s: float) -> float:
        """Step the epoch to ``epoch_s``; a no-op when already past it."""
        with self._lock:
            dt = float(epoch_s) - self._epoch
            if dt > 0:
                self._epoch += dt
                self._mono += dt
            return self._epoch
