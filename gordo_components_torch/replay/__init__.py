"""Replay of the port: the clock seam (``clock.py``).

Counterpart of ``gordo_components_tpu/replay/``; the replay engine and its
incident library are not ported yet.
"""

from gordo_components_torch.replay.clock import SYSTEM_CLOCK, Clock, ReplayClock, SystemClock

__all__ = ["Clock", "ReplayClock", "SystemClock", "SYSTEM_CLOCK"]
