"""Time-compressed replay and incident-scenario harness of the port.

Counterpart of ``gordo_components_tpu/replay/``: it backtests the full
ingest -> drift -> recalibrate -> refit -> hot-swap loop, months of
simulated sensor history driven through the server's real HTTP surface
at 100-1000x wall speed, under a composable incident library, with a
per-scenario verdict (detection latency, FP/FN rates before and after
adaptation, adaptation cost, swap pauses, non-200 count).

- ``clock``     — the injectable wall-time seam everything rides on
- ``incidents`` — composable incident primitives + scenario container
- ``scenarios`` — the standard regression library
- ``verdict``   — the verdict envelope shared with the game-day catalog
- ``engine``    — the replay engine + verdict assembly

Only the clock is imported eagerly: the streaming plane reads the seam
on its import path, so pulling the engine (which imports the server
stack) in at package-init time would be a cycle. Engine/incident names
resolve lazily (PEP 562).
"""

from gordo_components_torch.replay.clock import SYSTEM_CLOCK, Clock, ReplayClock, SystemClock

__all__ = ["Clock", "Incident", "ReplayClock", "ReplayEngine", "Scenario", "standard_scenarios", "SYSTEM_CLOCK",
           "SystemClock"]

_LAZY = {
    "Incident": "gordo_components_torch.replay.incidents",
    "Scenario": "gordo_components_torch.replay.incidents",
    "ReplayEngine": "gordo_components_torch.replay.engine",
    "standard_scenarios": "gordo_components_torch.replay.scenarios",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
