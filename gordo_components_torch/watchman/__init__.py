"""Watchman of the port: the incident correlation (``correlate.py``).

Counterpart of ``gordo_components_tpu/watchman/``. The fleet-health
service itself (``server.py``, ``run-watchman``) is not ported yet; the
replay engine renders its per-scenario timelines with
:func:`correlate.render_timeline`.
"""

from gordo_components_torch.watchman.correlate import burn_episodes, group_incidents, render_timeline

__all__ = ["burn_episodes", "group_incidents", "render_timeline"]
