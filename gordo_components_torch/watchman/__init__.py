"""Watchman of the port: the fleet-health service (``server.py``: the
health snapshot, the fleet rollups and the routing table over one or more
serving replicas, ``run-watchman``) and the incident correlation
(``correlate.py``), which the replay engine also uses to render its
per-scenario timelines.

Counterpart of ``gordo_components_tpu/watchman/``, with the write side:
``POST /rebalance``, ``/migrate`` and ``/fleet-rebalance`` move members
across the serving mesh.
"""

from gordo_components_torch.watchman.correlate import burn_episodes, group_incidents, render_timeline
from gordo_components_torch.watchman.server import build_watchman_app, run_watchman

__all__ = ["build_watchman_app", "burn_episodes", "group_incidents", "render_timeline", "run_watchman"]
