"""The placement control plane: load-aware shard rebalancing and the hot
swap (counterpart of ``gordo_components_tpu/placement``).

- :mod:`~gordo_components_torch.placement.planner`: the deterministic
  planners, a bank's shards (``plan_rebalance``) and the serving mesh's
  replicas (``plan_fleet``);
- :mod:`~gordo_components_torch.server.swap`: the zero-downtime bank swap
  (the JAX ``placement/swap.py``; one copy, shared with ``/reload``);
- :mod:`~gordo_components_torch.placement.controller`: the control loop
  behind ``GET /placement``, ``POST /rebalance`` and
  ``GORDO_REBALANCE=auto``.
"""

from gordo_components_torch.placement.controller import PlacementController
from gordo_components_torch.placement.planner import RebalancePlan, plan_rebalance, skew_ratio
from gordo_components_torch.server.swap import SwapResult, build_bank, snapshot_collectors, swap_bank

__all__ = [
    "PlacementController",
    "RebalancePlan",
    "SwapResult",
    "build_bank",
    "plan_rebalance",
    "skew_ratio",
    "snapshot_collectors",
    "swap_bank",
]
