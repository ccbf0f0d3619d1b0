"""Orchestration of the port (counterpart of ``gordo_components_tpu/workflow/``):
fleet configuration (``config.py``), the builders' gang heartbeats
(``gang_state.py``), the compile side of a rollout (the gang scheduler,
the canary judge, the typed fleet DAG, its compiler and the manifest
generator) and its run side, the fleet executor (``executor.py``,
``workflow run``)."""

from gordo_components_torch.workflow.config import DEFAULT_MODEL_CONFIG, Machine, NormalizedConfig
from gordo_components_torch.workflow.gang_state import TERMINAL_PHASES, GangHeartbeat, read_gang_states
from gordo_components_torch.workflow.scheduler import Gang, schedule_gangs
from gordo_components_torch.workflow.canary import CanaryConfig, CanarySignal, CanaryVerdict, judge_canary
from gordo_components_torch.workflow.dag import FleetDAG, Step
from gordo_components_torch.workflow.compiler import FleetSpec, compile_fleet
from gordo_components_torch.workflow.executor import FleetExecutor
from gordo_components_torch.workflow.generator import generate_workflow

__all__ = ["NormalizedConfig", "Machine", "DEFAULT_MODEL_CONFIG", "Gang", "schedule_gangs", "generate_workflow",
           "FleetDAG", "Step", "FleetSpec", "compile_fleet", "FleetExecutor", "CanaryConfig", "CanarySignal",
           "CanaryVerdict", "judge_canary", "GangHeartbeat", "TERMINAL_PHASES", "read_gang_states"]
