"""Fleet configuration of the port (``config.py``) and the builders' gang
heartbeats (``gang_state.py``)."""

from gordo_components_torch.workflow.config import DEFAULT_MODEL_CONFIG, Machine, NormalizedConfig
from gordo_components_torch.workflow.gang_state import TERMINAL_PHASES, GangHeartbeat, read_gang_states

__all__ = ["DEFAULT_MODEL_CONFIG", "GangHeartbeat", "Machine", "NormalizedConfig", "TERMINAL_PHASES",
           "read_gang_states"]
