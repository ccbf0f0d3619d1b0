"""Fleet configuration of the port."""

from gordo_components_torch.workflow.config import DEFAULT_MODEL_CONFIG, Machine, NormalizedConfig

__all__ = ["DEFAULT_MODEL_CONFIG", "Machine", "NormalizedConfig"]
