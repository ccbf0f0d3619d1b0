"""Many-model training of the port."""

from gordo_components_torch.parallel.fleet import (
    FleetMemberModel,
    FleetTrainer,
    quantize_batch_count,
    quantize_member_count,
)

__all__ = ["FleetMemberModel", "FleetTrainer", "quantize_batch_count", "quantize_member_count"]
