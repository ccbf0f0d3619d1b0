"""Model builders of the port: one model (``build_model``) and a fleet
(``build_fleet``)."""

from gordo_components_torch.builder.build_model import (
    build_model,
    calculate_model_key,
    provide_saved_model,
)
from gordo_components_torch.builder.fleet_build import FleetBuildReport, build_fleet

__all__ = [
    "FleetBuildReport",
    "build_fleet",
    "build_model",
    "calculate_model_key",
    "provide_saved_model",
]
