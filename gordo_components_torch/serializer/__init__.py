"""Artifact persistence and the config-definition language of the port."""

from gordo_components_torch.serializer.artifacts import (
    check_artifact_model,
    dump,
    is_artifact_dir,
    load,
    load_entry,
    load_metadata,
)
from gordo_components_torch.serializer.definitions import from_definition, import_locate

__all__ = [
    "check_artifact_model",
    "dump",
    "from_definition",
    "import_locate",
    "is_artifact_dir",
    "load",
    "load_entry",
    "load_metadata",
]
