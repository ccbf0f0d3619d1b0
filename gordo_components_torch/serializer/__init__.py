"""Artifact persistence of the port."""

from gordo_components_torch.serializer.artifacts import (
    dump,
    is_artifact_dir,
    load,
    load_entry,
    load_metadata,
)

__all__ = ["dump", "is_artifact_dir", "load", "load_entry", "load_metadata"]
