"""Artifact persistence and the config-definition language of the port."""

from gordo_components_torch.serializer.artifacts import (
    copy_artifact,
    dump,
    dump_metadata,
    dumps,
    is_artifact_dir,
    load,
    load_entry,
    load_metadata,
    loads,
)
from gordo_components_torch.serializer.definitions import (
    from_definition,
    import_locate,
    into_definition,
    pipeline_from_definition,
    pipeline_into_definition,
)

__all__ = [
    "copy_artifact",
    "dump",
    "dump_metadata",
    "dumps",
    "from_definition",
    "import_locate",
    "into_definition",
    "is_artifact_dir",
    "load",
    "load_entry",
    "load_metadata",
    "loads",
    "pipeline_from_definition",
    "pipeline_into_definition",
]
