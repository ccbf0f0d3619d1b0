"""The served model collection, read from port artifact directories.

Counterpart of ``scan_artifacts`` and ``ModelCollection`` in
``gordo_components_tpu/server/model_io.py``, over the port's artifact format
(``serializer/artifacts.py``): no pickle is ever loaded.
"""

import os
from typing import Dict, List, Optional

from gordo_components_torch.serializer.artifacts import (
    is_artifact_dir,
    load_entry,
    load_metadata,
)


def scan_artifacts(root: str, target_name: Optional[str] = None) -> Dict[str, str]:
    """name -> artifact dir under ``root``: ``root`` itself when it is an
    artifact (named ``target_name`` or its basename), else each artifact
    subdirectory under its own name."""
    if is_artifact_dir(root):
        return {target_name or os.path.basename(os.path.normpath(root)): root}
    try:
        entries = sorted(os.listdir(root))
    except FileNotFoundError:
        return {}
    return {
        e: os.path.join(root, e) for e in entries if is_artifact_dir(os.path.join(root, e))
    }


class ModelCollection:
    """name -> (bank entry, metadata) for every artifact under ``root``."""

    def __init__(self, root: str, target_name: Optional[str] = None):
        self.root = root
        self.entries = {}
        self.metadata = {}
        for name, path in scan_artifacts(root, target_name).items():
            self.entries[name] = load_entry(path, name)
            self.metadata[name] = load_metadata(path)
        if not self.entries:
            raise FileNotFoundError(f"No model artifacts found under {root!r}")

    def names(self) -> List[str]:
        return sorted(self.entries)

    def entry(self, name: str):
        """(entry, metadata); KeyError for an unknown name."""
        return self.entries[name], self.metadata[name]
