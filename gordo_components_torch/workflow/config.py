"""Machines, the default model and fleet configs (counterpart of
``gordo_components_tpu/workflow/config.py``).

A machine is one model to build: a name, its dataset config, its model
config (the reference's default: a min-max scaler in front of an hourglass
autoencoder, in a reconstruction-error detector), metadata and its
evaluation (cross-validation) block. :class:`NormalizedConfig` reads a
fleet config, a YAML string (through the port's own reader,
``utils/yaml_subset.py``) or a mapping, and merges its ``globals`` into
every machine.
"""

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, List, Union

from gordo_components_torch.utils.yaml_subset import safe_load

DEFAULT_MODEL_CONFIG: Dict[str, Any] = {
    "gordo_components_torch.models.DiffBasedAnomalyDetector": {
        "base_estimator": {
            "sklearn.pipeline.Pipeline": {
                "steps": [
                    "sklearn.preprocessing.MinMaxScaler",
                    {"gordo_components_torch.models.AutoEncoder": {"kind": "feedforward_hourglass"}},
                ]
            }
        }
    }
}

DEFAULT_DATASET_CONFIG: Dict[str, Any] = {"type": "TimeSeriesDataset"}


@dataclass
class Machine:
    """One machine = one model to build."""

    name: str
    dataset: Dict[str, Any]
    model: Dict[str, Any] = field(default_factory=lambda: copy.deepcopy(DEFAULT_MODEL_CONFIG))
    metadata: Dict[str, Any] = field(default_factory=dict)
    evaluation: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if not self.name or "/" in self.name:
            raise ValueError(f"Invalid machine name {self.name!r}")
        if "tags" in self.dataset and "tag_list" not in self.dataset:
            self.dataset["tag_list"] = self.dataset.pop("tags")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Machine":
        """A machine from a config dict (``name``, ``dataset``, and
        optionally ``model``, ``metadata``, ``evaluation``)."""
        return cls(
            name=d["name"],
            dataset=copy.deepcopy(d.get("dataset") or {}),
            model=copy.deepcopy(d.get("model") or DEFAULT_MODEL_CONFIG),
            metadata=copy.deepcopy(d.get("metadata") or {}),
            evaluation=copy.deepcopy(d.get("evaluation") or {}),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "dataset": self.dataset,
            "model": self.model,
            "metadata": self.metadata,
            "evaluation": self.evaluation,
        }


def _deep_merge(base: Dict, override: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


class NormalizedConfig:
    """Project defaults merged into per-machine specs::

        machines:
          - name: machine-1
            dataset: {tags: [...], train_start_date: ..., train_end_date: ...}
            model: {...}           # optional override
            metadata: {...}
            evaluation: {...}
        globals:                   # optional project defaults
          model: {...}
          dataset: {...}
          metadata: {...}
          evaluation: {...}        # cross-validation defaults
          runtime: {...}           # kept in ``runtime``

    A machine may be given as its bare name. The whole input stays in
    ``raw``, so top-level keys the port does not read (``fleet:``) survive.
    """

    def __init__(self, config: Union[str, Dict[str, Any]]):
        if isinstance(config, str):
            config = safe_load(config)
        if not isinstance(config, dict) or "machines" not in config:
            raise ValueError("Config must be a mapping with a 'machines' list")
        self.raw = config
        globals_ = config.get("globals", {}) or {}
        default_model = globals_.get("model", DEFAULT_MODEL_CONFIG)
        default_dataset = _deep_merge(DEFAULT_DATASET_CONFIG, globals_.get("dataset", {}) or {})
        default_metadata = globals_.get("metadata", {}) or {}
        default_evaluation = globals_.get("evaluation", {}) or {}
        self.runtime: Dict[str, Any] = globals_.get("runtime", {}) or {}

        self.machines: List[Machine] = []
        seen = set()
        for entry in config["machines"]:
            if isinstance(entry, str):
                entry = {"name": entry, "dataset": {}}
            name = entry.get("name")
            if name in seen:
                raise ValueError(f"Duplicate machine name {name!r}")
            seen.add(name)
            self.machines.append(Machine(
                name=name,
                dataset=_deep_merge(default_dataset, entry.get("dataset", {}) or {}),
                model=copy.deepcopy(entry["model"] if entry.get("model") else default_model),
                metadata=_deep_merge(default_metadata, entry.get("metadata", {}) or {}),
                evaluation=_deep_merge(default_evaluation, entry.get("evaluation", {}) or {}),
            ))

    @classmethod
    def from_yaml_file(cls, path: str) -> "NormalizedConfig":
        with open(path) as f:
            return cls(safe_load(f.read()))
