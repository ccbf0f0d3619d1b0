"""Machines and the default model (counterpart of ``DEFAULT_MODEL_CONFIG``
and ``Machine`` in ``gordo_components_tpu/workflow/config.py``).

A machine is one model to build: a name, its dataset config, its model
config (the reference's default: a min-max scaler in front of an hourglass
autoencoder, in a reconstruction-error detector) and metadata. Both are
built from dicts; reading a fleet YAML file is not ported yet.
"""

import copy
from dataclasses import dataclass, field
from typing import Any, Dict

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
