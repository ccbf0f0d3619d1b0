"""Dataset layer of the port: numpy only (no pandas)."""

from gordo_components_torch.dataset.base import GordoBaseDataset, TagFrame, get_dataset
from gordo_components_torch.dataset.datasets import RandomDataset, TimeSeriesDataset
from gordo_components_torch.dataset.sensor_tag import (
    SensorTag,
    normalize_sensor_tag,
    normalize_sensor_tags,
)

__all__ = [
    "GordoBaseDataset",
    "RandomDataset",
    "SensorTag",
    "TagFrame",
    "TimeSeriesDataset",
    "get_dataset",
    "normalize_sensor_tag",
    "normalize_sensor_tags",
]
