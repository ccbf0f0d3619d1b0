"""Data-provider contract (counterpart of
``gordo_components_tpu/dataset/data_provider/base.py``): a provider yields
one :class:`Series` per sensor tag for a time range and serializes itself
into metadata."""

import abc
from typing import Iterable, List, NamedTuple

import numpy as np

from gordo_components_torch.dataset.sensor_tag import SensorTag


class Series(NamedTuple):
    """One tag's samples: ``index`` int64 ns since the epoch (UTC), ``values``."""

    name: str
    index: np.ndarray
    values: np.ndarray


class GordoBaseDataProvider(abc.ABC):
    @abc.abstractmethod
    def load_series(self, from_ns: int, to_ns: int, tag_list: List[SensorTag]) -> Iterable[Series]:
        """Yield one Series per tag over ``[from_ns, to_ns)``."""

    def to_dict(self) -> dict:
        """Serialize into metadata/config form."""
        cls = type(self)
        return {"type": f"{cls.__module__}.{cls.__qualname__}", **getattr(self, "_params", {})}
