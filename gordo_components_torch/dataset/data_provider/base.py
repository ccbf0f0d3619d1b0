"""Data-provider contract (counterpart of
``gordo_components_tpu/dataset/data_provider/base.py``): a provider yields
one :class:`Series` per sensor tag for a time range, says which tags it
can read, and serializes itself into metadata."""

import abc
from typing import Iterable, List, NamedTuple

import numpy as np

from gordo_components_torch.dataset.sensor_tag import SensorTag


class Series(NamedTuple):
    """One tag's samples: ``index`` int64 ns since the epoch (UTC), ``values``."""

    name: str
    index: np.ndarray
    values: np.ndarray


def empty_series(name: str) -> Series:
    """A tag with no samples in the range."""
    return Series(name, np.empty(0, np.int64), np.empty(0, np.float64))


def sorted_in_range(name: str, index: np.ndarray, values: np.ndarray, from_ns: int,
                    to_ns: int) -> Series:
    """The samples sorted by time (a stable sort) within ``[from_ns, to_ns)``."""
    order = np.argsort(index, kind="stable")
    index, values = index[order], values[order]
    keep = (index >= from_ns) & (index < to_ns)
    return Series(name, index[keep], values[keep])


class GordoBaseDataProvider(abc.ABC):
    # True when load_series spends its time waiting on IO (files, a wire),
    # False for providers that compute their data on the host
    io_bound = True

    @abc.abstractmethod
    def load_series(self, from_ns: int, to_ns: int, tag_list: List[SensorTag],
                    dry_run: bool = False) -> Iterable[Series]:
        """Yield one Series per tag over ``[from_ns, to_ns)``."""

    @abc.abstractmethod
    def can_handle_tag(self, tag: SensorTag) -> bool:
        """Whether this provider knows how to read ``tag``."""

    def to_dict(self) -> dict:
        """Serialize into metadata/config form."""
        cls = type(self)
        return {"type": f"{cls.__module__}.{cls.__qualname__}",
                **{k: _jsonable(v) for k, v in getattr(self, "_params", {}).items()}}


def _jsonable(v):
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if hasattr(v, "isoformat"):  # a datetime
        return v.isoformat()
    return repr(v)
