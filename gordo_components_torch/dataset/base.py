"""Dataset contract and config factory (counterpart of
``gordo_components_tpu/dataset/base.py``)."""

import abc
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class TagFrame:
    """Rows of tag values and their timestamps: what a dataset's
    ``get_data`` returns. ``values`` (rows, tags) float32, ``index``
    (rows,) ``datetime64[ns]`` in UTC, ``columns`` the tag names."""

    values: np.ndarray
    index: np.ndarray
    columns: List[str]

    def __len__(self) -> int:
        return len(self.values)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.values.shape


@dataclass(frozen=True, eq=False)
class ResultFrame:
    """A scored time range, where the JAX bulk client returns a DataFrame.
    ``values`` (rows, columns) float64, as the JAX frames hold them;
    ``index`` (rows,) ``datetime64[ns]`` in UTC (the server's index as
    given when it does not read as timestamps); ``columns`` the JAX
    frame's labels in its order: ``(group, tag)`` tuples for an anomaly
    frame, ``(total, "")`` for its two totals, ``0..n-1`` for a
    prediction frame."""

    values: np.ndarray
    index: np.ndarray
    columns: List[Any]

    def __len__(self) -> int:
        return len(self.values)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.values.shape

    @classmethod
    def concat(cls, frames: Sequence["ResultFrame"]) -> "ResultFrame":
        """The frames' rows one after the other, as ``pd.concat`` joins
        frames of the same columns."""
        return cls(np.concatenate([f.values for f in frames]), np.concatenate([f.index for f in frames]),
                   list(frames[0].columns))


class GordoBaseDataset(abc.ABC):
    @abc.abstractmethod
    def get_data(self) -> Tuple[TagFrame, Optional[TagFrame]]:
        """Returns ``(X, y)``; y is None for a pure-autoencoder dataset."""

    @abc.abstractmethod
    def get_metadata(self) -> Dict[str, Any]:
        """JSON-serializable description of the dataset for the build
        metadata: tags, date range, resolution, row counts."""


def get_dataset(config: Dict[str, Any]) -> GordoBaseDataset:
    """A dataset from a data config dict: ``type`` selects the class (a
    short name of this package or a dotted path); the other keys are its
    constructor's arguments."""
    from gordo_components_torch.dataset import datasets

    config = dict(config)
    kind = config.pop("type", "TimeSeriesDataset")
    if "." in kind:
        from gordo_components_torch.serializer.definitions import import_locate

        cls = import_locate(kind)
    else:
        try:
            cls = getattr(datasets, kind)
        except AttributeError:
            raise ValueError(f"Unknown dataset type {kind!r}") from None
    return cls(**config)
