"""Concrete datasets (counterpart of ``TimeSeriesDataset``/``RandomDataset``
in ``gordo_components_tpu/dataset/datasets.py``): pull each tag's series
from a provider, resample them to ``resolution`` with
``aggregation_method`` and outer-join them
(:func:`~.resample.fused_agg_join`), drop rows with any missing value,
then keep the rows ``row_filter`` (a pandas expression, read by
:mod:`~.filter_rows`) selects; X holds the tags, y the ``target_tag_list``
tags when given.

``get_data()`` returns ``(X, y)`` as :class:`TagFrame` objects: float32
values, a UTC ``datetime64[ns]`` index and the tag names. Two tags of one
name (on two assets) raise ``ValueError``, where the JAX package joins
them through pandas into two columns of one name.
"""

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from gordo_components_torch.dataset.base import GordoBaseDataset, TagFrame
from gordo_components_torch.dataset.data_provider.base import GordoBaseDataProvider
from gordo_components_torch.dataset.data_provider.providers import RandomDataProvider
from gordo_components_torch.dataset.filter_rows import filter_mask
from gordo_components_torch.dataset.resample import fused_agg_join
from gordo_components_torch.dataset.sensor_tag import normalize_sensor_tags
from gordo_components_torch.dataset.times import (
    isoformat,
    normalize_resolution,
    parse_resolution,
    to_ns,
)
from gordo_components_torch.utils import capture_args


class TimeSeriesDataset(GordoBaseDataset):
    """Provider-backed multi-tag time-series dataset."""

    @capture_args
    def __init__(
        self,
        train_start_date,
        train_end_date,
        tag_list: List,
        target_tag_list: Optional[List] = None,
        data_provider=None,
        resolution: str = "10min",
        aggregation_method: str = "mean",
        row_filter: str = "",
        asset: Optional[str] = None,
    ):
        self.start_ns = to_ns(train_start_date)
        self.end_ns = to_ns(train_end_date)
        if self.start_ns >= self.end_ns:
            raise ValueError("train_start_date must precede train_end_date")
        self.tag_list = normalize_sensor_tags(tag_list, asset)
        self.target_tag_list = normalize_sensor_tags(target_tag_list, asset) if target_tag_list else []
        if data_provider is None:
            data_provider = RandomDataProvider()
        elif isinstance(data_provider, dict):
            data_provider = _provider_from_dict(data_provider)
        self.data_provider: GordoBaseDataProvider = data_provider
        self.resolution = normalize_resolution(resolution)
        self.aggregation_method = aggregation_method
        self.row_filter = row_filter
        self._last_metadata: Dict[str, Any] = {}

    def get_data(self) -> Tuple[TagFrame, Optional[TagFrame]]:
        tags = [t.name for t in self.tag_list]
        extra = [t for t in self.target_tag_list if t.name not in tags]
        series = list(self.data_provider.load_series(
            self.start_ns, self.end_ns, list(self.tag_list) + extra
        ))
        index, columns, tag_meta = fused_agg_join(
            series, self.start_ns, self.end_ns, parse_resolution(self.resolution),
            self.aggregation_method,
        )
        rows_joined = index.size
        keep = np.ones(index.size, bool)
        for col in columns.values():
            keep &= ~np.isnan(col)
        rows_dropna = int(keep.sum())
        if self.row_filter:
            kept = filter_mask({n: c[keep] for n, c in columns.items()}, self.row_filter, rows_dropna)
            keep[np.flatnonzero(keep)[~kept]] = False
        index = index[keep]
        self._last_metadata = {
            "tag_loading": tag_meta,
            "rows_joined": int(rows_joined),
            "rows_after_dropna": rows_dropna,
            "rows_after_filter": int(index.size),
        }

        def frame(names):
            values = np.stack([columns[n][keep] for n in names], axis=1).astype(np.float32)
            return TagFrame(values, index.astype("datetime64[ns]"), list(names))

        y = frame([t.name for t in self.target_tag_list]) if self.target_tag_list else None
        return frame(tags), y

    def get_metadata(self) -> Dict[str, Any]:
        return {
            "type": type(self).__name__,
            "train_start_date": isoformat(self.start_ns),
            "train_end_date": isoformat(self.end_ns),
            "tag_list": [t._asdict() for t in self.tag_list],
            "target_tag_list": [t._asdict() for t in self.target_tag_list],
            "resolution": self.resolution,
            "aggregation_method": self.aggregation_method,
            "row_filter": self.row_filter,
            "data_provider": self.data_provider.to_dict(),
            **self._last_metadata,
        }


class RandomDataset(TimeSeriesDataset):
    """TimeSeriesDataset over deterministic synthetic data from
    :class:`RandomDataProvider` (seeded by ``seed``)."""

    @capture_args
    def __init__(
        self,
        train_start_date="2017-12-25 06:00:00Z",
        train_end_date="2017-12-29 06:00:00Z",
        tag_list: Optional[List] = None,
        seed: int = 0,
        **kwargs,
    ):
        tag_list = tag_list or [f"tag-{i}" for i in range(10)]
        kwargs.setdefault("data_provider", RandomDataProvider(seed=seed))
        self.seed = int(seed)
        super().__init__(
            train_start_date=train_start_date, train_end_date=train_end_date,
            tag_list=tag_list, **kwargs,
        )


def _provider_from_dict(config: Dict[str, Any]) -> GordoBaseDataProvider:
    """Inverse of ``GordoBaseDataProvider.to_dict``."""
    from gordo_components_torch.dataset import data_provider as dp_module
    from gordo_components_torch.serializer.definitions import import_locate

    config = dict(config)
    kind = config.pop("type", "RandomDataProvider")
    if "." in kind:
        cls = import_locate(kind)
    elif hasattr(dp_module, kind):
        cls = getattr(dp_module, kind)
    else:
        raise NotImplementedError(f"data provider {kind!r} is not ported")
    return cls(**config)
