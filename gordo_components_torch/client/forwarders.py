"""Prediction forwarders.

Counterpart of ``gordo_components_tpu/client/forwarders.py``: write each
target's :class:`~gordo_components_torch.dataset.base.ResultFrame` back to
a store. The Influx forwarder takes an injected client (an object with
``write_points``) and gives it the JAX forwarder's points; the parquet
forwarder writes ``<root>/<machine>.parquet`` with the port's own writer
(no pyarrow), columns named ``"group|tag"`` as the JAX one names them.
"""

import logging
import os
from typing import Any

import numpy as np

from gordo_components_torch.dataset.data_provider._parquet import write_parquet
from gordo_components_torch.dataset.times import timestamp_texts

__all__ = ["ForwardPredictionsIntoInflux", "ForwardPredictionsIntoParquet"]

logger = logging.getLogger(__name__)


def flat_name(column) -> str:
    """``"group|tag"`` for a ``(group, tag)`` label (``"group"`` for a
    total), ``str`` of any other."""
    return "|".join(c for c in column if c) if isinstance(column, tuple) else str(column)


def _index_texts(index: np.ndarray) -> list:
    """``str()`` of each index value as pandas writes it."""
    if index.dtype.kind == "M":
        return timestamp_texts(index)
    return [str(v) for v in index.tolist()]


class ForwardPredictionsIntoInflux:
    """Write each target's frame as InfluxDB points through ``client``
    (an object with ``write_points(points)``, such as
    ``influxdb.InfluxDBClient``): one point a cell, tagged with the
    machine and the flat column name, timed by the index's text."""

    def __init__(self, client: Any = None, destination_measurement: str = "predictions", value_name: str = "value"):
        if client is None:
            raise ValueError("InfluxDB client package unavailable — pass client= (object with write_points).")
        self.client = client
        self.destination_measurement = destination_measurement
        self.value_name = value_name

    def forward(self, result) -> None:
        frame = result.predictions
        fields = [flat_name(c) for c in frame.columns]
        points = [
            {
                "measurement": self.destination_measurement,
                "tags": {"machine": result.name, "field": name},
                "time": ts,
                "fields": {self.value_name: value},
            }
            for ts, row in zip(_index_texts(frame.index), frame.values.tolist())
            for name, value in zip(fields, row)
        ]
        logger.info("Forwarding %d points for %s to influx", len(points), result.name)
        self.client.write_points(points)


class ForwardPredictionsIntoParquet:
    """Write each target's frame to ``<root>/<machine>.parquet``."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def forward(self, result) -> None:
        path = os.path.join(self.root, f"{result.name}.parquet")
        frame = result.predictions
        names = [flat_name(c) for c in frame.columns]
        write_parquet(path, frame.index, names, {n: frame.values[:, i] for i, n in enumerate(names)})
        logger.info("Wrote predictions for %s -> %s", result.name, path)
