"""Request parsing and response bodies, with numpy and the standard library.

Counterpart of ``extract_x_y`` and ``frame_to_dict`` in
``gordo_components_tpu/server/utils.py``, without pandas: the port builds the
same JSON bodies straight from arrays. A request body is JSON
(:func:`extract_x_y`) or parquet (:func:`extract_x_y_parquet`, read by the
port's own reader): the file's columns are the tags, its index comes from
the pandas metadata, and ``__y__``-prefixed columns are the target, as the
JAX server splits them out.

Index handling follows ``pd.to_datetime(index, utc=True)`` for ISO 8601
strings: naive times are taken as UTC, aware ones converted to UTC, and the
response carries ``datetime.isoformat()`` strings (``...T00:00:00+00:00``),
which is what pandas gives for UTC timestamps. Any other index (numbers, or
strings that are not ISO 8601) is echoed as given; pandas would read numbers
as epoch nanoseconds and accept some non-ISO date strings.
"""

from datetime import datetime, timedelta, timezone
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from gordo_components_torch.dataset.data_provider._parquet import read_parquet_bytes

Y_PREFIX = "__y__"  # the target's columns in a parquet body (the JAX client's _encode_parquet)
_EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)

ANOMALY_TAG_GROUPS = (
    "model-input",
    "model-output",
    "tag-anomaly-unscaled",
    "tag-anomaly-scaled",
)
ANOMALY_TOTALS = ("total-anomaly-unscaled", "total-anomaly-scaled")


def _parse_matrix(value) -> np.ndarray:
    """``[[...], ...]`` rows, a flat list (one column), or ``{col: [...]}``."""
    if isinstance(value, dict):
        cols = [np.asarray(v, dtype=np.float32) for v in value.values()]
        if any(c.ndim != 1 for c in cols) or len({len(c) for c in cols}) > 1:
            raise ValueError("column dict values must be equal-length lists")
        arr = np.stack(cols, axis=1) if cols else np.zeros((0, 0), np.float32)
    else:
        arr = np.asarray(value, dtype=np.float32)
        if arr.ndim == 1:
            arr = arr[:, None]
    if arr.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got shape {arr.shape}")
    return arr


def _parse_timestamp(value) -> datetime:
    if not isinstance(value, str):
        raise ValueError(f"not an ISO 8601 string: {value!r}")
    ts = datetime.fromisoformat(value)
    if ts.tzinfo is None:
        return ts.replace(tzinfo=timezone.utc)
    return ts.astimezone(timezone.utc)


def _parse_index(index: Optional[Sequence], n: int) -> List[Any]:
    if index is None or len(index) != n:
        return list(range(n))
    try:
        return [_parse_timestamp(v) for v in index]
    except (ValueError, TypeError):
        return list(index)


def extract_x_y(body: Any) -> Tuple[np.ndarray, Optional[np.ndarray], List[Any]]:
    """``{"X": ..., "y": ..., "index": [...]}`` -> (X, y or None, index) with
    X and y float32 (rows, F). The index is a list of UTC datetimes when it
    parses as ISO 8601, the given values otherwise, and ``0..rows-1`` when it
    is absent or of another length than X."""
    if not isinstance(body, dict) or "X" not in body:
        raise ValueError("Request must contain 'X'")
    X = _parse_matrix(body["X"])
    y = _parse_matrix(body["y"]) if body.get("y") is not None else None
    return X, y, _parse_index(body.get("index"), len(X))


def extract_x_y_parquet(raw: bytes) -> Tuple[np.ndarray, Optional[np.ndarray], List[Any]]:
    """A parquet request body -> (X, y or None, index), as
    :func:`extract_x_y` gives them: X and y float32 (rows, F) from the
    columns in the file's order, each cast from the dtype the client wrote
    as the JSON path casts its numbers, so the two encodings of the same
    rows answer alike; ``__y__``-prefixed columns make ``y``. The index is
    UTC datetimes (to the microsecond, as an ISO 8601 index parses) when
    the file holds a timestamp index, else ``0..rows-1``. A body the
    reader refuses raises its ``ValueError`` or ``NotImplementedError``."""
    index_ns, names, columns = read_parquet_bytes(raw, "the request body")
    x_names = [n for n in names if not n.startswith(Y_PREFIX)]
    y_names = [n for n in names if n.startswith(Y_PREFIX)]

    def matrix(cols):
        if any(columns[n].dtype.kind not in "fiu" for n in cols):
            raise ValueError("the request body holds a column that is not numbers")
        return np.stack([columns[n].astype(np.float32) for n in cols], axis=1)

    if not x_names:
        raise ValueError("Request must contain X columns")
    X = matrix(x_names)
    y = matrix(y_names) if y_names else None
    if index_ns is None:
        return X, y, list(range(len(X)))
    if (index_ns == np.iinfo(np.int64).min).any():
        raise ValueError("the request body's index holds a null timestamp")
    return X, y, [_EPOCH + timedelta(microseconds=int(ns) // 1000) for ns in index_ns]


def _index_json(index: Sequence[Any]) -> List[Any]:
    return [v.isoformat() if isinstance(v, datetime) else v for v in index]


def anomaly_body(tags: Sequence[str], arrays: Dict[str, np.ndarray], index: Sequence[Any],
                 output_tags: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """The JAX server's ``frame_to_dict(frame)`` body for an anomaly frame:
    per-tag dicts for the four per-tag groups, plain lists for the two
    totals, and ``index``, which the caller has trimmed to the output rows
    (``index[offset:][:n_out]`` for a sequence model). ``model-input`` is
    keyed by ``tags``; the model-space groups by ``output_tags`` (the
    transformed columns of a pipeline that is not affine), by ``tags``
    when it is None."""
    data: Dict[str, Any] = {}
    for group in ANOMALY_TAG_GROUPS:
        a = arrays[group]
        names = tags if group == "model-input" or output_tags is None else output_tags
        data[group] = {str(t): a[:, i].tolist() for i, t in enumerate(names)}
    for group in ANOMALY_TOTALS:
        data[group] = arrays[group].tolist()
    return {"data": data, "index": _index_json(index)}


def prediction_body(output: np.ndarray, index: Sequence[Any]) -> Dict[str, Any]:
    """The JAX server's ``/prediction`` body: the reconstruction rows and
    ``str()`` of each index value, the index trimmed by the caller to the
    last ``len(output)`` rows of the request."""
    return {"data": output.tolist(), "index": [str(i) for i in index]}
