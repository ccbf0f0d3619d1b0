"""Read the tables the file providers hold, without pandas.

The JAX package reads them with ``pd.read_csv`` and ``pd.read_parquet``;
these helpers give the same columns as numpy arrays:

- CSV through the ``csv`` module: a header row (or the ``names`` given),
  blank lines skipped, every field a string. :func:`float_column` reads
  a column as float64 with pandas' default missing-value strings as NaN
  and :func:`~gordo_components_torch.dataset.times.parse_times` reads a
  timestamp column.
- Parquet through the port's own reader (``_parquet.py``: the subset
  pandas and pyarrow write by default, with numpy and the standard
  library): the columns as numpy arrays, and the index the column the
  ``pandas`` schema metadata names in ``index_columns``
  (``__index_level_0__`` for a frame pandas wrote), as ``pd.read_parquet``
  takes it. A file outside that subset raises ``NotImplementedError``
  naming what it holds.
"""

import csv
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gordo_components_torch.dataset.data_provider._parquet import read_parquet  # noqa: F401 (the providers' import)
from gordo_components_torch.dataset.times import parse_times

# pandas' default ``na_values`` (``pandas._libs.parsers.STR_NA_VALUES``)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
    "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})


def read_csv(path: str, delimiter: str = ",", names: Optional[Sequence[str]] = None
             ) -> Tuple[List[str], Dict[str, List[str]]]:
    """(column names, name -> the column's strings) of a CSV file: its
    header names the columns, or ``names`` does for a file without one."""
    with open(path, newline="") as f:
        rows = [row for row in csv.reader(f, delimiter=delimiter) if row]
    if names is None:
        if not rows:
            raise ValueError(f"{path}: no header row")
        names, rows = rows[0], rows[1:]
    names = list(names)
    width = len(names)
    for i, row in enumerate(rows):
        if len(row) > width:
            raise ValueError(f"{path}: row {i + 1} has {len(row)} fields, the header {width}")
    columns = {name: [row[j] if j < len(row) else "" for row in rows] for j, name in enumerate(names)}
    return names, columns


def float_column(strings: Sequence[str], where: str = "") -> np.ndarray:
    """float64 values of a column of strings; pandas' missing-value strings
    read as NaN, anything else that is not a number raises ``ValueError``."""
    cleaned = ["nan" if s in NA_STRINGS else s for s in strings]
    try:
        return np.asarray(cleaned, dtype=str).astype(np.float64)
    except ValueError as exc:
        raise ValueError(f"{where}: a value is not a number ({exc})") from None


def time_column(values, where: str) -> np.ndarray:
    """int64 ns of a column of timestamps: strings (a CSV's, or a parquet
    string column) or datetimes (parquet)."""
    if isinstance(values, list):
        return parse_times(values)
    values = np.asarray(values)
    if values.dtype.kind == "M":
        return values.astype("datetime64[ns]").astype(np.int64)
    if values.dtype.kind in "OU":
        return parse_times(values)
    raise ValueError(f"{where}: {values.dtype} is not a column of timestamps")
