#!/usr/bin/env python3
"""Time the port's parquet reader on a year of 1-minute data.

    python tools/time_parquet_read.py [--runs N] [--row-group-size R]

Writes, with pandas and pyarrow, one lake-style file to a temporary
directory: 525,600 rows (2021 at 1 minute, a tz-aware index) of one sensor
quantised to 0.01 (about a thousand distinct values) with 0.1 % nulls,
snappy-compressed in row groups of ``R`` rows (default 100,000). Then
reads it ``N`` times (default 5) with the port's reader
(``gordo_components_torch.dataset.data_provider._parquet.read_parquet``)
and with ``pyarrow.parquet.read_table`` plus ``to_numpy``, checks the two
agree bitwise, and prints one JSON line: the file's bytes, row groups, the
least and median seconds of each reader, and the host's CPU and Python.

It needs pandas and pyarrow to write the file, so it runs where they are
installed; its times are that host CPU's.
"""

import argparse
import json
import os
import platform
import statistics
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gordo_components_torch.dataset.data_provider._parquet import read_parquet  # noqa: E402


def year_frame(seed: int = 0):
    import pandas as pd

    n = 525_600
    rng = np.random.RandomState(seed)
    values = np.round(np.sin(np.arange(n) / 500.0) * 5 + rng.randn(n) * 0.3, 2)
    values[rng.rand(n) < 0.001] = np.nan
    return pd.DataFrame({"Value": values}, index=pd.date_range("2021-01-01", periods=n, freq="1min", tz="UTC"))


def timed(fn, runs: int):
    seconds, result = [], None
    for _ in range(runs):
        t0 = time.perf_counter()
        result = fn()
        seconds.append(time.perf_counter() - t0)
    return result, seconds


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--row-group-size", type=int, default=100_000)
    args = parser.parse_args(argv)
    import pyarrow.parquet as pq

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "TAG_2021.parquet")
        year_frame().to_parquet(path, engine="pyarrow", row_group_size=args.row_group_size)
        (index, _, columns), ours = timed(lambda: read_parquet(path), args.runs)

        def by_pyarrow():
            table = pq.read_table(path)
            return (table.column("__index_level_0__").to_numpy().astype("datetime64[ns]").view(np.int64),
                    table.column("Value").to_numpy())

        (want_index, want_values), theirs = timed(by_pyarrow, args.runs)
        if not (np.array_equal(index, want_index)
                and np.array_equal(columns["Value"].view(np.uint64), want_values.view(np.uint64))):
            raise SystemExit("the port's reader and pyarrow disagree")
        report = {
            "rows": int(len(index)), "bytes": os.path.getsize(path),
            "row_groups": pq.ParquetFile(path).metadata.num_row_groups,
            "port_min_s": min(ours), "port_median_s": statistics.median(ours),
            "pyarrow_min_s": min(theirs), "pyarrow_median_s": statistics.median(theirs),
            "runs": args.runs, "host": {"cpu": platform.processor() or platform.machine(),
                                        "cores": os.cpu_count(), "python": platform.python_version()},
        }
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
