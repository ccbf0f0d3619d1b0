#!/usr/bin/env python3
"""Write the parquet POST bodies committed under ``examples/parquet/``.

    python tools/make_parquet_fixtures.py [OUT_DIR]

The rows are the first 48 of 2021 that the JAX package's
``TimeSeriesDataset.get_data()`` gives for GRA-T1, GRA-T2 and GRA-P1 of the
in-repo lake (``examples/datalake``, asset-a), with their tz-aware index.
The JAX client's own encoder (``Client._encode_parquet``) writes them:

- ``post_body.parquet``: the rows as float32, the dtype a client holds
  after ``get_data()`` in the port;
- ``post_body_y.parquet``: the rows as float64 with a target frame of the
  same rows rounded to 0.1, under the ``__y__`` prefix the server splits
  back out;
- ``post_body_10tags.parquet``: 64 rows of 10 tags (``tag-0`` ..
  ``tag-9``, float32, uniform on [0, 1) from seed 14) at 10 minutes from
  2020-01-01, the width of BASELINE config 1: what ``chip_smoke.py``'s
  ``observe`` phase posts to its 10-tag models.

The card's machine cannot write parquet (it has no pyarrow), so
``chip_smoke.py`` posts these files as they are committed. This script
needs the JAX package, pandas and pyarrow.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TAGS = [["GRA-T1", "asset-a"], ["GRA-T2", "asset-a"], ["GRA-P1", "asset-a"]]
ROWS = 48


def rows():
    """The first ``ROWS`` rows of 2021 of the lake-parquet machine's data."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from gordo_components_tpu.dataset import get_dataset

    X, _ = get_dataset({
        "type": "TimeSeriesDataset", "train_start_date": "2021-01-01T00:00:00Z",
        "train_end_date": "2021-01-18T00:00:00Z", "tag_list": TAGS,
        "data_provider": {"type": "DataLakeProvider", "store_path": os.path.join(ROOT, "examples", "datalake")},
    }).get_data()
    return X.iloc[:ROWS]


def ten_tag_rows():
    """64 rows of 10 seeded tags with a tz-aware 10-minute index."""
    import pandas as pd

    values = np.random.default_rng(14).random((64, 10)).astype(np.float32)
    index = pd.date_range("2020-01-01", periods=64, freq="10min", tz="UTC")
    return pd.DataFrame(values, columns=[f"tag-{i}" for i in range(10)], index=index)


def main(argv=None) -> int:
    from gordo_components_tpu.client.client import Client

    out = (argv or sys.argv[1:] or [os.path.join(ROOT, "examples", "parquet")])[0]
    os.makedirs(out, exist_ok=True)
    X = rows()
    bodies = {
        "post_body.parquet": Client._encode_parquet(X.astype(np.float32), None),
        "post_body_y.parquet": Client._encode_parquet(X.astype(np.float64), X.astype(np.float64).round(1)),
        "post_body_10tags.parquet": Client._encode_parquet(ten_tag_rows(), None),
    }
    for name, raw in bodies.items():
        with open(os.path.join(out, name), "wb") as f:
            f.write(raw)
        print(os.path.join(out, name), len(raw))
    return 0


if __name__ == "__main__":
    sys.exit(main())
