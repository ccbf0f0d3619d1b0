"""The port's resampling beyond the fused path against the JAX package's
pandas path (``join_timeseries(..., fast=False)``), on the CPU.

A seeded fuzz of tag lists (float32, float64, int64 and int32 series, NaN
samples, tags whose first samples fall on different days, a tag with no
sample in the window and one with none at all) at resolutions that do not
divide a day (``7min``, ``13h``, ``2D``, ``25h``), weekly anchors (``W``,
``W-MON`` ... ``W-SUN``) and ones that do (``10min``, ``1h``), through every
aggregation the port resamples with. Where the port takes its fused path
(``mean``, ``sum``, ``min`` and ``max`` of floats at a resolution dividing
a day) the reference is the JAX fused path (``fast=True``), else pandas.

Band, each aggregation: bitwise (values, NaN positions, dtypes, the joined
index and the row metadata). The port follows pandas' group kernels
step by step (Kahan sums and means, Welford variances, in the dtypes pandas
computes in), so no aggregation needs a tolerance.
"""

import numpy as np
import pandas as pd
import pytest

from gordo_components_torch.dataset import RandomDataset
from gordo_components_torch.dataset.data_provider.base import Series
from gordo_components_torch.dataset.resample import AGGREGATIONS, fused_agg_join
from gordo_components_torch.dataset.times import parse_resolution, to_ns
from gordo_components_tpu.dataset import RandomDataset as JaxRandomDataset
from gordo_components_tpu.dataset.datasets import join_timeseries

START, END = "2020-01-01T00:00:00Z", "2020-02-15T00:00:00Z"
ODD = ("7min", "13h", "2D", "25h")
WEEKLY = ("W", "W-MON", "W-TUE", "W-WED", "W-THU", "W-FRI", "W-SAT", "W-SUN")
DAY_GRID = ("10min", "1h")
SPAN_S = {"7min": 2 * 86400, "10min": 3 * 86400, "1h": 6 * 86400, "13h": 20 * 86400, "2D": 40 * 86400,
          "25h": 20 * 86400}
# ULP band of each aggregation against the reference: all bitwise
BAND_ULP = {agg: 0 for agg in AGGREGATIONS}


def _series(rng, res):
    start_ns = to_ns(START)
    span = SPAN_S.get(res, 44 * 86400)
    out = []
    for i in range(rng.randint(1, 5)):
        dtype = rng.choice(["float32", "float64", "int64", "int32"])
        n = rng.randint(1, 300)
        # tags start on different days, some before the window
        first = start_ns + int(rng.randint(-86400, 86400 * 3)) * 10**9
        ts = first + rng.randint(0, span, n).astype(np.int64) * 10**9
        if rng.rand() < 0.3:
            ts = ts // 60_000_000_000 * 60_000_000_000  # duplicate minute stamps
        if dtype.startswith("int"):
            values = rng.randint(-50, 50, n).astype(dtype)
        else:
            values = (rng.randn(n) * 10 ** rng.uniform(-2, 3) + rng.choice([0.0, 7.0, 1e3])).astype(dtype)
            values[rng.rand(n) < 0.15] = np.nan
        out.append((f"t{i}", np.sort(ts), values))
    kind = rng.rand()
    if kind < 0.1:  # samples, none in the window
        out.append(("late", np.array([to_ns(END) + 10**9]), np.array([1.0], "float32")))
    elif kind < 0.2:  # no samples at all
        out.append(("none", np.empty(0, np.int64), np.empty(0, np.float64)))
    return out


def _check(tags, res, agg):
    start, end = pd.Timestamp(START), pd.Timestamp(END)
    frames = [pd.Series(v, index=pd.DatetimeIndex(ts, tz="UTC"), name=n) for n, ts, v in tags]
    parsed = parse_resolution(res)
    fused = res in DAY_GRID and agg in ("mean", "sum", "min", "max")
    want, want_meta = join_timeseries(frames, start, end, res, agg, fast=fused)
    index, cols, meta = fused_agg_join([Series(n, ts, v) for n, ts, v in tags], to_ns(START), to_ns(END),
                                       parsed, agg)
    assert meta == want_meta
    np.testing.assert_array_equal(index, want.index.as_unit("ns").asi8)
    for name in want.columns:
        got, ref = cols[name], want[name].to_numpy()
        assert got.dtype == ref.dtype, (name, got.dtype, ref.dtype)
        if got.dtype.kind == "f":
            assert np.array_equal(np.isnan(got), np.isnan(ref)), name
            differ = ~np.isnan(ref) & (got != ref)
            assert np.isfinite(ref[differ]).all(), name  # an infinity is matched exactly
            ulps = (np.abs(got[differ].astype(np.float64) - ref[differ])
                    / np.spacing(np.abs(ref[differ])).astype(np.float64))
            assert ulps.size == 0 or ulps.max() <= BAND_ULP[agg], (name, ulps.max())
        else:
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("agg", AGGREGATIONS)
def test_resampling_matches_pandas_over_a_seeded_fuzz(agg):
    rng = np.random.RandomState(AGGREGATIONS.index(agg))
    for res in ODD + WEEKLY + DAY_GRID:
        for _ in range(2):
            _check(_series(rng, res), res, agg)


@pytest.mark.parametrize("res", ["7min", "W-MON"])
def test_a_dataset_at_an_odd_resolution_matches_jax(res):
    kw = dict(train_start_date="2020-01-01T00:00:00Z", train_end_date="2020-01-29T00:00:00Z",
              tag_list=["a", "b", "c"], resolution=res, aggregation_method="median")
    X, _ = RandomDataset(**kw).get_data()
    JX, _ = JaxRandomDataset(**kw).get_data()
    np.testing.assert_array_equal(X.values, JX.values.astype(np.float32))
    np.testing.assert_array_equal(X.index, JX.index.tz_convert(None).values.astype("datetime64[ns]"))
    assert len(X.index) > 3


@pytest.mark.parametrize("res, agg, match", [
    ("10min", "ohlc", "aggregation 'ohlc'"),
    ("10min", np.mean, "aggregation"),
    ("ME", "mean", "calendar offsets"),
    ("QS", "mean", "calendar offsets"),
    ("B", "mean", "calendar offsets"),
    ("2W", "mean", "one-week anchors"),
])
def test_what_stays_refused_is_named(res, agg, match):
    with pytest.raises(NotImplementedError, match=match):
        fused_agg_join([], 0, 1, parse_resolution(res), agg)
