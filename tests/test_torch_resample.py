"""The port's resampling beyond the fused path against the JAX package's
pandas path (``join_timeseries(..., fast=False)``), on the CPU.

Calendar offsets (``ME``, ``MS``, ``QE``, ``QS`` and ``YE``, ``YS`` with
their anchors, ``B``, multiples of each and of anchored weeks) are fuzzed
crossed with every aggregation over tags whose spans cross month, quarter
and year ends, 2020-02-29 and weekends, and held through ``RandomDataset``
and ``TimeSeriesDataset`` against the JAX package's, bitwise. The
aliases pandas retired (``M``, ``A`` ...) raise ``ValueError`` in both,
the calendar offsets the port does not resample at raise
``NotImplementedError`` naming them, and ``ohlc`` is refused by both
(the JAX join raises ``KeyError``: a documented divergence).

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


def _check(tags, res, agg, start=START, end=END):
    start_ns, end_ns = to_ns(start), to_ns(end)
    start, end = pd.Timestamp(start), pd.Timestamp(end)
    frames = [pd.Series(v, index=pd.DatetimeIndex(ts, tz="UTC"), name=n) for n, ts, v in tags]
    parsed = parse_resolution(res)
    fused = res in DAY_GRID and agg in ("mean", "sum", "min", "max")
    want, want_meta = join_timeseries(frames, start, end, res, agg, fast=fused)
    index, cols, meta = fused_agg_join([Series(n, ts, v) for n, ts, v in tags], start_ns, end_ns, parsed, agg)
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
])
def test_what_stays_refused_is_named(res, agg, match):
    with pytest.raises(NotImplementedError, match=match):
        fused_agg_join([], 0, 1, parse_resolution(res), agg)


# ---------------------------------------------------------------------- #
# calendar offsets: months, quarters, years, business days, multi-week
# ---------------------------------------------------------------------- #

CALENDAR = ("ME", "2ME", "MS", "3MS", "QE", "QE-NOV", "2QE-FEB", "QS", "QS-JUL", "YE", "YE-JUN", "YS", "YS-JUL",
            "2YS", "B", "3B", "2W", "2W-MON", "3W-FRI")
# each tag's samples: (first day, span in days); the spans cross month ends,
# quarter and year ends, 2020-02-29 and weekends, and tags start apart
CAL_SPANS = (("2019-11-27T06:00:00Z", 190), ("2020-02-22T00:00:00Z", 12), ("2019-12-28T13:00:00Z", 9),
             ("2020-03-31T23:00:00Z", 400), ("2020-02-29T00:00:00Z", 3))


def _calendar_series(rng):
    out = []
    for i in range(rng.randint(2, 5)):
        first, days = CAL_SPANS[rng.randint(len(CAL_SPANS))]
        dtype = rng.choice(["float32", "float64", "int64", "int32"])
        n = rng.randint(1, 300)
        ts = to_ns(first) + rng.randint(0, days * 86400, n).astype(np.int64) * 10**9
        if dtype.startswith("int"):
            values = rng.randint(-50, 50, n).astype(dtype)
        else:
            values = (rng.randn(n) * 10 ** rng.uniform(-2, 3) + rng.choice([0.0, 7.0])).astype(dtype)
            values[rng.rand(n) < 0.15] = np.nan
        out.append((f"t{i}", np.sort(ts), values))
    return out


@pytest.mark.parametrize("res", CALENDAR)
@pytest.mark.parametrize("agg", AGGREGATIONS)
def test_calendar_resampling_matches_pandas(res, agg):
    rng = np.random.RandomState(CALENDAR.index(res) * 100 + AGGREGATIONS.index(agg))
    for _ in range(2):
        _check(_calendar_series(rng), res, agg, start="2019-06-01T00:00:00Z", end="2021-06-01T00:00:00Z")


CAL_DATASET = dict(train_start_date="2020-01-01T00:00:00Z", train_end_date="2020-03-29T00:00:00Z",
                   tag_list=["a", "b", "c"])


def _same_frames(X, JX):
    np.testing.assert_array_equal(X.values, JX.values.astype(np.float32))
    np.testing.assert_array_equal(X.index, JX.index.tz_convert(None).values.astype("datetime64[ns]"))


@pytest.mark.parametrize("res, agg", [("ME", "mean"), ("MS", "max"), ("2ME", "sum"), ("QE-NOV", "median"),
                                      ("QS", "last"), ("YE", "count"), ("YS-JUL", "first"), ("B", "std"),
                                      ("3B", "min"), ("2W", "mean"), ("2W-MON", "var"),
                                      # pandas' deprecated lower-case spellings, which it still reads
                                      ("b", "mean"), ("w-mon", "max"), ("2w", "sum")])
@pytest.mark.parametrize("kind", ["RandomDataset", "TimeSeriesDataset"])
def test_a_dataset_at_a_calendar_resolution_matches_jax(kind, res, agg):
    from gordo_components_torch.dataset import TimeSeriesDataset
    from gordo_components_tpu.dataset import TimeSeriesDataset as JaxTimeSeriesDataset

    port_cls, jax_cls = ((RandomDataset, JaxRandomDataset) if kind == "RandomDataset"
                         else (TimeSeriesDataset, JaxTimeSeriesDataset))
    kw = dict(CAL_DATASET, resolution=res, aggregation_method=agg)
    X, _ = port_cls(**kw).get_data()
    JX, _ = jax_cls(**kw).get_data()
    _same_frames(X, JX)
    assert len(X.index) >= 1


@pytest.mark.parametrize("res, rows, first", [("ME", 3, "2020-01-31"), ("QS", 1, "2020-01-01"),
                                              ("B", 63, "2020-01-01"), ("2W", 7, "2020-01-05")])
def test_once_refused_calendar_cases_match_jax(res, rows, first):
    """The cases this file once held refused (``ME``, ``QS``, ``B``, ``2W``),
    now resampled as the JAX package does."""
    X, _ = RandomDataset(**CAL_DATASET, resolution=res).get_data()
    JX, _ = JaxRandomDataset(**CAL_DATASET, resolution=res).get_data()
    _same_frames(X, JX)
    assert len(X.index) == rows and str(X.index[0])[:10] == first


@pytest.mark.parametrize("alias", ["M", "Q", "Y", "A", "AS", "BA", "BM", "SM", "Q-NOV", "A-JUN", "0ME", "QE-XYZ",
                                   "MS-JAN", "BH", "me", "2X"])
def test_aliases_pandas_refuses_are_refused_in_both(alias):
    """pandas in the JAX package's environment retired ``M``, ``Q``, ``Y``,
    ``A`` and their kin: both packages refuse them with ``ValueError``."""
    with pytest.raises(ValueError):
        JaxRandomDataset(**CAL_DATASET, resolution=alias).get_data()
    with pytest.raises(ValueError):
        RandomDataset(**CAL_DATASET, resolution=alias).get_data()


@pytest.mark.parametrize("alias", ["SME", "SMS", "BME", "BMS", "BQE", "BQS", "BYE", "BYS", "C", "CBME", "bh"])
def test_calendar_offsets_not_ported_are_named(alias):
    JaxRandomDataset(**CAL_DATASET, resolution=alias).get_data()  # the JAX package resamples at them
    with pytest.raises(NotImplementedError, match="not resampled by the port"):
        parse_resolution(alias)


def test_ohlc_is_refused_by_both_packages():
    """A documented divergence of the reference: the JAX package's join
    cannot take the four columns ``ohlc`` makes of each tag
    (``KeyError``), and the port names the aggregation it refuses."""
    kw = dict(CAL_DATASET, resolution="1D", aggregation_method="ohlc")
    with pytest.raises(KeyError):
        JaxRandomDataset(**kw).get_data()
    with pytest.raises(NotImplementedError, match="aggregation 'ohlc'"):
        RandomDataset(**kw).get_data()


# ---------------------------------------------------------------------- #
# a fixed step's spellings: each read as the JAX package reads it
# ---------------------------------------------------------------------- #

# pd.Timedelta reads a count and a unit in any case (the JAX package's fused
# path: mean, sum, min, max at a step dividing a day); pandas' offsets read
# `h`, `s`, `ms`, `D`, and `min`, `us`, `ns` in any case (its resample path)
SPELLINGS = ("h", "D", "d", "min", "MIN", "10MIN", "1H", "10S", "1sec", "2 min", "01h", "3hours", "1Day", "90s",
             "H", "S", "sec", "T", "10T", "Min", "2d", "25h")


@pytest.mark.parametrize("agg", ["mean", "sum", "median"])
@pytest.mark.parametrize("res", SPELLINGS)
def test_fixed_step_spellings_resample_as_jax(res, agg):
    """``h`` and ``D`` without a count are not ``pd.Timedelta``s: the JAX
    package resamples them on its pandas path (Kahan sums), and so does the
    port, bitwise; ``1H`` is read by ``pd.Timedelta`` alone: the fused
    aggregations take it, the others refuse it in both packages."""
    rng = np.random.RandomState(SPELLINGS.index(res))
    start_ns = to_ns("2020-01-01T00:00:00Z")
    tags = []
    for i, dtype in enumerate(("float32", "float64")):
        ts = np.sort(start_ns + rng.randint(0, 2 * 86400, 400).astype(np.int64) * 10**9)
        tags.append((f"t{i}", ts, (rng.randn(400) * 100).astype(dtype)))
    frames = [pd.Series(v, index=pd.DatetimeIndex(ts, tz="UTC"), name=n) for n, ts, v in tags]
    start, end = pd.Timestamp("2020-01-01T00:00:00Z"), pd.Timestamp("2020-01-03T00:00:00Z")
    try:
        want, want_meta = join_timeseries(frames, start, end, res, agg)
    except ValueError:
        with pytest.raises(ValueError):
            fused_agg_join([Series(n, ts, v) for n, ts, v in tags], start_ns, to_ns("2020-01-03T00:00:00Z"),
                           parse_resolution(res), agg)
        return
    index, cols, meta = fused_agg_join([Series(n, ts, v) for n, ts, v in tags], start_ns,
                                       to_ns("2020-01-03T00:00:00Z"), parse_resolution(res), agg)
    assert meta == want_meta
    np.testing.assert_array_equal(index, want.index.as_unit("ns").asi8)
    for name in want.columns:
        got, ref = cols[name], want[name].to_numpy()
        assert got.dtype == ref.dtype and np.array_equal(got, ref, equal_nan=True), name


@pytest.mark.parametrize("res", ["h", "D"])
def test_a_dataset_at_a_count_less_step_matches_jax(res):
    """The fault these spellings showed: the port took its fused path for
    ``h`` and ``D`` where the JAX package resamples through pandas, and the
    means differed in the last bit."""
    kw = dict(CAL_DATASET, train_end_date="2020-01-20T00:00:00Z", resolution=res, aggregation_method="mean")
    X, _ = RandomDataset(**kw).get_data()
    JX, _ = JaxRandomDataset(**kw).get_data()
    _same_frames(X, JX)
