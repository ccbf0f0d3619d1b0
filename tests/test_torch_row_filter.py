"""``row_filter`` and ``FileSystemProvider`` of the port against the JAX
package's, on the CPU: the cases of ``TestRowFilter``, ``test_row_filter``
and ``TestFileSystemProvider`` in ``tests/test_dataset.py``.

Each expression is evaluated by the port over numpy columns and by
``pandas_filter_rows`` over the same frame; the rows kept must be the same.
The traps are pandas' own: ``&`` and ``|`` bind below the comparisons,
comparisons chain, ``not`` and ``~`` negate, ``== [..]`` tests membership.
What the JAX package refuses (dunders, attribute access, calls other than
``abs``), the port refuses too.
"""

import numpy as np
import pandas as pd
import pytest

from gordo_components_torch.dataset import TimeSeriesDataset, normalize_sensor_tags
from gordo_components_torch.dataset.data_provider import FileSystemProvider, RandomDataProvider
from gordo_components_torch.dataset.data_provider.base import Series
from gordo_components_torch.dataset.filter_rows import filter_mask
from gordo_components_torch.dataset.sensor_tag import SensorTag
from gordo_components_torch.dataset.times import to_ns
from gordo_components_tpu.dataset import TimeSeriesDataset as JaxTimeSeriesDataset
from gordo_components_tpu.dataset import pandas_filter_rows
from gordo_components_tpu.dataset.data_provider import FileSystemProvider as JaxFileSystemProvider
from gordo_components_tpu.dataset.data_provider import RandomDataProvider as JaxRandomDataProvider
from gordo_components_tpu.dataset.sensor_tag import normalize_sensor_tags as jax_normalize

FRAME = pd.DataFrame({
    "a": [-3.5, 1.0, 2.0, 5.0, 0.5, np.inf],
    "b": [10.0, 20.0, 40.0, 2.0, 29.0, -1.0],
    "TAG-1": [1.0, -1.0, 3.0, 0.0, 2.5, 7.0],
    "TAG-2": [10.0, 200.0, 99.0, 100.0, -5.0, 1.0],
})


def port_rows(df, expr):
    mask = filter_mask({c: df[c].to_numpy() for c in df.columns}, expr, len(df))
    return df[mask]


@pytest.mark.parametrize("expr", [
    "a > 1 & b < 30",
    "a > 3 | b < 30 & a > 1",
    "(a > 3 | b < 30) & a > 1",
    "1 < a < 4",
    "1 < a <= 5 < b",
    "not a > 1",
    "~(a > 1)",
    "not (a > 1 | b > 20)",
    "abs(a) > 2",
    "a % 2 > 0.4",
    "a ** 2 > 4",
    "-a > 0",
    "+a >= 1",
    "a + b > 10",
    "a * 2 - b / 4 <= 0",
    "a == [1, 2]",
    "a != [1.0]",
    "a == 5",
    "`TAG-1` > 0 & `TAG-2` < 100",
    "`TAG-1` > 0 and `TAG-2` < 100 or a < 0",
    "`TAG-1` + `TAG-1` > `TAG-2` | `TAG-2` == 1",
    "abs(`TAG-1` - a) < 2",
])
def test_expression_keeps_the_rows_pandas_keeps(expr):
    want = pandas_filter_rows(FRAME, expr)
    got = port_rows(FRAME, expr)
    assert list(got.index) == list(want.index), expr
    assert 0 < len(want) < len(FRAME) or expr in ("a ** 2 > 4",)  # a filter that filters


class TestRowFilter:
    def test_filters(self):
        df = pd.DataFrame({"a": [1, 2, 3], "b": [10, 20, 30]})
        assert list(port_rows(df, "a > 1 & b < 30")["a"]) == [2] == list(pandas_filter_rows(df, "a > 1 & b < 30")["a"])

    @pytest.mark.parametrize("expr", [
        "__import__('os').system('true')",
        "a.real > 0",
        "max(a) > 0",
        "a[0] > 0",
        "(lambda: 1)() > 0",
        "[x for x in a]",
        "a if a else a",
        "a in [1]",
        "a > 0; b",
    ])
    def test_refuses_what_jax_refuses(self, expr):
        df = pd.DataFrame({"a": [1.0]})
        with pytest.raises(ValueError):
            pandas_filter_rows(df, expr)
        with pytest.raises(ValueError):
            port_rows(df, expr)

    def test_rejects_dunder(self):
        with pytest.raises(ValueError):
            port_rows(pd.DataFrame({"a": [1]}), "__import__('os').system('true')")

    def test_rejects_attribute_access(self):
        with pytest.raises(ValueError):
            port_rows(pd.DataFrame({"a": [1]}), "a.real > 0")

    def test_empty_filter_noop(self):
        df = pd.DataFrame({"a": [1]})
        assert port_rows(df, "").equals(df) and pandas_filter_rows(df, "").equals(df)
        assert filter_mask({"a": np.ones(3)}, "   ", 3).all()

    def test_backtick_names_with_digits(self):
        """Sensor-tag-shaped names (`TAG-1`) pass the check and evaluate."""
        df = pd.DataFrame({"TAG-1": [1.0, -1.0], "TAG-2": [10.0, 200.0]})
        assert len(port_rows(df, "`TAG-1` > 0 & `TAG-2` < 100")) == 1

    def test_unknown_name_and_non_boolean_results_raise(self):
        with pytest.raises(ValueError, match="no column"):
            filter_mask({"a": np.ones(2)}, "b > 0", 2)
        with pytest.raises(ValueError, match="one boolean a row"):
            filter_mask({"a": np.ones(2)}, "a + 1", 2)


def test_row_filter():
    kw = dict(train_start_date="2020-01-01T00:00:00Z", train_end_date="2020-01-02T00:00:00Z", tag_list=["a"],
              row_filter="`a` > 0")
    ds = TimeSeriesDataset(data_provider=RandomDataProvider(noise=0.0), **kw)
    jds = JaxTimeSeriesDataset(data_provider=JaxRandomDataProvider(noise=0.0), **kw)
    X, _ = ds.get_data()
    JX, _ = jds.get_data()
    assert (X.values[:, 0] > 0).all()
    np.testing.assert_array_equal(X.values, JX.to_numpy().astype(np.float32))
    np.testing.assert_array_equal(X.index.astype(np.int64), JX.index.as_unit("ns").asi8)
    got, want = ds.get_metadata(), jds.get_metadata()
    assert [got[k] for k in ("rows_after_dropna", "rows_after_filter")] == [
        want[k] for k in ("rows_after_dropna", "rows_after_filter")]


class _Ragged(RandomDataProvider):
    """Tag i starts 20 i samples late, so the join has NaN rows to drop first."""

    def load_series(self, from_ns, to_ns, tag_list, dry_run=False):
        for i, s in enumerate(super().load_series(from_ns, to_ns, tag_list, dry_run)):
            yield Series(s.name, s.index[20 * i:], s.values[20 * i:])


def test_row_filter_runs_after_the_nan_drop():
    ds = TimeSeriesDataset("2020-01-01T00:00:00Z", "2020-01-01T12:00:00Z", ["a", "b", "c"],
                           data_provider=_Ragged(), resolution="10min", row_filter="b < c & a > -1")
    X, _ = ds.get_data()
    md = ds.get_metadata()
    assert md["rows_joined"] > md["rows_after_dropna"] > md["rows_after_filter"] == len(X) > 0
    a, b, c = X.values.T
    assert ((b < c) & (a > -1)).all()


class TestFileSystemProvider:
    def test_csv_roundtrip(self, tmp_path):
        idx = pd.date_range("2020-01-01", periods=50, freq="1min", tz="UTC")
        pd.DataFrame({"ts": idx, "value": np.arange(50.0)}).to_csv(tmp_path / "mytag.csv", index=False)
        provider = FileSystemProvider(str(tmp_path))
        tags = normalize_sensor_tags(["mytag"])
        assert provider.can_handle_tag(tags[0])
        (series,) = list(provider.load_series(int(idx[0].value), int(idx[-1].value), tags))
        (want,) = list(JaxFileSystemProvider(str(tmp_path)).load_series(idx[0], idx[-1], jax_normalize(["mytag"])))
        assert series.index.size == 49 and series.name == "mytag"  # end-exclusive
        np.testing.assert_array_equal(series.index, want.index.as_unit("ns").asi8)
        np.testing.assert_array_equal(series.values, want.to_numpy(np.float64))

    def test_missing_tag(self, tmp_path):
        provider = FileSystemProvider(str(tmp_path))
        assert not provider.can_handle_tag(SensorTag("ghost"))
        with pytest.raises(FileNotFoundError):
            list(provider.load_series(0, 1, [SensorTag("ghost")]))

    def test_asset_directory_of_csv_and_parquet_files(self, tmp_path):
        """``<base>/<asset>/<tag>/`` of yearly files, parquet and CSV, out of
        order and with a missing value: the same series as the JAX provider."""
        d = tmp_path / "plant" / "T"
        d.mkdir(parents=True)
        idx = pd.date_range("2020-12-31T20:00:00", periods=8, freq="1h", tz="UTC")
        pd.DataFrame({"time": idx[4:], "v": [4.0, 5.0, np.nan, 7.0]}).to_parquet(d / "2021.parquet", index=False)
        pd.DataFrame({"time": idx[:4][::-1], "v": [3.0, 2.0, 1.0, 0.0]}).to_csv(d / "2020.csv", index=False)
        tag = [SensorTag("T", "plant")]
        (series,) = FileSystemProvider(str(tmp_path)).load_series(to_ns("2020-01-01"), to_ns("2022-01-01"), tag)
        (want,) = JaxFileSystemProvider(str(tmp_path)).load_series(
            pd.Timestamp("2020-01-01", tz="UTC"), pd.Timestamp("2022-01-01", tz="UTC"), jax_normalize([("T", "plant")]))
        np.testing.assert_array_equal(series.index, want.index.as_unit("ns").asi8)
        np.testing.assert_array_equal(series.values, want.to_numpy(np.float64))
        assert np.isnan(series.values[6]) and list(series.values[:4]) == [0.0, 1.0, 2.0, 3.0]
