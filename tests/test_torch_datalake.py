"""The port's data-lake providers against the JAX package's, on the CPU.

The cases of ``tests/test_datalake.py`` run against
``gordo_components_torch.dataset.data_provider`` over the in-repo lake
(``examples/datalake``: 2020 as CSV, 2021 as parquet, which the port reads
with its own reader), and wherever both packages read the same files the numbers must be
the same: each series' index in ns equal to pandas', its values bitwise in
float64, and ``TimeSeriesDataset.get_data()`` bitwise in float32 with the
same index, tag names and ``rows_*`` metadata. The timestamp parser the
readers share (``dataset.times``) is held to pandas' nanoseconds. The
slice end to end: the README's lake build through the port's CLI on the
CPU, loaded back and scored (the JAX package's
``test_cli_build_from_sample_tree``; no JAX model is built here).
"""

import json
import os

import numpy as np
import pandas as pd
import pytest

from gordo_components_torch import serializer
from gordo_components_torch.cli import main
from gordo_components_torch.dataset import get_dataset
from gordo_components_torch.dataset.data_provider import DataLakeProvider, IrocReader, NcsReader
from gordo_components_torch.dataset.sensor_tag import SensorTag
from gordo_components_torch.dataset.times import isoformat, parse_times, to_ns
from gordo_components_tpu.dataset import get_dataset as jax_get_dataset
from gordo_components_tpu.dataset.data_provider import DataLakeProvider as JaxDataLakeProvider
from gordo_components_tpu.dataset.data_provider import IrocReader as JaxIrocReader
from gordo_components_tpu.dataset.data_provider import NcsReader as JaxNcsReader
from gordo_components_tpu.dataset.sensor_tag import SensorTag as JaxSensorTag

LAKE = os.path.join(os.path.dirname(__file__), "..", "examples", "datalake")
README_TAGS = [["GRA-T1", "asset-a"], ["IROC-A", "asset-b"]]


def _year(series) -> set:
    return set(series.index.astype("datetime64[ns]").astype("datetime64[Y]").astype(int) + 1970)


def assert_same_series(ours, theirs):
    """index ns as pandas' (its own unit converted), values bitwise in float64."""
    assert ours.name == theirs.name
    if theirs.empty:
        assert ours.index.size == ours.values.size == 0
        return
    np.testing.assert_array_equal(ours.index, theirs.index.as_unit("ns").asi8)
    assert ours.values.dtype == np.float64
    np.testing.assert_array_equal(ours.values, theirs.to_numpy(np.float64))


def both(port_reader, jax_reader, start, end, tags):
    ours = list(port_reader.load_series(to_ns(start), to_ns(end), [SensorTag(*t) for t in tags]))
    theirs = list(jax_reader.load_series(pd.Timestamp(start, tz="UTC"), pd.Timestamp(end, tz="UTC"),
                                         [JaxSensorTag(*t) for t in tags]))
    assert len(ours) == len(theirs) == len(tags)
    for a, b in zip(ours, theirs):
        assert_same_series(a, b)
    return ours


class TestNcsReader:
    def test_reads_across_year_boundary_and_formats(self):
        """2020 is CSV, 2021 is parquet: one series spanning both."""
        (series,) = both(NcsReader(LAKE), JaxNcsReader(LAKE), "2020-01-01", "2021-02-01",
                         [("GRA-T1", "asset-a")])
        assert _year(series) == {2020, 2021}
        assert (np.diff(series.index) > 0).all() and np.isfinite(series.values).all()

    def test_range_filtering(self):
        (series,) = both(NcsReader(LAKE), JaxNcsReader(LAKE), "2020-01-05", "2020-01-10",
                         [("GRA-T1", "asset-a")])
        assert series.index.min() >= to_ns("2020-01-05") and series.index.max() < to_ns("2020-01-10")
        assert series.index.size == 5 * 24  # hourly sample data

    def test_missing_year_is_skipped_not_fatal(self):
        (series,) = both(NcsReader(LAKE), JaxNcsReader(LAKE), "2021-01-01", "2022-12-31",
                         [("GRA-T1", "asset-a")])
        assert series.index.size > 0 and _year(series) == {2021}

    def test_unknown_tag_raises(self):
        with pytest.raises(FileNotFoundError):
            list(NcsReader(LAKE).load_series(to_ns("2020-01-01"), to_ns("2020-02-01"),
                                             [SensorTag("NOPE", "asset-a")]))

    def test_can_handle_tag(self):
        reader = NcsReader(LAKE)
        assert reader.can_handle_tag(SensorTag("GRA-T1", "asset-a"))
        assert not reader.can_handle_tag(SensorTag("GRA-T1", "asset-b"))
        assert not reader.can_handle_tag(SensorTag("NOPE", "asset-a"))


class TestIrocReader:
    def test_multi_tag_facility_dump(self):
        a, b = both(IrocReader(LAKE), JaxIrocReader(LAKE), "2020-01-01", "2020-02-01",
                    [("IROC-A", "asset-b"), ("IROC-B", "asset-b")])
        assert a.name == "IROC-A" and b.name == "IROC-B"
        assert a.index.size > 0 and b.index.size > 0
        assert not np.array_equal(a.values, b.values)

    def test_tag_missing_from_dump_yields_empty(self):
        (s,) = both(IrocReader(LAKE), JaxIrocReader(LAKE), "2020-01-01", "2020-02-01",
                    [("GHOST", "asset-b")])
        assert s.index.size == 0

    def test_reads_each_file_once_and_lists_each_directory_once(self, monkeypatch):
        from gordo_components_torch.dataset.data_provider import datalake

        reads, globs = [], []
        read_csv, glob = datalake.read_csv, datalake.glob.glob
        monkeypatch.setattr(datalake, "read_csv", lambda path, **kw: reads.append(path) or read_csv(path, **kw))
        monkeypatch.setattr(datalake.glob, "glob", lambda pattern: globs.append(pattern) or glob(pattern))
        list(IrocReader(LAKE).load_series(to_ns("2020-01-01"), to_ns("2020-02-01"),
                                          [SensorTag("IROC-A", "asset-b"), SensorTag("IROC-B", "asset-b")]))
        assert len(reads) == len(set(reads)) == 1 and len(globs) == 1


class TestDataLakeProvider:
    def test_dispatches_across_readers(self):
        """NCS and IROC tags in ONE tag list, series in caller order."""
        out = both(DataLakeProvider(store_path=LAKE), JaxDataLakeProvider(store_path=LAKE),
                   "2020-01-01", "2020-02-01",
                   [("IROC-A", "asset-b"), ("GRA-T1", "asset-a"), ("IROC-B", "asset-b")])
        assert [s.name for s in out] == ["IROC-A", "GRA-T1", "IROC-B"]

    def test_unhandleable_tag_raises(self):
        with pytest.raises(FileNotFoundError):
            list(DataLakeProvider(store_path=LAKE).load_series(
                to_ns("2020-01-01"), to_ns("2020-02-01"), [SensorTag("X", "no-asset")]))

    def test_auth_kwargs_accepted_and_recorded(self):
        kw = dict(store_path=LAKE, interactive=True, dl_service_auth_str="tenant:spid:spkey")
        d, jd = DataLakeProvider(**kw).to_dict(), JaxDataLakeProvider(**kw).to_dict()
        assert d["store_path"] == LAKE and d["interactive"] is True
        assert {k: v for k, v in d.items() if k != "type"} == {k: v for k, v in jd.items() if k != "type"}
        assert d["type"] == "gordo_components_torch.dataset.data_provider.datalake.DataLakeProvider"

    def test_timeseries_dataset_end_to_end(self):
        ds = get_dataset({
            "type": "TimeSeriesDataset",
            "train_start_date": "2020-01-01T00:00:00Z",
            "train_end_date": "2020-01-14T00:00:00Z",
            "tag_list": [["GRA-T1", "asset-a"], ["GRA-T2", "asset-a"], ["IROC-A", "asset-b"]],
            "data_provider": {"type": "DataLakeProvider", "store_path": LAKE},
        })
        X, y = ds.get_data()
        assert X.columns == ["GRA-T1", "GRA-T2", "IROC-A"] and len(X) > 100 and y is None
        assert "DataLakeProvider" in ds.get_metadata()["data_provider"]["type"]


def _lake_config(tags, end, **kw):
    return {"type": "TimeSeriesDataset", "train_start_date": "2020-01-01T00:00:00Z",
            "train_end_date": end, "tag_list": tags,
            "data_provider": {"type": "gordo_components_tpu.dataset.data_provider.datalake.DataLakeProvider",
                              "store_path": LAKE}, **kw}


@pytest.mark.parametrize("config", [
    _lake_config([["GRA-T1", "asset-a"], ["GRA-T2", "asset-a"], ["IROC-A", "asset-b"]], "2020-01-14T00:00:00Z"),
    _lake_config(README_TAGS, "2020-01-10T00:00:00Z"),
    _lake_config([["GRA-T1", "asset-a"], ["GRA-P1", "asset-a"], ["IROC-B", "asset-b"]], "2021-01-20T00:00:00Z",
                 target_tag_list=[["GRA-P1", "asset-a"]], resolution="1h"),
    _lake_config([["GRA-T1", "asset-a"], ["GRA-T2", "asset-a"], ["GRA-P1", "asset-a"], ["IROC-A", "asset-b"],
                  ["IROC-B", "asset-b"]], "2020-01-17T00:00:00Z", row_filter="`GRA-T1` > 0.1 | `IROC-B` > 1"),
], ids=["test_datalake", "readme", "parquet-targets", "row_filter"])
def test_get_data_matches_jax_bitwise(config):
    ours, theirs = get_dataset(config), jax_get_dataset(config)
    X, y = ours.get_data()
    JX, Jy = theirs.get_data()
    assert X.values.dtype == np.float32 and X.values.shape == JX.shape
    np.testing.assert_array_equal(X.values, JX.to_numpy().astype(np.float32))
    np.testing.assert_array_equal(X.index.astype(np.int64), JX.index.as_unit("ns").asi8)
    assert X.columns == list(JX.columns)
    if Jy is None:
        assert y is None
    else:
        np.testing.assert_array_equal(y.values, Jy.to_numpy().astype(np.float32))
        assert y.columns == list(Jy.columns)
    got, want = ours.get_metadata(), theirs.get_metadata()
    for key in ("rows_joined", "rows_after_dropna", "rows_after_filter", "tag_loading", "tag_list",
                "train_start_date", "train_end_date", "row_filter"):
        assert got[key] == want[key], key
    if config.get("row_filter"):
        assert 0 < got["rows_after_filter"] < got["rows_after_dropna"]


def test_cli_build_from_sample_tree(tmp_path):
    """The README's lake machine built through the port's CLI on the CPU,
    loaded back and scored."""
    data_config = _lake_config(README_TAGS, "2020-01-10T00:00:00Z")
    data_config["data_provider"]["type"] = "DataLakeProvider"
    model_config = {"gordo_components_tpu.models.DiffBasedAnomalyDetector": {
        "base_estimator": {"gordo_components_tpu.models.AutoEncoder": {"epochs": 2, "batch_size": 64}}}}
    out = tmp_path / "out"
    assert main(["--device", "cpu", "build", "--name", "lake-machine", "--model-config",
                 json.dumps(model_config), "--data-config", json.dumps(data_config),
                 "--output-dir", str(out)]) == 0
    model = serializer.load(str(out), device="cpu")
    md = serializer.load_metadata(str(out))
    assert md["model"]["trained"] and md["dataset"]["rows_after_filter"] == 216
    assert [t["name"] for t in md["dataset"]["tag_list"]] == ["GRA-T1", "IROC-A"]
    scores = model.anomaly(np.random.RandomState(0).rand(20, 2).astype("float32"))
    assert np.isfinite(scores["total-anomaly-scaled"]).all()


def test_same_tag_name_on_two_assets_not_collapsed(tmp_path):
    """Two assets that both have a tag TEMP: each asset's own data, by position."""
    for asset, val in (("plant-1", 1.0), ("plant-2", 99.0)):
        d = tmp_path / asset / "TEMP"
        d.mkdir(parents=True)
        with open(d / "TEMP_2020.csv", "w") as f:
            for h in range(24):
                f.write(f"TEMP;{val};2020-01-01T{h:02d}:00:00+00:00\n")
    tags = [("TEMP", "plant-1"), ("TEMP", "plant-2")]
    a, b = both(DataLakeProvider(store_path=str(tmp_path)), JaxDataLakeProvider(store_path=str(tmp_path)),
                "2020-01-01", "2020-01-02", tags)
    assert (a.values == 1.0).all() and (b.values == 99.0).all()
    # the join needs one column a name: the port refuses what pandas would
    # join into two columns named TEMP
    ds = get_dataset({"type": "TimeSeriesDataset", "train_start_date": "2020-01-01",
                      "train_end_date": "2020-01-02", "tag_list": [list(t) for t in tags],
                      "data_provider": {"type": "DataLakeProvider", "store_path": str(tmp_path)}})
    with pytest.raises(ValueError, match="duplicate tag names"):
        ds.get_data()


def test_csv_missing_values_read_as_pandas_does(tmp_path):
    """pandas' default missing-value strings read as NaN, in both readers."""
    na = ["", "NaN", "nan", "NA", "N/A", "n/a", "NULL", "null", "None", "<NA>", "#N/A", "-NaN", "-nan"]
    d = tmp_path / "a" / "T"
    d.mkdir(parents=True)
    with open(d / "T_2020.csv", "w") as f:
        for h, v in enumerate(na + ["1.5", "-2.25e-3"]):
            f.write(f"T;{v};2020-01-01T{h:02d}:00:00Z\n")
    with open(tmp_path / "a" / "dump.csv", "w") as f:
        f.write("value,tag,timestamp\n")  # read by name, in any order
        for h, v in enumerate(na + ["7", "0.1"]):
            f.write(f"{v},U,2020-01-01 {h:02d}:30:00.123456789+01:00\n")
    (t,) = both(NcsReader(str(tmp_path)), JaxNcsReader(str(tmp_path)), "2019-12-31", "2020-01-02",
                [("T", "a")])
    assert np.isnan(t.values[:len(na)]).all() and list(t.values[len(na):]) == [1.5, -2.25e-3]
    (u,) = both(IrocReader(str(tmp_path)), JaxIrocReader(str(tmp_path)), "2019-12-31", "2020-01-02",
                [("U", "a")])
    assert np.isnan(u.values[:len(na)]).all() and u.index[0] % 1000 == 789


def test_parquet_without_pyarrow_names_the_file(monkeypatch):
    """With pyarrow's import blocked, the lake's 2021 parquet file reads
    through the port's own reader, to the bits pyarrow reads from it."""
    import builtins

    import pyarrow.parquet as pq

    path = os.path.join(LAKE, "asset-a", "GRA-T1", "GRA-T1_2021.parquet")
    table = pq.read_table(path)
    want_index = table.column("__index_level_0__").to_numpy().astype("datetime64[ns]").astype(np.int64)
    want_values = table.column("Value").to_numpy()
    real_import = builtins.__import__

    def no_pyarrow(name, *args, **kwargs):
        if name.split(".")[0] == "pyarrow":
            raise ImportError("No module named 'pyarrow'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    (s,) = NcsReader(LAKE).load_series(to_ns("2021-01-01"), to_ns("2021-02-01"), [SensorTag("GRA-T1", "asset-a")])
    np.testing.assert_array_equal(s.index, want_index)
    assert s.values.dtype == want_values.dtype == np.float64
    np.testing.assert_array_equal(s.values.view(np.uint64), want_values.view(np.uint64))
    # the 2020 CSV still reads
    (s,) = NcsReader(LAKE).load_series(to_ns("2020-01-01"), to_ns("2020-02-01"), [SensorTag("GRA-T1", "asset-a")])
    assert s.index.size > 0


def _forms(digits):
    frac = "." + "123456789"[:digits] if digits else ""
    return [f"2020-02-29{sep}13:45:07{frac}{tz}" for sep in "T " for tz in ("Z", "+00:00", "-05:30", "+01:00", "",
                                                                            "+0230")]


@pytest.mark.parametrize("digits", range(10))
def test_to_ns_and_parse_times_give_pandas_nanoseconds(digits):
    forms = _forms(digits)
    assert len(forms) == 12
    want = [pd.Timestamp(f).value if pd.Timestamp(f).tzinfo else pd.Timestamp(f, tz="UTC").value for f in forms]
    assert [to_ns(f) for f in forms] == want
    np.testing.assert_array_equal(parse_times(forms), want)  # mixed shapes: one string at a time
    for f, w in zip(forms, want):  # one shape a column: the column-wise path
        col = [f] * 3
        np.testing.assert_array_equal(parse_times(col), [w] * 3)
        np.testing.assert_array_equal(
            parse_times(col), pd.to_datetime(pd.Series(col), utc=True).dt.as_unit("ns").astype("int64"))
    assert to_ns("2020-01-01T00:00:00.123456789Z") % 10**9 == 123456789
    assert isoformat(want[0]) == pd.Timestamp(want[0], tz="UTC").isoformat()


@pytest.mark.parametrize("bad", ["junk", "2020-01-01T00", "2020-13-01T00:00:00", "2021-02-29",
                                 "2020-01-01T00:00:00.1234567891", "01/02/2020", "2020-01-01T00:00:00+1"])
def test_non_iso_timestamps_raise_naming_the_value(bad):
    with pytest.raises(ValueError, match=bad[:7]):
        to_ns(bad)
    with pytest.raises(ValueError, match=bad[:7]):
        parse_times(["2020-01-01T00:00:00Z", bad])
    with pytest.raises(ValueError, match=bad[:7]):
        parse_times([bad, bad])
