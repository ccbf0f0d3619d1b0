"""The port's stdlib parquet reader against pyarrow, on the CPU.

``gordo_components_torch.dataset.data_provider._parquet`` reads the files
pandas and pyarrow write by default, with numpy and the standard library.
Here it is held to ``pyarrow.parquet.read_table`` bitwise: each column's
dtype, its values' bits and its NaN positions, and the index as int64 ns
(pyarrow's own unit converted), on the lake's 2021 files, the committed
POST fixtures and frames written here with pandas (nulls in float and
integer columns, ms/us/ns tz-aware indices, a RangeIndex, no compression,
a year of 1-minute data over several row groups, a dictionary that falls
back to PLAIN pages). What it does not read raises ``NotImplementedError``
naming the codec, encoding or page type. The snappy decoder is held to
pyarrow's snappy codec, and the Thrift reader skips fields it does not
know at any depth.
"""

import glob
import io
import json
import os
import time

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from gordo_components_torch.dataset.data_provider import _parquet, _snappy, _thrift
from gordo_components_torch.dataset.data_provider._files import read_parquet as files_read_parquet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAKE_FILES = sorted(glob.glob(os.path.join(REPO, "examples", "datalake", "**", "*.parquet"), recursive=True))
POST_FIXTURES = [os.path.join(REPO, "examples", "parquet", f) for f in ("post_body.parquet", "post_body_y.parquet")]


def reference(source):
    """(index as int64 ns or None, names, name -> values) as pyarrow reads them."""
    table = pq.read_table(source)
    meta = (table.schema.metadata or {}).get(b"pandas")
    index_names = [c for c in json.loads(meta)["index_columns"] if isinstance(c, str)] if meta else []
    index = None
    if index_names:
        raw = table.column(index_names[0]).to_numpy()
        index = (raw.astype("datetime64[ns]").view(np.int64) if raw.dtype.kind == "M"
                 else pd.to_datetime(raw, utc=True, format="ISO8601").as_unit("ns").asi8)
    names = [n for n in table.column_names if n not in index_names]
    return index, names, {n: table.column(n).to_numpy() for n in names}


def assert_bitwise(got, want, what):
    if want.dtype.kind == "M":
        want = want.astype("datetime64[ns]")
    assert got.dtype == want.dtype, f"{what}: {got.dtype} vs {want.dtype}"
    assert got.shape == want.shape, what
    if want.dtype.kind == "f":
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
        bits = np.dtype(f"u{want.dtype.itemsize}")
        np.testing.assert_array_equal(got[~nan].view(bits), want[~nan].view(bits), err_msg=what)
    else:
        np.testing.assert_array_equal(got.view(np.int64) if want.dtype.kind == "M" else got,
                                      want.view(np.int64) if want.dtype.kind == "M" else want, err_msg=what)


def assert_same_as_pyarrow(path_or_bytes):
    raw = path_or_bytes if isinstance(path_or_bytes, bytes) else open(path_or_bytes, "rb").read()
    index, names, columns = _parquet.read_parquet_bytes(raw)
    want_index, want_names, want_columns = reference(io.BytesIO(raw))
    assert names == want_names
    if want_index is None:
        assert index is None
    else:
        assert index.dtype == np.int64
        np.testing.assert_array_equal(index, want_index)
    for name in names:
        assert_bitwise(columns[name], want_columns[name], name)
    return index, names, columns


def write(frame, **kwargs) -> bytes:
    buf = io.BytesIO()
    frame.to_parquet(buf, engine="pyarrow", **kwargs)
    return buf.getvalue()


@pytest.mark.parametrize("path", LAKE_FILES, ids=lambda p: os.path.basename(p))
def test_lake_files_read_as_pyarrow_reads_them(path):
    index, names, columns = assert_same_as_pyarrow(path)
    assert names == ["Value"] and len(index) == 400
    # the path the providers call reads the same
    got = files_read_parquet(path)
    np.testing.assert_array_equal(got[0], index)
    assert_bitwise(got[2]["Value"], columns["Value"], path)


@pytest.mark.parametrize("path", POST_FIXTURES, ids=lambda p: os.path.basename(p))
def test_post_fixtures_read_as_pyarrow_reads_them(path):
    index, names, _ = assert_same_as_pyarrow(path)
    assert index is not None and len(index) == 48
    assert any(n.startswith("__y__") for n in names) == path.endswith("_y.parquet")


def _nulls_frame(n=300, seed=0):
    rng = np.random.RandomState(seed)
    frame = pd.DataFrame({
        "f64": rng.randn(n),
        "f32": rng.randn(n).astype(np.float32),
        "i64": pd.array(rng.randint(-1000, 1000, n), dtype="Int64"),
        "i32": pd.array(rng.randint(-1000, 1000, n), dtype="Int32"),
        "dense_i64": rng.randint(0, 5, n).astype(np.int64),
        "dense_i32": rng.randint(0, 5, n).astype(np.int32),
        "const": np.full(n, 2.5),
    }, index=pd.date_range("2020-01-01", periods=n, freq="10min", tz="UTC"))
    for col in ("f64", "f32", "i64", "i32"):
        frame.loc[frame.index[rng.rand(n) < 0.2], col] = None
    frame.iloc[:3, 0] = [-0.0, np.inf, -np.inf]
    return frame


def _year(seed=0):
    """A year of 1-minute data of one sensor quantised to 0.01 (about a
    thousand distinct values), as a lake file holds it."""
    n = 525_600
    rng = np.random.RandomState(seed)
    values = np.round(np.sin(np.arange(n) / 500.0) * 5 + rng.randn(n) * 0.3, 2)
    values[rng.rand(n) < 0.001] = np.nan
    return pd.DataFrame({"Value": values}, index=pd.date_range("2021-01-01", periods=n, freq="1min", tz="UTC"))


FRAMES = {
    "nulls": lambda: write(_nulls_frame()),
    "nulls-many-pages": lambda: write(_nulls_frame(5000, seed=1), data_page_size=1 << 10, row_group_size=1200),
    "all-null-page": lambda: write(pd.DataFrame({"x": [np.nan] * 50 + [1.0] * 50}), data_page_size=64,
                                   write_batch_size=50),
    "ms-index": lambda: write(pd.DataFrame({"x": np.arange(20.0)},
                                           index=pd.date_range("2021-03-01", periods=20, freq="7s", unit="ms",
                                                               tz="UTC"))),
    "us-index": lambda: write(pd.DataFrame({"x": np.arange(20.0)},
                                           index=pd.date_range("2021-03-01", periods=20, freq="7s", unit="us",
                                                               tz="Europe/Oslo"))),
    "ns-index": lambda: write(pd.DataFrame({"x": np.arange(20.0)},
                                           index=pd.date_range("2021-03-01 00:00:00.000000001", periods=20,
                                                               freq="7ns", unit="ns", tz="UTC"))),
    "named-index": lambda: write(pd.DataFrame({"x": np.arange(5.0)}, index=pd.DatetimeIndex(
        pd.date_range("2021-01-01", periods=5, freq="h", tz="UTC"), name="time"))),
    "string-index": lambda: write(pd.DataFrame({"x": np.arange(4.0)}, index=pd.Index(
        ["2021-01-01T00:00:00Z", "2021-01-01T01:00:00+01:00", "2021-01-02", "2021-01-02 03:04:05.123456789"]))),
    "timestamp-column": lambda: write(pd.DataFrame({
        "time": pd.date_range("2021-01-01", periods=6, freq="h", tz="UTC", unit="ms"), "value": np.arange(6.0)})),
    "range-index": lambda: write(pd.DataFrame({"a": np.arange(10.0), "b": np.arange(10, dtype=np.float32)})),
    "uncompressed": lambda: write(_nulls_frame(seed=2), compression=None),
    "year-1min": lambda: write(_year(), row_group_size=100_000),
    "dictionary-fallback": lambda: write(
        pd.DataFrame({"x": np.round(np.random.RandomState(3).randn(20_000), 3),
                      "y": np.random.RandomState(4).randn(20_000)}),
        dictionary_pagesize_limit=1 << 10, data_page_size=1 << 12),
}


@pytest.mark.parametrize("case", sorted(FRAMES))
def test_frames_read_as_pyarrow_reads_them(case):
    raw = FRAMES[case]()
    t0 = time.perf_counter()
    index, names, columns = assert_same_as_pyarrow(raw)
    if case == "year-1min":
        meta = pq.ParquetFile(io.BytesIO(raw)).metadata
        assert meta.num_row_groups == 6 and len(index) == 525_600
        print(f"year-1min: {len(raw)} bytes, the reader and pyarrow in {time.perf_counter() - t0:.3f} s")
    if case == "dictionary-fallback":
        chunk = pq.ParquetFile(io.BytesIO(raw)).metadata.row_group(0).column(0)
        # the column's pages start dictionary-encoded and fall back to PLAIN
        assert {"PLAIN", "RLE_DICTIONARY"} <= set(chunk.encodings) and chunk.has_dictionary_page
    if case == "nulls":
        assert columns["i64"].dtype == columns["i32"].dtype == np.float64
        assert columns["dense_i64"].dtype == np.int64 and columns["dense_i32"].dtype == np.int32
        assert columns["f32"].dtype == np.float32 and np.isnan(columns["f32"]).any()


UNSUPPORTED = {
    "gzip": (dict(compression="gzip"), "codec GZIP"),
    "zstd": (dict(compression="zstd"), "codec ZSTD"),
    "byte-stream-split": (dict(use_dictionary=False, column_encoding="BYTE_STREAM_SPLIT"),
                          "encoding BYTE_STREAM_SPLIT"),
    "delta": (dict(use_dictionary=False, column_encoding={"n": "DELTA_BINARY_PACKED"}),
              "encoding DELTA_BINARY_PACKED"),
    "data-page-v2": (dict(data_page_version="2.0"), "page type DATA_PAGE_V2"),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_what_it_does_not_read_raises_by_name(case):
    kwargs, name = UNSUPPORTED[case]
    frame = pd.DataFrame({"x": np.arange(50.0), "n": np.arange(50, dtype=np.int64)})
    raw = write(frame, **kwargs)
    with pytest.raises(NotImplementedError, match=f"post.parquet: column .*{name}"):
        _parquet.read_parquet_bytes(raw, "post.parquet")


@pytest.mark.parametrize("case", ["string-column", "list-column", "int8", "bool", "uint64"])
def test_columns_it_does_not_read_raise_by_name(case):
    values = {"string-column": ["a", "b"], "list-column": [[1.0], [2.0, 3.0]],
              "int8": np.array([1, 2], np.int8), "bool": [True, False],
              "uint64": np.array([1, 2], np.uint64)}[case]
    want = {"string-column": "BYTE_ARRAY", "list-column": "nested", "int8": "INTEGER\\(bitWidth=8",
            "bool": "physical type BOOLEAN", "uint64": "isSigned=False"}[case]
    with pytest.raises(NotImplementedError, match=f"'c'.*{want}"):
        _parquet.read_parquet_bytes(write(pd.DataFrame({"c": values})))


@pytest.mark.parametrize("converted, ns_per", [(9, 1_000_000), (10, 1_000)])
def test_legacy_converted_timestamps_read_in_ns(converted, ns_per):
    col = _parquet._column({"name": "t", "type": 2, "repetition_type": 1, "converted_type": converted}, "f")
    assert col.ns_per == ns_per
    got = _parquet._assemble(np.array([1, 2], np.int64), np.array([True, False, True]), col)
    assert got.dtype == np.dtype("datetime64[ns]")
    assert list(got.view(np.int64)) == [ns_per, np.iinfo(np.int64).min, 2 * ns_per]


@pytest.mark.parametrize("corrupt", ["not-parquet", "short-footer", "truncated-page"])
def test_a_file_that_is_not_well_formed_raises_value_error(corrupt):
    raw = write(pd.DataFrame({"x": np.arange(100.0)}))
    bad = {"not-parquet": b"NOPE" + raw[4:],
           "short-footer": raw[:4] + raw[-8:-4] + b"PAR1",
           "truncated-page": raw[:20] + raw[-(8 + int.from_bytes(raw[-8:-4], "little")) - 8:]}[corrupt]
    with pytest.raises(ValueError):
        _parquet.read_parquet_bytes(bad)


def _snappy_cases():
    rng = np.random.RandomState(0)
    return {
        "empty": b"",
        "random": rng.bytes(100_000),
        "floats": rng.randn(20_000).tobytes(),
        "repetitive": b"abcabcabcabc" * 5000,
        "one-byte-run": b"\x00" * 70_000,  # overlapping copies of offset 1
        "short-pattern": (b"xy" * 3 + b"z") * 9000,
        "timestamps": (np.arange(50_000, dtype=np.int64) * 60_000_000 + 1609459200000000).tobytes(),
        "mixed": b"".join(rng.bytes(int(rng.randint(1, 80))) * int(rng.randint(1, 40)) for _ in range(2000)),
        "long-literal": rng.bytes(1 << 17),  # 3- and 4-byte literal lengths
    }


@pytest.mark.parametrize("case", sorted(_snappy_cases()))
def test_snappy_decoder_matches_pyarrow(case):
    data = _snappy_cases()[case]
    packed = pa.compress(data, codec="snappy", asbytes=True)
    assert _snappy.decompress(packed) == pa.decompress(packed, len(data), codec="snappy", asbytes=True) == data


def test_snappy_decoder_reads_every_element_form():
    # literal 'abcd'; copy-1 len 4 off 4; copy-2 len 3 off 2 (overlapping); copy-4 len 2 off 11
    block = bytes([13, 0x0C]) + b"abcd" + bytes([0x01, 4]) + bytes([0x0A, 2, 0]) + bytes([0x07, 11, 0, 0, 0])
    assert _snappy.decompress(block) == b"abcdabcdcdcab"


@pytest.mark.parametrize("block", [
    bytes([5, 0x10]) + b"ab",           # a literal past the end of the input
    bytes([8, 0x00]) + b"a" + bytes([0x0D, 0]),  # copy offset 0
    bytes([8, 0x00]) + b"a" + bytes([0x0D, 9]),  # copy offset beyond the start
    bytes([9, 0x0C]) + b"abcd",          # shorter than it declares
    bytes([2, 0x0C]) + b"abcd",          # longer than it declares
    bytes([0x80]),                       # a truncated length
], ids=["literal-past-end", "offset-0", "offset-past-start", "short", "long", "truncated-length"])
def test_snappy_decoder_refuses_a_corrupt_block(block):
    with pytest.raises(ValueError, match="snappy"):
        _snappy.decompress(block)


def _field(fid, last, ttype):
    delta = fid - last
    return bytes([(delta << 4) | ttype]) if 0 < delta < 16 else bytes([ttype, (fid << 1) ^ (fid >> 15)])


def test_thrift_reader_skips_unknown_fields_at_any_depth():
    """A struct with unknown fields of every type, one of them a struct
    holding a list of maps and a long field-id jump, around known ones."""
    def varint(n):
        out = bytearray()
        while True:
            out.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
            n >>= 7
            if not out[-1] & 0x80:
                return bytes(out)

    def zz(n):
        return varint((n << 1) ^ (n >> 63))

    inner_unknown = (_field(1, 0, 9) + bytes([0x2B]) + varint(1) + bytes([0x58]) + zz(7) + varint(2) + b"hi"
                     + varint(0) + b"\x00")  # list<map<i64, binary>> of 2 maps (one empty), then STOP
    buf = (_field(1, 0, 5) + zz(-3)                 # known i32
           + _field(2, 1, 1)                        # unknown bool true
           + _field(3, 2, 7) + b"\x00" * 8          # unknown double
           + _field(4, 3, 12) + inner_unknown       # unknown nested struct
           + _field(40, 4, 8) + varint(3) + b"abc"  # unknown binary after a long id jump
           + _field(41, 40, 3) + b"\x05"            # unknown byte
           + _field(42, 41, 10) + bytes([0x21]) + b"\x01\x02"  # unknown set<bool>
           + _field(43, 42, 12) + _field(1, 0, 8) + varint(1) + b"x" + b"\x00"  # known nested struct
           + _field(44, 43, 9) + bytes([0x25]) + zz(5) + zz(-6)  # known list<i32>
           + b"\x00")
    spec = {1: ("a", "i32"), 43: ("s", {1: ("name", "string")}), 44: ("l", ("list", "i32"))}
    got, end = _thrift.read_struct(buf, spec)
    assert got == {"a": -3, "s": {"name": "x"}, "l": [5, -6]} and end == len(buf)
    with pytest.raises(_thrift.ThriftError):
        _thrift.read_struct(buf[:-5], spec)


# ---------------------------------------------------------------------- #
# parquet POST bodies, and the lake machine that reads 2021's parquet
# ---------------------------------------------------------------------- #

LAKE = os.path.join(REPO, "examples", "datalake")
LAKE_PARQUET_DATA = {
    "type": "TimeSeriesDataset", "train_start_date": "2020-01-01T00:00:00Z",
    "train_end_date": "2021-01-18T00:00:00Z",
    "tag_list": [["GRA-T1", "asset-a"], ["GRA-T2", "asset-a"], ["GRA-P1", "asset-a"]],
    "data_provider": {"type": "DataLakeProvider", "store_path": LAKE},
}


def _load_chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_lake_parquet_machine_joins_2021_rows_as_jax_does():
    """The smoke's lake-parquet machine: its range spans each tag's 2020
    CSV and 2021 parquet; the port's get_data() is the JAX package's,
    bitwise, and holds the number of 2021 rows the smoke asserts."""
    from gordo_components_torch.dataset import get_dataset
    from gordo_components_tpu.dataset import get_dataset as jax_get_dataset

    X, _ = get_dataset(dict(LAKE_PARQUET_DATA)).get_data()
    want, _ = jax_get_dataset(dict(LAKE_PARQUET_DATA)).get_data()
    np.testing.assert_array_equal(X.values, want.values.astype(np.float32))
    np.testing.assert_array_equal(X.index.astype(np.int64), want.index.as_unit("ns").asi8)
    rows_2021 = int((X.index >= np.datetime64("2021-01-01")).sum())
    assert rows_2021 == int((want.index >= "2021-01-01").sum()) == _load_chip_smoke().LAKE_PARQUET_2021_ROWS


@pytest.mark.parametrize("path", POST_FIXTURES, ids=lambda p: os.path.basename(p))
def test_parquet_body_parses_as_the_jax_server_parses_it(path):
    from gordo_components_torch.server.utils import extract_x_y_parquet
    from gordo_components_tpu.server.utils import extract_x_y as jax_extract_x_y

    raw = open(path, "rb").read()
    X, y, index = extract_x_y_parquet(raw)
    want_X, want_y = jax_extract_x_y(None, raw, "application/x-parquet")
    assert X.dtype == np.float32
    np.testing.assert_array_equal(X, want_X.values.astype(np.float32))
    if want_y is None:
        assert y is None
    else:
        np.testing.assert_array_equal(y, want_y.values.astype(np.float32))
    assert [t.isoformat() for t in index] == [t.isoformat() for t in want_X.index]


@pytest.fixture(scope="module")
def lake_server(tmp_path_factory):
    from gordo_components_torch import serializer
    from gordo_components_torch.dataset import get_dataset
    from gordo_components_torch.models import AutoEncoder, DiffBasedAnomalyDetector
    from gordo_components_torch.models.transformers import MinMaxScaler, Pipeline
    from gordo_components_torch.server import run_server

    X, _ = get_dataset(dict(LAKE_PARQUET_DATA)).get_data()
    det = DiffBasedAnomalyDetector(base_estimator=Pipeline([
        ("scale", MinMaxScaler()), ("model", AutoEncoder(epochs=1, batch_size=64, device="cpu"))])).fit(X)
    root = tmp_path_factory.mktemp("models")
    serializer.dump(det, str(root / "lake-parquet"))
    server = run_server(str(root), host="127.0.0.1", port=0, background=True, device="cpu")
    yield server.url + "/gordo/v0/proj"
    server.close()


def _post(url, raw, content_type):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=raw, headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as exc:
        return exc.code, json.load(exc)


@pytest.mark.parametrize("route", ["anomaly/prediction", "prediction"])
@pytest.mark.parametrize("path", POST_FIXTURES, ids=lambda p: os.path.basename(p))
def test_parquet_and_json_posts_answer_alike(lake_server, path, route):
    """The same rows POSTed as parquet and as JSON answer the same body,
    bitwise."""
    raw = open(path, "rb").read()
    frame = pd.read_parquet(io.BytesIO(raw))
    x_cols = [c for c in frame.columns if not c.startswith("__y__")]
    y_cols = [c for c in frame.columns if c.startswith("__y__")]
    body = {"X": frame[x_cols].values.tolist(), "index": [t.isoformat() for t in frame.index]}
    if y_cols:
        body["y"] = frame[y_cols].values.tolist()
    url = f"{lake_server}/lake-parquet/{route}"
    status, by_parquet = _post(url, raw, "application/x-parquet")
    assert status == 200, by_parquet
    assert (status, by_parquet) == _post(url, json.dumps(body).encode(), "application/json")


def test_parquet_post_the_reader_refuses_answers_400(lake_server):
    status, body = _post(f"{lake_server}/lake-parquet/anomaly/prediction",
                         write(pd.DataFrame({"GRA-T1": np.arange(3.0)}), compression="gzip"),
                         "application/x-parquet")
    assert status == 400 and "codec GZIP" in body["error"]
    status, body = _post(f"{lake_server}/lake-parquet/prediction", b"not parquet", "application/x-parquet")
    assert status == 400 and "not a parquet file" in body["error"]
    null_index = pd.DatetimeIndex(["2021-01-01", None, "2021-01-02"], tz="UTC")
    status, body = _post(f"{lake_server}/lake-parquet/prediction",
                         write(pd.DataFrame({"GRA-T1": [1.0, 2.0, 3.0]}, index=null_index)), "application/x-parquet")
    assert status == 400 and "null timestamp" in body["error"]
    import urllib.request

    with urllib.request.urlopen(f"{lake_server}/models", timeout=60) as resp:
        assert json.load(resp)["accepts"] == ["application/json", "application/x-gordo-tensor", "application/x-parquet"]
