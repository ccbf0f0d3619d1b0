"""Read the parquet files pandas and pyarrow write by default, with numpy
and the standard library.

:func:`read_parquet_bytes` and :func:`read_parquet` give what the JAX
package's ``pd.read_parquet`` gives as arrays: (the index as int64 ns or
None, the column names, name -> numpy values). The index is the column the
``pandas`` schema metadata names first in ``index_columns``
(``__index_level_0__`` for an unnamed index); a RangeIndex is stored as a
dict there and reads as no index.

The subset read:

- the ``PAR1`` magic and the Thrift footer (``_thrift.py``), every row
  group and every page of a column chunk: a dictionary page, then data
  pages, which may switch from dictionary indices to PLAIN values partway
  (a dictionary that outgrew its limit);
- codecs UNCOMPRESSED and SNAPPY (``_snappy.py``); page types
  DICTIONARY_PAGE and DATA_PAGE (v1); value encodings PLAIN and
  RLE_DICTIONARY (PLAIN_DICTIONARY, its old name);
- flat REQUIRED and OPTIONAL columns: definition levels, for nulls, in the
  RLE/bit-packed hybrid after a 4-byte length, dictionary indices in the
  same hybrid after a bit-width byte, bit-packed runs unpacked with numpy;
- physical types DOUBLE, FLOAT, INT64 and INT32. A null reads as NaN in a
  float column, and makes an integer column float64 with NaN, as
  ``Table.to_numpy()`` and ``pd.read_parquet`` give it;
- TIMESTAMP (MILLIS, MICROS, NANOS; and the legacy converted types
  TIMESTAMP_MILLIS, TIMESTAMP_MICROS) on INT64, read as nanoseconds:
  ``datetime64[ns]`` values in a column, int64 ns in the index; a string
  (BYTE_ARRAY UTF8) index is parsed as timestamps.

Anything else raises ``NotImplementedError`` naming the file and the thing
by its parquet name: another codec (GZIP, ZSTD, LZ4_RAW, BROTLI, ...),
another encoding (DELTA_BINARY_PACKED, BYTE_STREAM_SPLIT, ...),
DATA_PAGE_V2, a repeated or nested column, another physical or logical
type, or a BYTE_ARRAY column that is not the index. A file that is not
well-formed raises ``ValueError``.

:func:`write_parquet_bytes` and :func:`write_parquet` write a file of that
subset, for the bulk client's parquet POST bodies and its parquet
forwarder: flat REQUIRED columns (DOUBLE, FLOAT, INT64, INT32), PLAIN
encoding, UNCOMPRESSED, one row group and one data page a column, and the
index as a ``__index_level_0__`` column of TIMESTAMP(NANOS, UTC) with the
``pandas`` key-value metadata, so ``pd.read_parquet`` gives back a UTC
``DatetimeIndex`` (pandas and pyarrow write SNAPPY, dictionary pages and
OPTIONAL columns by default; readers of either take this file as it is).
"""

import json
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from gordo_components_torch.dataset.data_provider import _snappy, _thrift
from gordo_components_torch.dataset.times import parse_times

MAGIC = b"PAR1"
TYPES = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE", "BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY")
CODECS = ("UNCOMPRESSED", "SNAPPY", "GZIP", "LZO", "BROTLI", "LZ4", "ZSTD", "LZ4_RAW")
ENCODINGS = ("PLAIN", "GROUP_VAR_INT", "PLAIN_DICTIONARY", "RLE", "BIT_PACKED", "DELTA_BINARY_PACKED",
             "DELTA_LENGTH_BYTE_ARRAY", "DELTA_BYTE_ARRAY", "RLE_DICTIONARY", "BYTE_STREAM_SPLIT")
PAGE_TYPES = ("DATA_PAGE", "INDEX_PAGE", "DICTIONARY_PAGE", "DATA_PAGE_V2")
CONVERTED_TYPES = ("UTF8", "MAP", "MAP_KEY_VALUE", "LIST", "ENUM", "DECIMAL", "DATE", "TIME_MILLIS",
                   "TIME_MICROS", "TIMESTAMP_MILLIS", "TIMESTAMP_MICROS", "UINT_8", "UINT_16", "UINT_32",
                   "UINT_64", "INT_8", "INT_16", "INT_32", "INT_64", "JSON", "BSON", "INTERVAL")
_PLAIN, _PLAIN_DICTIONARY, _RLE, _RLE_DICTIONARY = 0, 2, 3, 8
_DATA_PAGE, _DICTIONARY_PAGE = 0, 2
_REQUIRED, _OPTIONAL = 0, 1
_NUMPY = {"INT32": np.dtype("<i4"), "INT64": np.dtype("<i8"), "FLOAT": np.dtype("<f4"),
          "DOUBLE": np.dtype("<f8")}
_NS_PER = {"MILLIS": 1_000_000, "MICROS": 1_000, "NANOS": 1}
_NAT = np.iinfo(np.int64).min


def _name(table, code: int) -> str:
    return table[code] if 0 <= code < len(table) else f"<unknown {code}>"


class _Column(NamedTuple):
    name: str
    ptype: str  # physical type name
    optional: bool
    ns_per: Optional[int]  # a timestamp column's nanoseconds per stored unit
    string: bool  # BYTE_ARRAY UTF8


def _column(el: dict, where: str) -> _Column:
    """A leaf of the schema as a column the reader reads, or
    ``NotImplementedError`` naming what it is."""
    name = el.get("name", "?")
    what = f"{where}: column {name!r}"
    if el.get("num_children"):
        raise NotImplementedError(f"{what} is nested (a group of {el['num_children']} fields)")
    repetition = el.get("repetition_type", _REQUIRED)
    if repetition not in (_REQUIRED, _OPTIONAL):
        raise NotImplementedError(f"{what} is REPEATED")
    ptype = _name(TYPES, el.get("type", -1))
    logical = el.get("logicalType") or {}
    converted = el.get("converted_type")
    ns_per, string = None, False
    if "TIMESTAMP" in logical:
        ns_per = _NS_PER[next(iter(logical["TIMESTAMP"].get("unit") or {"MICROS": {}}))]
    elif converted in (9, 10):  # TIMESTAMP_MILLIS, TIMESTAMP_MICROS
        ns_per = _NS_PER["MILLIS" if converted == 9 else "MICROS"]
    elif "STRING" in logical or converted == 0:
        string = True
    elif "INTEGER" in logical:
        width, signed = logical["INTEGER"].get("bitWidth"), logical["INTEGER"].get("isSigned", True)
        if not signed or width != {"INT32": 32, "INT64": 64}.get(ptype):
            raise NotImplementedError(f"{what}: logical type INTEGER(bitWidth={width}, isSigned={signed})")
    elif logical:
        raise NotImplementedError(f"{what}: logical type {next(iter(logical))}")
    elif converted is not None and converted not in (17, 18):  # INT_32, INT_64
        raise NotImplementedError(f"{what}: converted type {_name(CONVERTED_TYPES, converted)}")
    if ns_per is not None and ptype != "INT64":
        raise NotImplementedError(f"{what}: a TIMESTAMP stored as {ptype}")
    if string and ptype != "BYTE_ARRAY":
        raise NotImplementedError(f"{what}: a STRING stored as {ptype}")
    if ptype not in _NUMPY and not (string and ptype == "BYTE_ARRAY"):
        raise NotImplementedError(f"{what}: physical type {ptype}")
    return _Column(name, ptype, repetition == _OPTIONAL, ns_per, string)


def _varint(data, pos: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated RLE/bit-packed run header")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _hybrid(data, bit_width: int, n: int) -> np.ndarray:
    """The first ``n`` values of an RLE/bit-packed hybrid run sequence of
    ``bit_width``-bit values (no length prefix), as int64."""
    if not 0 <= bit_width <= 32:
        raise ValueError(f"bit width {bit_width}")
    weights = np.left_shift(np.int64(1), np.arange(bit_width, dtype=np.int64))
    value_bytes = (bit_width + 7) // 8
    runs: List[np.ndarray] = []
    got = pos = 0
    while got < n:
        header, pos = _varint(data, pos)
        if header & 1:  # bit-packed: (header >> 1) groups of 8 values, LSB first
            count = (header >> 1) * 8
            nbytes = (header >> 1) * bit_width
            if pos + nbytes > len(data):
                raise ValueError("bit-packed run past the end of its page")
            if bit_width:
                bits = np.unpackbits(np.frombuffer(data, np.uint8, nbytes, pos), bitorder="little")
                values = bits.reshape(count, bit_width).astype(np.int64) @ weights
            else:
                values = np.zeros(count, np.int64)
            pos += nbytes
        else:  # RLE: one value repeated (header >> 1) times
            count = header >> 1
            if pos + value_bytes > len(data):
                raise ValueError("RLE run past the end of its page")
            value = int.from_bytes(bytes(data[pos:pos + value_bytes]), "little")
            pos += value_bytes
            values = np.full(count, value, np.int64)
        if count == 0:
            raise ValueError("empty RLE/bit-packed run")
        runs.append(values[:n - got])
        got += len(runs[-1])
    return np.concatenate(runs) if runs else np.zeros(0, np.int64)


def _plain(data, col: _Column, n: int, where: str) -> np.ndarray:
    """``n`` PLAIN-encoded values of ``col``."""
    if col.string:
        out, pos = [], 0
        for _ in range(n):
            if pos + 4 > len(data):
                raise ValueError(f"{where}: column {col.name!r}: truncated BYTE_ARRAY value")
            length = int.from_bytes(bytes(data[pos:pos + 4]), "little")
            out.append(bytes(data[pos + 4:pos + 4 + length]).decode("utf-8"))
            pos += 4 + length
        return np.array(out, dtype=object)
    dtype = _NUMPY[col.ptype]
    if n * dtype.itemsize > len(data):
        raise ValueError(f"{where}: column {col.name!r}: a page holds fewer than {n} values")
    return np.frombuffer(data, dtype, n).copy()


def _read_chunk(buf, meta: dict, col: _Column, where: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(the non-null values of one column chunk, its validity mask or None
    when the column is REQUIRED)."""
    what = f"{where}: column {col.name!r}"
    codec = meta.get("codec", 0)
    if codec not in (0, 1):
        raise NotImplementedError(f"{what}: codec {_name(CODECS, codec)} (the reader reads UNCOMPRESSED "
                                  "and SNAPPY)")
    pos = meta["data_page_offset"]
    if meta.get("dictionary_page_offset"):
        pos = min(pos, meta["dictionary_page_offset"])
    remaining = meta["num_values"]
    dictionary = None
    values: List[np.ndarray] = []
    masks: List[np.ndarray] = []
    while remaining > 0:
        try:
            header, pos = _thrift.read_struct(buf, _thrift.PAGE_HEADER, pos)
        except _thrift.ThriftError as exc:
            raise ValueError(f"{what}: a page header does not read ({exc})") from None
        size = header["compressed_page_size"]
        page = buf[pos:pos + size]
        pos += size
        if len(page) != size:
            raise ValueError(f"{what}: a page runs past the end of the file")
        page_type = header["type"]
        if page_type not in (_DATA_PAGE, _DICTIONARY_PAGE):
            raise NotImplementedError(f"{what}: page type {_name(PAGE_TYPES, page_type)}")
        if codec == 1:
            page = _snappy.decompress(page)
        if len(page) != header["uncompressed_page_size"]:
            raise ValueError(f"{what}: a page is {len(page)} bytes, its header says "
                             f"{header['uncompressed_page_size']}")
        if page_type == _DICTIONARY_PAGE:
            dph = header["dictionary_page_header"]
            if dph.get("encoding", _PLAIN) not in (_PLAIN, _PLAIN_DICTIONARY):
                raise NotImplementedError(f"{what}: dictionary encoding {_name(ENCODINGS, dph['encoding'])}")
            dictionary = _plain(page, col, dph["num_values"], where)
            continue
        dph = header["data_page_header"]
        n = dph["num_values"]
        p = 0
        if col.optional:
            if dph.get("definition_level_encoding", _RLE) != _RLE:
                raise NotImplementedError(
                    f"{what}: definition level encoding {_name(ENCODINGS, dph['definition_level_encoding'])}")
            length = int.from_bytes(bytes(page[:4]), "little")
            valid = _hybrid(page[4:4 + length], 1, n) == 1
            masks.append(valid)
            k = int(valid.sum())
            p = 4 + length
        else:
            k = n
        encoding = dph.get("encoding", _PLAIN)
        if encoding == _PLAIN:
            values.append(_plain(page[p:], col, k, where))
        elif encoding in (_PLAIN_DICTIONARY, _RLE_DICTIONARY):
            if dictionary is None:
                raise ValueError(f"{what}: dictionary indices before a dictionary page")
            if k:
                idx = _hybrid(page[p + 1:], page[p], k)
                if idx.max() >= len(dictionary):
                    raise ValueError(f"{what}: a dictionary index past its {len(dictionary)} entries")
                values.append(dictionary[idx])
        else:
            raise NotImplementedError(f"{what}: encoding {_name(ENCODINGS, encoding)}")
        remaining -= n
    if not col.optional:
        return _join(values, col), None
    return _join(values, col), np.concatenate(masks) if masks else np.zeros(0, bool)


def _join(parts: List[np.ndarray], col: _Column) -> np.ndarray:
    if parts:
        return np.concatenate(parts)
    return np.zeros(0, object if col.string else _NUMPY[col.ptype])


def _assemble(values: np.ndarray, valid: Optional[np.ndarray], col: _Column) -> np.ndarray:
    """A column's values with its nulls placed: NaN for numbers (float64 for
    an integer column), NaT for timestamps, None for strings."""
    if col.ns_per is not None:
        ns = values.astype(np.int64) * np.int64(col.ns_per)
        if valid is not None and not valid.all():
            full = np.full(len(valid), _NAT, np.int64)
            full[valid] = ns
            ns = full
        return ns.view("datetime64[ns]")
    if valid is None or valid.all():
        return values
    if col.string:
        full = np.full(len(valid), None, dtype=object)
    else:
        full = np.full(len(valid), np.nan, values.dtype if values.dtype.kind == "f" else np.float64)
    full[valid] = values
    return full


def read_parquet_bytes(buf, where: str = "<parquet bytes>"
                       ) -> Tuple[Optional[np.ndarray], List[str], Dict[str, np.ndarray]]:
    """(index as int64 ns or None, column names, name -> values) of the
    parquet file in ``buf``; ``where`` names it in errors."""
    buf = memoryview(buf)
    if len(buf) < 12 or bytes(buf[:4]) != MAGIC:
        raise ValueError(f"{where}: not a parquet file (no leading {MAGIC!r})")
    if bytes(buf[-4:]) != MAGIC:
        raise NotImplementedError(f"{where}: footer magic {bytes(buf[-4:])!r} (an encrypted footer is PARE)")
    footer_len = int.from_bytes(bytes(buf[-8:-4]), "little")
    start = len(buf) - 8 - footer_len
    if start < 4:
        raise ValueError(f"{where}: footer length {footer_len} exceeds the file")
    try:
        meta, _ = _thrift.read_struct(buf[start:len(buf) - 8], _thrift.FILE_META_DATA)
    except _thrift.ThriftError as exc:
        raise ValueError(f"{where}: the footer does not read ({exc})") from None
    schema = meta.get("schema") or []
    if not schema:
        raise ValueError(f"{where}: no schema")
    columns = [_column(el, where) for el in schema[1:]]
    if len(columns) != schema[0].get("num_children", len(columns)):
        raise NotImplementedError(f"{where}: nested columns")
    kv = {e.get("key"): e.get("value") for e in meta.get("key_value_metadata") or []}
    index_names = [c for c in json.loads(kv["pandas"]).get("index_columns", [])
                   if isinstance(c, str)] if kv.get("pandas") else []
    for col in columns:
        if col.string and col.name != (index_names[0] if index_names else None):
            raise NotImplementedError(f"{where}: column {col.name!r}: BYTE_ARRAY (strings are read only as "
                                      "the index)")
    parts: Dict[str, list] = {c.name: [] for c in columns}
    for group in meta.get("row_groups") or []:
        chunks = group.get("columns") or []
        if len(chunks) != len(columns):
            raise ValueError(f"{where}: a row group has {len(chunks)} column chunks for {len(columns)} columns")
        for col, chunk in zip(columns, chunks):
            if chunk.get("file_path"):
                raise NotImplementedError(f"{where}: column {col.name!r}: a chunk in another file "
                                          f"({chunk['file_path']!r})")
            parts[col.name].append(_read_chunk(buf, chunk["meta_data"], col, where))
    out: Dict[str, np.ndarray] = {}
    for col in columns:
        values = _join([v for v, _ in parts[col.name]], col)
        masks = [m for _, m in parts[col.name]]
        valid = np.concatenate(masks) if masks and masks[0] is not None else None
        out[col.name] = _assemble(values, valid, col)
    index = None
    if index_names:
        raw = out[index_names[0]]
        if raw.dtype.kind == "M":
            index = raw.view(np.int64)
        elif raw.dtype == object:
            index = parse_times(list(raw))
        else:
            raise ValueError(f"{where}: {raw.dtype} is not a column of timestamps")
    names = [c.name for c in columns if c.name not in index_names]
    return index, names, {n: out[n] for n in names}


def read_parquet(path: str) -> Tuple[Optional[np.ndarray], List[str], Dict[str, np.ndarray]]:
    """:func:`read_parquet_bytes` of the file at ``path``."""
    with open(path, "rb") as f:
        return read_parquet_bytes(f.read(), path)


# ---------------------------------------------------------------------- #
# the writer
# ---------------------------------------------------------------------- #

_INDEX_NAME = "__index_level_0__"
_PHYSICAL = {np.dtype("<f8"): 5, np.dtype("<f4"): 4, np.dtype("<i8"): 2, np.dtype("<i4"): 1}  # DOUBLE ... INT32
_PANDAS_TYPE = {"f8": "float64", "f4": "float32", "i8": "int64", "i4": "int32"}
_NANOS = _thrift.struct((8, "struct", _thrift.struct(  # LogicalType.TIMESTAMP
    (1, "bool", True), (2, "struct", _thrift.struct((3, "struct", _thrift.struct()))))))


def _pandas_meta(names: List[str], columns: Dict[str, np.ndarray], index_kind: Optional[str]) -> str:
    fields = [{"name": n, "field_name": n, "pandas_type": _PANDAS_TYPE[columns[n].dtype.str[1:]],
               "numpy_type": columns[n].dtype.name, "metadata": None} for n in names]
    if index_kind == "M":
        fields.append({"name": None, "field_name": _INDEX_NAME, "pandas_type": "datetimetz",
                       "numpy_type": "datetime64[ns]", "metadata": {"timezone": "UTC"}})
    elif index_kind == "i":
        fields.append({"name": None, "field_name": _INDEX_NAME, "pandas_type": "int64",
                       "numpy_type": "int64", "metadata": None})
    return json.dumps({
        "index_columns": [_INDEX_NAME] if index_kind else [],
        "column_indexes": [{"name": None, "field_name": None, "pandas_type": "unicode", "numpy_type": "object",
                            "metadata": {"encoding": "UTF-8"}}],
        "columns": fields,
        "attributes": {},
        "creator": {"library": "gordo-components-torch"},
    })


def write_parquet_bytes(index: Optional[np.ndarray], names: List[str], columns: Dict[str, np.ndarray]) -> bytes:
    """A parquet file of ``columns`` (name -> 1-D float64, float32, int64
    or int32 values, all of one length) in the order of ``names``, with
    ``index`` (``datetime64`` values, written as UTC ns; int64 values; or
    None for no index) as the pandas index. :func:`read_parquet_bytes`
    reads back what was written, to the bit."""
    cols = {}
    for n in names:
        a = np.asarray(columns[n])
        a = a.astype(a.dtype.newbyteorder("<"))
        if a.ndim != 1 or a.dtype not in _PHYSICAL:
            raise NotImplementedError(f"column {n!r}: {a.dtype} of shape {a.shape} (the writer writes 1-D "
                                      "float64, float32, int64 and int32 columns)")
        cols[n] = a
    n_rows = len(cols[names[0]]) if names else (0 if index is None else len(index))
    index_kind = None
    if index is not None:
        index = np.asarray(index)
        index_kind = "M" if index.dtype.kind == "M" else "i"
        if index_kind == "M":
            index = index.astype("datetime64[ns]").view("<i8")
        elif index.dtype.kind not in "iu":
            raise NotImplementedError(f"index of {index.dtype} (the writer writes timestamps and integers)")
        cols[_INDEX_NAME] = index.astype("<i8")
    if any(len(a) != n_rows for a in cols.values()):
        raise ValueError("the columns and the index differ in length")
    out = bytearray(MAGIC)
    schema = [_thrift.struct((4, "string", "schema"), (5, "i32", len(cols)))]
    chunks = []
    for n, a in cols.items():
        payload = np.ascontiguousarray(a).tobytes()
        header = _thrift.struct(
            (1, "i32", _DATA_PAGE), (2, "i32", len(payload)), (3, "i32", len(payload)),
            (5, "struct", _thrift.struct((1, "i32", n_rows), (2, "i32", _PLAIN), (3, "i32", _RLE),
                                         (4, "i32", _RLE))))
        offset = len(out)
        out += header + payload
        meta = _thrift.struct(
            (1, "i32", _PHYSICAL[a.dtype]), (2, ("list", "i32"), [_PLAIN]), (3, ("list", "string"), [n]),
            (4, "i32", 0), (5, "i64", n_rows), (6, "i64", len(header) + len(payload)),
            (7, "i64", len(header) + len(payload)), (9, "i64", offset))
        chunks.append(_thrift.struct((2, "i64", offset), (3, "struct", meta)))
        timestamp = n == _INDEX_NAME and index_kind == "M"
        schema.append(_thrift.struct((1, "i32", _PHYSICAL[a.dtype]), (3, "i32", _REQUIRED), (4, "string", n),
                                     (10, "struct", _NANOS if timestamp else None)))
    group = _thrift.struct((1, ("list", "struct"), chunks), (2, "i64", len(out) - len(MAGIC)),
                           (3, "i64", n_rows))
    kv = [_thrift.struct((1, "string", "pandas"), (2, "string", _pandas_meta(names, cols, index_kind)))]
    footer = _thrift.struct((1, "i32", 2), (2, ("list", "struct"), schema), (3, "i64", n_rows),
                            (4, ("list", "struct"), [group]), (5, ("list", "struct"), kv),
                            (6, "string", "gordo-components-torch"))
    out += footer + len(footer).to_bytes(4, "little") + MAGIC
    return bytes(out)


def write_parquet(path: str, index: Optional[np.ndarray], names: List[str], columns: Dict[str, np.ndarray]) -> None:
    """:func:`write_parquet_bytes` to the file at ``path``."""
    data = write_parquet_bytes(index, names, columns)
    with open(path, "wb") as f:
        f.write(data)
