"""Thrift's compact protocol, for parquet's footer and page headers.

Parquet describes a file (``FileMetaData``) and each page (``PageHeader``)
as Thrift structs in the compact protocol. This module reads that protocol
with the standard library, and writes the part of it a flat file needs
(:func:`struct`):

- a field header byte holds the field id's delta from the last id in its
  high nibble (0: a zigzag varint id follows) and the type in its low one;
- integers are zigzag varints, doubles 8 bytes little-endian, binary and
  string fields a varint length and the bytes;
- a bool field's value is its type (1 true, 2 false), with no payload;
- a list or set header holds the size (15: a varint size follows) and the
  element type; a map a varint size, then one byte of key and value types.

A struct is read against a *spec*, ``{field id: (name, kind)}``, where a
kind is a type name (``"i32"``, ``"i64"``, ``"bool"``, ``"string"``), a
nested spec (a struct), or ``("list", kind)``. Every field
whose id the spec does not name is skipped, whatever its type and at any
depth, so fields that newer writers add (size statistics, geospatial
statistics, ...) change nothing. The specs below name only what
``_parquet.py`` reads.

A struct is written from ``(field id, kind, value)`` triples in field-id
order, a kind being ``"i32"``, ``"i64"``, ``"bool"``, ``"string"``,
``"struct"`` (the value already written by :func:`struct`) or ``("list",
kind)``; a value of None is left out.
"""

from typing import Any, Dict, Tuple

# compact protocol type ids
_STOP, _TRUE, _FALSE, _BYTE, _I16, _I32, _I64, _DOUBLE, _BINARY, _LIST, _SET, _MAP, _STRUCT, _UUID = range(14)
_INTS = (_BYTE, _I16, _I32, _I64)


class ThriftError(ValueError):
    """A buffer that is not a well-formed compact-protocol struct."""


class Reader:
    """Reads compact-protocol values from ``buf`` starting at ``pos``."""

    def __init__(self, buf, pos: int = 0):
        self.buf = memoryview(buf)
        self.pos = pos

    def _byte(self) -> int:
        if self.pos >= len(self.buf):
            raise ThriftError("truncated compact-protocol data")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        shift = result = 0
        while True:
            b = self._byte()
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result
            shift += 7
            if shift > 70:
                raise ThriftError("varint longer than 10 bytes")

    def zigzag(self) -> int:
        n = self.varint()
        return (n >> 1) ^ -(n & 1)

    def _bytes(self) -> bytes:
        n = self.varint()
        end = self.pos + n
        if end > len(self.buf):
            raise ThriftError("truncated binary field")
        out = bytes(self.buf[self.pos:end])
        self.pos = end
        return out

    def _collection_header(self) -> Tuple[int, int]:
        head = self._byte()
        size, etype = head >> 4, head & 0x0F
        if size == 15:
            size = self.varint()
        return size, etype

    # ------------------------------------------------------------------ #

    def skip(self, ttype: int) -> None:
        """Pass over one value of compact type ``ttype``."""
        if ttype in (_TRUE, _FALSE):
            return
        if ttype == _BYTE:
            self._byte()
        elif ttype in (_I16, _I32, _I64):
            self.varint()
        elif ttype in (_DOUBLE, _UUID):  # 8 and 16 bytes; a read past the end raises
            self.pos += 8 if ttype == _DOUBLE else 16
        elif ttype == _BINARY:
            self._bytes()
        elif ttype in (_LIST, _SET):
            size, etype = self._collection_header()
            for _ in range(size):
                self._skip_element(etype)
        elif ttype == _MAP:
            size = self.varint()
            if size:
                kinds = self._byte()
                for _ in range(size):
                    self._skip_element(kinds >> 4)
                    self._skip_element(kinds & 0x0F)
        elif ttype == _STRUCT:
            self.read_struct({})
        else:
            raise ThriftError(f"unknown compact-protocol type {ttype}")

    def _skip_element(self, etype: int) -> None:
        # a bool inside a collection is one byte, not a field type
        if etype in (_TRUE, _FALSE):
            self._byte()
        else:
            self.skip(etype)

    def _value(self, ttype: int, kind) -> Any:
        if kind == "bool" and ttype in (_TRUE, _FALSE):
            return ttype == _TRUE
        elif kind in ("i32", "i64") and ttype in _INTS:
            return self._byte() if ttype == _BYTE else self.zigzag()
        elif kind == "string" and ttype == _BINARY:
            return self._bytes().decode("utf-8")
        elif isinstance(kind, dict) and ttype == _STRUCT:
            return self.read_struct(kind)
        elif isinstance(kind, tuple) and kind[0] == "list" and ttype in (_LIST, _SET):
            size, etype = self._collection_header()
            return [self._value(etype, kind[1]) for _ in range(size)]
        raise ThriftError(f"field of compact type {ttype} where the spec expects {kind!r}")

    def read_struct(self, spec: Dict[int, Tuple[str, Any]]) -> Dict[str, Any]:
        """The fields of one struct that ``spec`` names, by name; every
        other field is skipped."""
        out: Dict[str, Any] = {}
        last = 0
        while True:
            head = self._byte()
            ttype = head & 0x0F
            if ttype == _STOP:
                return out
            delta = head >> 4
            fid = last + delta if delta else self.zigzag()
            last = fid
            named = spec.get(fid)
            if named is None:
                self.skip(ttype)
            else:
                out[named[0]] = self._value(ttype, named[1])


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(n: int) -> bytes:
    return _varint((n << 1) ^ (n >> 63))


_WRITE_TYPES = {"i32": _I32, "i64": _I64, "string": _BINARY, "struct": _STRUCT}


def _element(kind, value) -> bytes:
    if kind in ("i32", "i64"):
        return _zigzag(int(value))
    if kind == "string":
        raw = value.encode("utf-8") if isinstance(value, str) else bytes(value)
        return _varint(len(raw)) + raw
    if kind == "struct":
        return value
    raise ThriftError(f"cannot write a list element of kind {kind!r}")


def struct(*fields: Tuple[int, Any, Any]) -> bytes:
    """A compact-protocol struct of ``(field id, kind, value)`` triples,
    ids ascending; None values are left out."""
    out = bytearray()
    last = 0
    for fid, kind, value in fields:
        if value is None:
            continue
        if kind == "bool":
            ttype = _TRUE if value else _FALSE
        elif isinstance(kind, tuple):
            ttype = _LIST
        else:
            ttype = _WRITE_TYPES[kind]
        delta = fid - last
        out += bytes([(delta << 4) | ttype]) if 0 < delta <= 15 else bytes([ttype]) + _zigzag(fid)
        last = fid
        if kind == "bool":
            continue
        if isinstance(kind, tuple):
            etype = _WRITE_TYPES[kind[1]]
            n = len(value)
            out += bytes([(n << 4) | etype]) if n < 15 else bytes([0xF0 | etype]) + _varint(n)
            for v in value:
                out += _element(kind[1], v)
        else:
            out += _element(kind, value)
    out.append(_STOP)
    return bytes(out)


def read_struct(buf, spec, pos: int = 0) -> Tuple[Dict[str, Any], int]:
    """(the struct at ``pos`` of ``buf`` read against ``spec``, the position
    after it)."""
    reader = Reader(buf, pos)
    return reader.read_struct(spec), reader.pos


# ---------------------------------------------------------------------- #
# the parts of parquet.thrift the reader uses
# ---------------------------------------------------------------------- #

_EMPTY: Dict[int, Tuple[str, Any]] = {}
TIME_UNIT = {1: ("MILLIS", _EMPTY), 2: ("MICROS", _EMPTY), 3: ("NANOS", _EMPTY)}
TIMESTAMP_TYPE = {1: ("isAdjustedToUTC", "bool"), 2: ("unit", TIME_UNIT)}
INT_TYPE = {1: ("bitWidth", "i32"), 2: ("isSigned", "bool")}
# LogicalType is a union: the one field set names the type
LOGICAL_TYPE = {
    1: ("STRING", _EMPTY), 2: ("MAP", _EMPTY), 3: ("LIST", _EMPTY), 4: ("ENUM", _EMPTY),
    5: ("DECIMAL", _EMPTY), 6: ("DATE", _EMPTY), 7: ("TIME", _EMPTY), 8: ("TIMESTAMP", TIMESTAMP_TYPE),
    10: ("INTEGER", INT_TYPE), 11: ("UNKNOWN", _EMPTY), 12: ("JSON", _EMPTY), 13: ("BSON", _EMPTY),
    14: ("UUID", _EMPTY), 15: ("FLOAT16", _EMPTY), 16: ("VARIANT", _EMPTY), 17: ("GEOMETRY", _EMPTY),
    18: ("GEOGRAPHY", _EMPTY),
}
SCHEMA_ELEMENT = {
    1: ("type", "i32"), 2: ("type_length", "i32"), 3: ("repetition_type", "i32"), 4: ("name", "string"),
    5: ("num_children", "i32"), 6: ("converted_type", "i32"), 10: ("logicalType", LOGICAL_TYPE),
}
COLUMN_META_DATA = {
    4: ("codec", "i32"), 5: ("num_values", "i64"), 9: ("data_page_offset", "i64"),
    11: ("dictionary_page_offset", "i64"),
}
COLUMN_CHUNK = {1: ("file_path", "string"), 3: ("meta_data", COLUMN_META_DATA)}
ROW_GROUP = {1: ("columns", ("list", COLUMN_CHUNK)), 3: ("num_rows", "i64")}
KEY_VALUE = {1: ("key", "string"), 2: ("value", "string")}
FILE_META_DATA = {
    1: ("version", "i32"), 2: ("schema", ("list", SCHEMA_ELEMENT)), 3: ("num_rows", "i64"),
    4: ("row_groups", ("list", ROW_GROUP)), 5: ("key_value_metadata", ("list", KEY_VALUE)),
}
DATA_PAGE_HEADER = {
    1: ("num_values", "i32"), 2: ("encoding", "i32"), 3: ("definition_level_encoding", "i32"),
    4: ("repetition_level_encoding", "i32"),
}
DICTIONARY_PAGE_HEADER = {1: ("num_values", "i32"), 2: ("encoding", "i32")}
PAGE_HEADER = {
    1: ("type", "i32"), 2: ("uncompressed_page_size", "i32"), 3: ("compressed_page_size", "i32"),
    5: ("data_page_header", DATA_PAGE_HEADER), 7: ("dictionary_page_header", DICTIONARY_PAGE_HEADER),
}
