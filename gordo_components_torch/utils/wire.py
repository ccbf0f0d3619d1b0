"""Framed binary tensor wire format (``application/x-gordo-tensor``).

Counterpart of ``gordo_components_tpu/utils/wire.py``, byte for byte: a
body either package writes, the other reads, and a malformed body raises
:class:`WireFormatError` with the same message in both (clients read it
from a 400). A float row is already bytes; the format frames them so both
ends exchange ndarrays with one header parse:

- the server parses a body with ``np.frombuffer`` views over it (no copy,
  no per-value float boxing);
- a response is written array by array into one preallocated buffer;
- a client serializes a chunk with one C-order memory copy.

Body layout (all integers little-endian)::

    MAGIC(4)=b"GTNS" | VERSION(u8)=1 | NFRAMES(u8) | frame*NFRAMES

    frame := NAMELEN(u8) | NAME(utf-8)
           | DTYPELEN(u8) | DTYPE(ascii, numpy str e.g. "<f4")
           | NDIM(u8) | DIM(u64-le) * NDIM
           | NBYTES(u64-le) | PAYLOAD(C-order bytes)

``NBYTES`` is redundant with ``prod(shape) * itemsize`` and is verified on
parse, so a truncated or padded body is a named 400, never a wrong score.
A request carries ``X`` (and ``y``) and may carry a ``__meta__`` JSON
frame; an anomaly response carries ``__meta__`` and the six score arrays.

Versioning: the magic and version pair is the negotiation unit. A parser
rejects an unknown version; a layout change bumps ``WIRE_VERSION``, and
fields are only appended to the frame header within a version.
"""

import struct
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ANOMALY_FRAME_NAMES",
    "TENSOR_CONTENT_TYPE",
    "WIRE_MAGIC",
    "WIRE_VERSION",
    "WireFormatError",
    "encoding_of",
    "pack_frames",
    "unpack_frames",
    "rows_as_f32",
]

TENSOR_CONTENT_TYPE = "application/x-gordo-tensor"
WIRE_MAGIC = b"GTNS"
WIRE_VERSION = 1

# anomaly-response frame names, in wire order — part of the format
# contract (both ends must agree): the same top-level column names the
# JSON body's ``data`` dict uses, so a client reconstructs an identical
# frame from either encoding
ANOMALY_FRAME_NAMES = (
    "model-input",
    "model-output",
    "tag-anomaly-unscaled",
    "tag-anomaly-scaled",
    "total-anomaly-unscaled",
    "total-anomaly-scaled",
)


def encoding_of(content_type: Optional[str]) -> str:
    """Classify a request body's wire encoding from its content type —
    THE opt-in rule, defined once so the HTTP handlers and the
    per-encoding metrics can never drift: ``tensor`` | ``parquet`` |
    ``json`` (the default; a JSON request must flow byte-identical
    through the pre-tensor code)."""
    content_type = content_type or ""
    if TENSOR_CONTENT_TYPE in content_type:
        return "tensor"
    if "parquet" in content_type:
        return "parquet"
    return "json"

# parse-side resource bounds: a hostile header must not make the server
# allocate absurd shape tuples or loop forever (the payloads are views
# into the body already read, so they cost no allocation)
_MAX_FRAMES = 64
_MAX_NDIM = 8

# fixed-width numeric kinds only: float/int/uint/bool. Anything else
# ("O" object, "U"/"S" strings, "V" void) either cannot be viewed with
# frombuffer or would let a request body smuggle non-numeric payloads
# into the scoring path.
_ALLOWED_KINDS = frozenset("fiub")
_MAX_ITEMSIZE = 8

_U64 = struct.Struct("<Q")


class WireFormatError(ValueError):
    """A tensor body that violates the frame layout. The HTTP layer maps
    this to a 400 whose body carries the reason verbatim."""


def _check_dtype(dtype_str: str) -> np.dtype:
    try:
        dtype = np.dtype(dtype_str)
    except TypeError as exc:
        raise WireFormatError(f"undecodable dtype {dtype_str!r}: {exc}") from None
    if dtype.kind not in _ALLOWED_KINDS or dtype.itemsize > _MAX_ITEMSIZE:
        raise WireFormatError(
            f"dtype {dtype_str!r} not allowed on the wire "
            f"(numeric kinds {sorted(_ALLOWED_KINDS)}, itemsize <= {_MAX_ITEMSIZE})"
        )
    return dtype


def pack_frames(frames: Sequence[Tuple[str, np.ndarray]]) -> bytes:
    """Serialize named arrays into one tensor body.

    Sizes are computed first and the whole body is written into ONE
    preallocated buffer — each array's bytes are copied exactly once
    (the C-order normalization for a non-contiguous input is the only
    other copy this path can make). This is the response hot path: the
    server hands fetched device buffers straight here.
    """
    if not frames:
        raise WireFormatError("a tensor body must carry at least one frame")
    if len(frames) > _MAX_FRAMES:
        raise WireFormatError(
            f"{len(frames)} frames exceeds the {_MAX_FRAMES}-frame bound"
        )
    staged = []
    total = len(WIRE_MAGIC) + 2
    for name, arr in frames:
        arr = np.ascontiguousarray(arr)
        _check_dtype(arr.dtype.str)
        name_b = name.encode("utf-8")
        dtype_b = arr.dtype.str.encode("ascii")
        if not 0 < len(name_b) < 256:
            raise WireFormatError(f"frame name {name!r} must be 1..255 bytes")
        if arr.ndim > _MAX_NDIM:
            raise WireFormatError(
                f"frame {name!r} has {arr.ndim} dims (bound {_MAX_NDIM})"
            )
        staged.append((name_b, dtype_b, arr))
        total += 1 + len(name_b) + 1 + len(dtype_b) + 1 + 8 * arr.ndim + 8
        total += arr.nbytes
    buf = bytearray(total)
    mv = memoryview(buf)
    pos = len(WIRE_MAGIC)
    buf[:pos] = WIRE_MAGIC
    buf[pos] = WIRE_VERSION
    buf[pos + 1] = len(staged)
    pos += 2
    for name_b, dtype_b, arr in staged:
        buf[pos] = len(name_b)
        pos += 1
        buf[pos : pos + len(name_b)] = name_b
        pos += len(name_b)
        buf[pos] = len(dtype_b)
        pos += 1
        buf[pos : pos + len(dtype_b)] = dtype_b
        pos += len(dtype_b)
        buf[pos] = arr.ndim
        pos += 1
        for dim in arr.shape:
            _U64.pack_into(buf, pos, dim)
            pos += 8
        _U64.pack_into(buf, pos, arr.nbytes)
        pos += 8
        if arr.nbytes:
            mv[pos : pos + arr.nbytes] = memoryview(arr).cast("B")
            pos += arr.nbytes
    return bytes(buf)


def unpack_frames(data: bytes) -> "Dict[str, np.ndarray]":
    """Parse a tensor body into ``{name: ndarray}`` (insertion-ordered).

    Zero-copy: every returned array is a read-only ``np.frombuffer`` view
    into ``data``. Raises :class:`WireFormatError` naming the violation
    for malformed magic, unknown version, disallowed dtypes, shape/payload
    size mismatches, truncation, and trailing bytes.
    """
    n = len(data)
    if n < len(WIRE_MAGIC) + 2:
        raise WireFormatError(f"body of {n} bytes is shorter than the header")
    if bytes(data[: len(WIRE_MAGIC)]) != WIRE_MAGIC:
        raise WireFormatError(
            f"bad magic {bytes(data[:len(WIRE_MAGIC)])!r} "
            f"(expected {WIRE_MAGIC!r})"
        )
    version = data[len(WIRE_MAGIC)]
    if version != WIRE_VERSION:
        raise WireFormatError(
            f"unsupported wire version {version} (this parser speaks "
            f"{WIRE_VERSION})"
        )
    n_frames = data[len(WIRE_MAGIC) + 1]
    if not 0 < n_frames <= _MAX_FRAMES:
        raise WireFormatError(
            f"frame count {n_frames} outside 1..{_MAX_FRAMES}"
        )
    mv = memoryview(data)
    pos = len(WIRE_MAGIC) + 2
    out: Dict[str, np.ndarray] = {}

    def take(count: int, what: str) -> int:
        nonlocal pos
        if pos + count > n:
            raise WireFormatError(
                f"truncated body: {what} needs {count} bytes at offset "
                f"{pos} but only {n - pos} remain"
            )
        start = pos
        pos += count
        return start

    for fi in range(n_frames):
        name_len = data[take(1, "frame name length")]
        start = take(name_len, "frame name")
        try:
            name = bytes(mv[start : start + name_len]).decode("utf-8")
        except UnicodeDecodeError as exc:
            raise WireFormatError(f"frame {fi} name is not utf-8: {exc}") from None
        dtype_len = data[take(1, "dtype length")]
        start = take(dtype_len, "dtype")
        dtype = _check_dtype(bytes(mv[start : start + dtype_len]).decode("ascii", "replace"))
        ndim = data[take(1, "ndim")]
        if ndim > _MAX_NDIM:
            raise WireFormatError(
                f"frame {name!r} declares {ndim} dims (bound {_MAX_NDIM})"
            )
        shape = tuple(
            _U64.unpack_from(mv, take(8, "shape dim"))[0] for _ in range(ndim)
        )
        nbytes = _U64.unpack_from(mv, take(8, "payload size"))[0]
        expected = int(np.prod(shape, dtype=object)) * dtype.itemsize if ndim else dtype.itemsize
        if nbytes != expected:
            raise WireFormatError(
                f"frame {name!r} payload size {nbytes} does not match "
                f"shape {shape} x {dtype.str} = {expected} bytes"
            )
        start = take(nbytes, f"frame {name!r} payload")
        arr = np.frombuffer(mv[start : start + nbytes], dtype=dtype)
        out[name] = arr.reshape(shape) if ndim else arr[0]
    if pos != n:
        raise WireFormatError(
            f"{n - pos} trailing bytes after the last frame (oversized body)"
        )
    return out


def rows_as_f32(arr: np.ndarray, name: str = "X") -> np.ndarray:
    """A wire frame as the (rows, features) float32 C-order array the
    scoring path wants, copying ONLY when the wire dtype/byte order
    actually differs (the native little-endian float32 fast path is the
    frombuffer view itself — zero copies between socket and scorer)."""
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    if arr.ndim != 2:
        raise WireFormatError(
            f"frame {name!r} must be 1-D or 2-D (rows x features), got "
            f"shape {arr.shape}"
        )
    if arr.dtype == np.float32 and arr.dtype.isnative:
        return arr
    # big-endian / wider floats / ints: one conversion copy, still vectorized
    return arr.astype(np.float32, order="C")
