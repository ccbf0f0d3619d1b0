"""A decoder of raw snappy blocks, with the standard library.

Parquet's SNAPPY codec compresses each page as one raw snappy block (not
the framed stream format). A block is the uncompressed length as a varint,
then elements, each led by a tag byte whose low two bits say what it is:

- ``00`` a literal: its length less one is the tag's upper six bits, or,
  for 60-63, the 1-4 little-endian bytes that follow; the bytes follow;
- ``01`` a copy of 4-11 bytes (``4 + (tag >> 2 & 7)``) from an 11-bit
  offset (the tag's top three bits and one byte);
- ``10`` and ``11`` a copy of ``1 + (tag >> 2)`` bytes from a 2- or 4-byte
  little-endian offset.

A copy reads from ``offset`` bytes back in what is written so far; where
the offset is shorter than the length, it repeats the bytes it has just
written. Literals are copied as slices, so float data, which is mostly
literals, decodes at memory speed. A corrupt block raises ``ValueError``:
an offset of 0 or beyond the start, an element past the end of the input,
or an output of another length than the block declares.
"""


def _varint(buf, pos: int):
    shift = result = 0
    while True:
        if pos >= len(buf):
            raise ValueError("snappy: truncated length")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 31:
            raise ValueError("snappy: length varint longer than 5 bytes")


def decompress(buf) -> bytes:
    """The bytes a raw snappy block encodes."""
    buf = memoryview(buf)
    size, pos = _varint(buf, 0)
    end = len(buf)
    out = bytearray()
    op = 0  # len(out), kept by hand: the loop runs once an element
    while pos < end:
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:
            n = tag >> 2
            if n >= 60:
                width = n - 59
                if pos + width > end:
                    raise ValueError("snappy: truncated literal length")
                n = int.from_bytes(buf[pos:pos + width], "little")
                pos += width
            n += 1
            if pos + n > end:
                raise ValueError("snappy: literal runs past the end of the input")
            out += buf[pos:pos + n]
            pos += n
        else:
            if kind == 1:
                if pos >= end:
                    raise ValueError("snappy: truncated copy")
                n = 4 + ((tag >> 2) & 7)
                offset = ((tag >> 5) << 8) | buf[pos]
                pos += 1
            elif kind == 2:
                if pos + 2 > end:
                    raise ValueError("snappy: truncated copy")
                n = 1 + (tag >> 2)
                offset = buf[pos] | (buf[pos + 1] << 8)
                pos += 2
            else:
                if pos + 4 > end:
                    raise ValueError("snappy: truncated copy")
                n = 1 + (tag >> 2)
                offset = int.from_bytes(buf[pos:pos + 4], "little")
                pos += 4
            start = op - offset
            if offset == 0 or start < 0:
                raise ValueError(f"snappy: copy offset {offset} at output position {op}")
            if offset >= n:
                out += out[start:start + n]
            else:  # the copy overlaps what it writes: the last `offset` bytes repeat
                out += (out[start:] * (n // offset + 1))[:n]
        op += n
        if op > size:
            raise ValueError(f"snappy: output exceeds the declared {size} bytes")
    if op != size:
        raise ValueError(f"snappy: decoded {op} bytes, the block declares {size}")
    return bytes(out)
