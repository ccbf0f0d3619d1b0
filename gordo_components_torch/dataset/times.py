"""Timestamps and resolutions without pandas: UTC ``datetime64[ns]``.

Configurations give dates as ISO-8601 strings (``"2020-01-01T00:00:00Z"``,
``"2017-12-25 06:00:00Z"``, an offset such as ``+01:00``, or naive, which
reads as UTC) and resolutions as pandas-style offsets (``"10min"``, the
reference-era ``"10T"``, ``"1h"``, ``"30s"``, ``"1d"``).
"""

import datetime
import re

import numpy as np

_UNITS_NS = {
    "ns": 1, "us": 1_000, "ms": 1_000_000, "s": 1_000_000_000, "S": 1_000_000_000,
    "sec": 1_000_000_000, "min": 60_000_000_000, "T": 60_000_000_000,
    "h": 3_600_000_000_000, "H": 3_600_000_000_000,
    "d": 86_400_000_000_000, "D": 86_400_000_000_000,
}
_OFFSET = re.compile(r"^(\d*)\s*([A-Za-z]+)$")


def to_datetime(value) -> datetime.datetime:
    """An aware UTC datetime from an ISO string, a datetime or a
    ``datetime64`` (naive values read as UTC)."""
    if isinstance(value, np.datetime64):
        value = value.astype("datetime64[us]").item()
    if isinstance(value, str):
        value = datetime.datetime.fromisoformat(value.strip())
    if not isinstance(value, datetime.datetime):
        raise TypeError(f"not a timestamp: {value!r}")
    if value.tzinfo is None:
        return value.replace(tzinfo=datetime.timezone.utc)
    return value.astimezone(datetime.timezone.utc)


def to_ns(value) -> int:
    """Nanoseconds since the epoch (UTC) of a timestamp."""
    dt = to_datetime(value)
    epoch = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
    delta = dt - epoch
    return (delta.days * 86_400 + delta.seconds) * 1_000_000_000 + delta.microseconds * 1_000


def resolution_ns(resolution: str) -> int:
    """A fixed offset string (``"10min"``, ``"10T"``, ``"1h"``) in ns."""
    m = _OFFSET.match(resolution.strip())
    if not m or m.group(2) not in _UNITS_NS:
        raise ValueError(f"Unsupported resolution {resolution!r} (a count and one of {sorted(_UNITS_NS)})")
    return int(m.group(1) or 1) * _UNITS_NS[m.group(2)]


def normalize_resolution(resolution: str) -> str:
    """Reference-era pandas offsets (``'10T'``) as modern ones (``'10min'``)."""
    if resolution and resolution[-1] == "T" and resolution[:-1].isdigit():
        return resolution[:-1] + "min"
    return resolution


def isoformat(ns: int) -> str:
    """``2020-01-01T00:00:00+00:00`` for a UTC ns timestamp (what pandas'
    ``Timestamp.isoformat`` writes for whole seconds)."""
    return to_datetime(np.datetime64(int(ns), "ns")).isoformat()
