"""Timestamps and resolutions without pandas: UTC ``datetime64[ns]``.

Configurations give dates as ISO-8601 strings (``"2020-01-01T00:00:00Z"``,
``"2017-12-25 06:00:00Z"``, an offset such as ``+01:00``, or naive, which
reads as UTC) and resolutions as pandas-style offsets (``"10min"``, the
reference-era ``"10T"``, ``"1h"``, ``"30s"``, ``"1d"``, and for resampling
the weekly ``"W"`` and ``"W-MON"`` ... ``"W-SUN"``: :func:`parse_resolution`). Data files and
InfluxDB answer with columns of such strings, which :func:`parse_times`
reads to int64 ns as ``pd.to_datetime(col, utc=True)`` does: a date, or a
date with ``HH:MM``, ``HH:MM:SS`` or ``HH:MM:SS.f`` (1 to 9 fractional
digits) after a ``T`` or a space, then ``Z``, ``±HH:MM``, ``±HHMM`` or
nothing (naive reads as UTC). Anything else raises ``ValueError``.
"""

import datetime
import re
from typing import NamedTuple, Optional

import numpy as np

_UNITS_NS = {
    "ns": 1, "us": 1_000, "ms": 1_000_000, "s": 1_000_000_000, "S": 1_000_000_000,
    "sec": 1_000_000_000, "min": 60_000_000_000, "T": 60_000_000_000,
    "h": 3_600_000_000_000, "H": 3_600_000_000_000,
    "d": 86_400_000_000_000, "D": 86_400_000_000_000,
}
_OFFSET = re.compile(r"^(\d*)\s*([A-Za-z]+)$")
_ISO = re.compile(
    r"(?P<date>\d{4}-\d{2}-\d{2})"
    r"(?:[T ](?P<time>\d{2}:\d{2}(?::\d{2}(?:\.\d{1,9})?)?))?"
    r"(?P<tz>Z|(?P<sign>[+-])(?P<oh>\d{2}):?(?P<om>\d{2}))?"
)
_MINUTE_NS = 60_000_000_000


def _offset_ns(m) -> int:
    if not m.group("sign"):
        return 0
    minutes = int(m.group("oh")) * 60 + int(m.group("om"))
    return (minutes if m.group("sign") == "+" else -minutes) * _MINUTE_NS


def _local(m) -> str:
    return m.group("date") + "T" + m.group("time") if m.group("time") else m.group("date")


def _match(text: str):
    m = _ISO.fullmatch(text)
    if m is None:
        raise ValueError(f"not an ISO 8601 timestamp: {text!r}")
    return m


def _local_ns(local: np.ndarray) -> np.ndarray:
    try:
        return local.astype("datetime64[ns]").astype(np.int64)
    except ValueError as exc:  # the shape matched, a field is out of range
        raise ValueError(f"not a valid timestamp: {exc}") from None


def _uniform_ns(raw: np.ndarray, first) -> np.ndarray:
    """:func:`parse_times` for strings of one length that have the first
    string's shape (digits where it has digits, its other characters
    elsewhere): checked and parsed column by column; None when some
    string's shape differs."""
    width = raw.dtype.itemsize
    mat = raw.view(np.uint8).reshape(raw.size, width)
    template = np.frombuffer(raw[0], np.uint8)
    digit = (template >= 48) & (template <= 57)
    if not (((mat[:, digit] >= 48) & (mat[:, digit] <= 57)).all()
            and (mat[:, ~digit] == template[~digit]).all()):
        return None
    cut = first.end("time") if first.group("time") else first.end("date")
    local = np.ascontiguousarray(mat[:, :cut]).view(f"S{cut}").ravel()
    ns = _local_ns(local)
    if first.group("sign"):
        oh, om = first.start("oh"), first.start("om")
        d = mat[:, [oh, oh + 1, om, om + 1]].astype(np.int64) - 48
        minutes = (d[:, 0] * 10 + d[:, 1]) * 60 + d[:, 2] * 10 + d[:, 3]
        ns -= (minutes if first.group("sign") == "+" else -minutes) * _MINUTE_NS
    return ns


def parse_times(values) -> np.ndarray:
    """int64 ns since the epoch (UTC) of a column of ISO 8601 strings, as
    ``pd.to_datetime(values, utc=True)`` gives them, to the nanosecond.
    A column whose strings all share one shape (a data file's, an
    InfluxDB answer's) is parsed without a loop over its strings."""
    values = list(values)
    if not values:
        return np.empty(0, np.int64)
    first = _match(values[0])
    try:
        raw = np.array(values, dtype="S")
    except UnicodeEncodeError:
        raw = None
    if raw is not None and not (raw.view(np.uint8).reshape(raw.size, -1)[:, -1] == 0).any():
        ns = _uniform_ns(raw, first)
        if ns is not None:
            return ns
    matches = [_match(v) for v in values]
    local = np.array([_local(m) for m in matches])
    return _local_ns(local) - np.array([_offset_ns(m) for m in matches], np.int64)


_EPOCH = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


def _epoch_plus(ns: int) -> datetime.datetime:
    """The aware UTC datetime of ``ns``, to the microsecond."""
    return _EPOCH + datetime.timedelta(microseconds=ns // 1000)


def to_ns(value) -> int:
    """Nanoseconds since the epoch (UTC) of a timestamp: an ISO 8601
    string (:func:`parse_times`' forms), a ``datetime64``, or a datetime
    (its ``nanosecond``, where it has one, as a pandas Timestamp does)."""
    if isinstance(value, str):
        m = _match(value.strip())
        return int(_local_ns(np.array([_local(m)]))[0]) - _offset_ns(m)
    if isinstance(value, np.datetime64):
        return int(value.astype("datetime64[ns]").astype(np.int64))
    if not isinstance(value, datetime.datetime):
        raise TypeError(f"not a timestamp: {value!r}")
    if value.tzinfo is None:
        value = value.replace(tzinfo=datetime.timezone.utc)
    delta = value - _EPOCH
    return ((delta.days * 86_400 + delta.seconds) * 1_000_000_000 + delta.microseconds * 1_000
            + int(getattr(value, "nanosecond", 0)))


def resolution_ns(resolution: str) -> int:
    """A fixed offset string (``"10min"``, ``"10T"``, ``"1h"``) in ns."""
    m = _OFFSET.match(resolution.strip())
    if not m or m.group(2) not in _UNITS_NS:
        raise ValueError(f"Unsupported resolution {resolution!r} (a count and one of {sorted(_UNITS_NS)})")
    return int(m.group(1) or 1) * _UNITS_NS[m.group(2)]


WEEKDAYS = ("MON", "TUE", "WED", "THU", "FRI", "SAT", "SUN")
_WEEKLY = re.compile(r"^(\d*)W(?:-([A-Z]{3}))?$")
# pandas' calendar offsets, which the port does not resample at
_CALENDAR = re.compile(
    r"^\d*(M|ME|MS|SM|SME|SMS|BM|BME|BMS|CBM|CBME|CBMS|Q|QE|QS|BQ|BQE|BQS|A|AS|Y|YE|YS|BA|BAS|BY|BYE|BYS|"
    r"B|C|BH|CBH)(-[A-Z]{3})?$")


class Resolution(NamedTuple):
    """A resampling resolution: a fixed step, or one week anchored on
    ``weekday`` (0 = Monday), whose bins end on that day and are labelled
    by it (pandas' ``W-<day>``, closed and labelled right)."""

    step_ns: int
    weekday: Optional[int] = None


def parse_resolution(resolution: str) -> Resolution:
    """A fixed offset (:func:`resolution_ns`) or ``W`` (``W-SUN``),
    ``W-MON`` ... ``W-SUN``. pandas' calendar offsets (month, quarter, year,
    business days) and multi-week anchors raise ``NotImplementedError``
    naming them; anything else ``ValueError``."""
    text = normalize_resolution(resolution.strip())
    m = _WEEKLY.match(text)
    if m:
        if m.group(1) not in ("", "1"):
            raise NotImplementedError(f"resolution {resolution!r}: the port resamples at one-week anchors only")
        day = m.group(2) or "SUN"
        if day not in WEEKDAYS:
            raise ValueError(f"Unsupported resolution {resolution!r} (W-{'|'.join(WEEKDAYS)})")
        return Resolution(7 * _UNITS_NS["D"], WEEKDAYS.index(day))
    if _CALENDAR.match(text):
        raise NotImplementedError(
            f"resolution {resolution!r}: calendar offsets (month, quarter, year, business days) are not "
            "resampled by the port")
    return Resolution(resolution_ns(text))


def normalize_resolution(resolution: str) -> str:
    """Reference-era pandas offsets (``'10T'``) as modern ones (``'10min'``)."""
    if resolution and resolution[-1] == "T" and resolution[:-1].isdigit():
        return resolution[:-1] + "min"
    return resolution


def isoformat(ns: int) -> str:
    """``2020-01-01T00:00:00+00:00`` for a UTC ns timestamp, with the
    fraction pandas' ``Timestamp.isoformat`` writes (6 digits, or 9 where
    the nanoseconds are not whole microseconds)."""
    text = _epoch_plus(int(ns)).isoformat()
    if ns % 1000:
        head, _, tz = text.rpartition("+")
        head = head.split(".")[0] + f".{(int(ns) % 1_000_000_000):09d}"
        text = f"{head}+{tz}"
    return text


def timestamp_text(ns: int) -> str:
    """``str(pd.Timestamp(ns, tz="UTC"))``: ``2020-01-01 00:10:00+00:00``,
    with :func:`isoformat`'s fraction."""
    return isoformat(ns).replace("T", " ", 1)


def timestamp_texts(index: np.ndarray) -> list:
    """:func:`timestamp_text` of every value of a ``datetime64`` array."""
    return [timestamp_text(int(n)) for n in np.asarray(index).astype("datetime64[ns]").view(np.int64)]
