"""Timestamps and resolutions without pandas: UTC ``datetime64[ns]``.

Configurations give dates as ISO-8601 strings (``"2020-01-01T00:00:00Z"``,
``"2017-12-25 06:00:00Z"``, an offset such as ``+01:00``, or naive, which
reads as UTC) and resolutions as pandas-style offsets (``"10min"``, the
reference-era ``"10T"``, ``"1h"``, ``"30s"``, ``"1d"``, and for resampling
pandas' calendar offsets: weeks, months, quarters, years and business days,
:func:`parse_resolution`). Data files and
InfluxDB answer with columns of such strings, which :func:`parse_times`
reads to int64 ns as ``pd.to_datetime(col, utc=True)`` does: a date, or a
date with ``HH:MM``, ``HH:MM:SS`` or ``HH:MM:SS.f`` (1 to 9 fractional
digits) after a ``T`` or a space, then ``Z``, ``±HH:MM``, ``±HHMM`` or
nothing (naive reads as UTC). Anything else raises ``ValueError``.
"""

import calendar
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
MONTHS = ("JAN", "FEB", "MAR", "APR", "MAY", "JUN", "JUL", "AUG", "SEP", "OCT", "NOV", "DEC")
_WEEKLY = re.compile(r"^(\d*)W(?:-([A-Z]{3}))?$")
_BUSINESS = re.compile(r"^\d*B$")
# pandas' month, quarter and year offsets, and business days
_CALENDAR = re.compile(r"^(\d*)(ME|MS|QE|QS|YE|YS|B)(?:-([A-Z]{3}))?$")
# pandas' other calendar offsets, which the port does not resample at
_NOT_PORTED = re.compile(r"^\d*(SME|SMS|BME|BMS|BQE|BQS|BYE|BYS|C|CBME|CBMS|bh|cbh)(-[A-Z0-9]+)?$")
# a fixed step's spellings, as pandas 3 reads them for the JAX package:
# pd.Timedelta (its fused path) takes a count and these units in any case,
_TIMEDELTA_UNITS = {
    **dict.fromkeys(("ns", "nano", "nanos", "nanosecond", "nanoseconds"), 1),
    **dict.fromkeys(("us", "micro", "micros", "microsecond", "microseconds"), 1_000),
    **dict.fromkeys(("ms", "milli", "millis", "millisecond", "milliseconds"), 1_000_000),
    **dict.fromkeys(("s", "sec", "second", "seconds"), _UNITS_NS["s"]),
    **dict.fromkeys(("min", "minute", "minutes"), _UNITS_NS["min"]),
    **dict.fromkeys(("h", "hr", "hour", "hours"), _UNITS_NS["h"]),
    **dict.fromkeys(("d", "day", "days"), _UNITS_NS["D"]),
}
# its offsets (the resample path) these, in this case (``MS`` is month start),
_OFFSET_UNITS = {"D": _UNITS_NS["D"], "d": _UNITS_NS["D"], "h": _UNITS_NS["h"], "s": _UNITS_NS["s"], "ms": 1_000_000}
# and these in any case
_OFFSET_UNITS_ANY_CASE = {"min": _UNITS_NS["min"], "us": 1_000, "ns": 1}
# pandas' default anchors: QE is QE-MAR's quarters (= QE-DEC's), QS QS-JAN, YE YE-DEC, YS YS-JAN
_DEFAULT_MONTH = {"QE": 3, "QS": 1, "YE": 12, "YS": 1}
# end-anchored offsets: closed and labelled right; the others left
RIGHT_CLOSED = ("ME", "QE", "YE", "W")


class Resolution(NamedTuple):
    """A resampling resolution: a fixed step (``step_ns``), or (``step_ns``
    0) a calendar offset ``calendar`` of ``n`` periods: ``ME``/``MS`` (month
    end, start), ``QE``/``QS`` and ``YE``/``YS`` anchored on ``month`` (1 =
    January), ``B`` (business days) or ``W`` anchored on ``weekday`` (0 =
    Monday). A fixed step's spelling says which of the JAX package's paths
    read it: ``timedelta``, ``pd.Timedelta`` (its fused path), and
    ``offset``, pandas' offsets (its resample path)."""

    step_ns: int
    weekday: Optional[int] = None
    calendar: Optional[str] = None
    n: int = 1
    month: Optional[int] = None
    timedelta: bool = True
    offset: bool = True


def parse_resolution(resolution: str) -> Resolution:
    """A fixed step, or one of pandas' calendar offsets the port resamples
    at: ``[n]W[-DAY]`` (``W`` is ``W-SUN``),
    ``[n]ME``, ``[n]MS``, ``[n]QE[-MON]``, ``[n]QS[-MON]``,
    ``[n]YE[-MON]``, ``[n]YS[-MON]`` and ``[n]B``, the spellings pandas
    accepts (not its retired ``M``, ``Q``, ``A`` or ``Y``, which raise
    ``ValueError`` there too). A fixed step takes the spellings either of
    pandas' parsers takes (``Resolution.timedelta``, ``.offset``: ``1H``
    only as ``pd.Timedelta`` reads it, ``h`` only as an offset); the
    legacy ``10T`` reads as ``10min``. pandas' other calendar offsets
    (semi-month, business month, quarter and year, custom business days) raise
    ``NotImplementedError`` naming them (business hours too); anything
    else ``ValueError``."""
    text = normalize_resolution(resolution.strip())
    if _WEEKLY.match(text.upper()) or _BUSINESS.match(text.upper()):
        text = text.upper()  # pandas still reads the deprecated lower-case w, w-mon and b
    m = _WEEKLY.match(text)
    if m:
        day = m.group(2) or "SUN"
        if day not in WEEKDAYS:
            raise ValueError(f"Unsupported resolution {resolution!r} (W-{'|'.join(WEEKDAYS)})")
        n = _count(m.group(1), resolution)
        return Resolution(0, WEEKDAYS.index(day), "W", n)
    m = _CALENDAR.match(text)
    if m:
        kind, anchor = m.group(2), m.group(3)
        if anchor is not None and (kind not in _DEFAULT_MONTH or anchor not in MONTHS):
            raise ValueError(f"Unsupported resolution {resolution!r} (anchors: {kind}-{'|'.join(MONTHS)})"
                             if kind in _DEFAULT_MONTH else f"Unsupported resolution {resolution!r}")
        month = MONTHS.index(anchor) + 1 if anchor else _DEFAULT_MONTH.get(kind)
        return Resolution(0, None, kind, _count(m.group(1), resolution), month)
    if _NOT_PORTED.match(text):
        raise NotImplementedError(
            f"resolution {resolution!r}: semi-month, business month, quarter and year, custom business day "
            "and business hour offsets are not resampled by the port")
    m = _OFFSET.match(text)
    if m:
        count, unit = m.group(1), m.group(2)
        td = _TIMEDELTA_UNITS.get(unit.lower()) if count else None
        off = _OFFSET_UNITS.get(unit, _OFFSET_UNITS_ANY_CASE.get(unit.lower()))
        if td is not None or off is not None:
            return Resolution(int(count or 1) * (td or off), timedelta=td is not None, offset=off is not None)
    raise ValueError(f"Unsupported resolution {resolution!r} (a count and one of {sorted(_TIMEDELTA_UNITS)}, or "
                     f"one of {sorted(_OFFSET_UNITS)} and {sorted(_OFFSET_UNITS_ANY_CASE)} in any case)")


def _count(digits: str, resolution: str) -> int:
    n = int(digits or 1)
    if n <= 0:
        raise ValueError(f"resolution {resolution!r}: the offset does not increment a date")
    return n


# ------------------------------------------------------------------ #
# calendar offsets, as pandas' offsets step a date
# ------------------------------------------------------------------ #


def _days_in_month(year: int, month: int) -> int:
    return calendar.monthrange(year, month)[1]


def _shift_month(d: datetime.date, months: int, day_opt: str) -> datetime.date:
    year, month0 = divmod(d.month - 1 + months, 12)
    year += d.year
    day = 1 if day_opt == "start" else _days_in_month(year, month0 + 1)
    return datetime.date(year, month0 + 1, day)


def _day_of_month(d: datetime.date, day_opt: str) -> int:
    return 1 if day_opt == "start" else _days_in_month(d.year, d.month)


def _roll_qtrday(d: datetime.date, n: int, month: int, day_opt: str, modby: int) -> int:
    """Periods to shift, as pandas' ``roll_qtrday`` rolls forward or back."""
    months_since = d.month % modby - month % modby if modby != 12 else d.month - month
    if n > 0:
        if months_since < 0 or (months_since == 0 and d.day < _day_of_month(d, day_opt)):
            n -= 1
    elif months_since > 0 or (months_since == 0 and d.day > _day_of_month(d, day_opt)):
        n += 1
    return n


def offset_apply(res: Resolution, d: datetime.date, n: int) -> datetime.date:
    """``d`` stepped ``n`` periods of ``res``'s calendar offset (pandas'
    ``Timestamp + n * offset`` at midnight)."""
    kind = res.calendar
    if kind == "W":
        k = n
        if d.weekday() != res.weekday:
            d = d + datetime.timedelta((res.weekday - d.weekday()) % 7)
            if k > 0:
                k -= 1
        return d + datetime.timedelta(weeks=k)
    if kind == "B":
        wday = d.weekday()
        weeks = n // 5
        if n <= 0 and wday > 4:
            n += 1
        n -= 5 * weeks
        if n == 0 and wday > 4:
            days = 4 - wday
        elif wday > 4:
            days = (7 - wday) + (n - 1)
        elif wday + n <= 4:
            days = n
        else:
            days = n + 2
        return d + datetime.timedelta(days=7 * weeks + days)
    day_opt = "end" if kind.endswith("E") else "start"
    if kind[0] == "M":
        compare = _day_of_month(d, day_opt)
        months = n
        if n > 0 and d.day < compare:
            months -= 1
        elif n <= 0 and d.day > compare:
            months += 1
    elif kind[0] == "Q":
        months = _roll_qtrday(d, n, res.month, day_opt, 3) * 3 - (d.month % 3 - res.month % 3)
    else:
        months = _roll_qtrday(d, n, res.month, day_opt, 12) * 12 + (res.month - d.month)
    return _shift_month(d, months, day_opt)


def on_offset(res: Resolution, d: datetime.date) -> bool:
    """Whether ``d`` is one of ``res``'s calendar dates."""
    kind = res.calendar
    if kind == "W":
        return d.weekday() == res.weekday
    if kind == "B":
        return d.weekday() < 5
    day = _day_of_month(d, "end" if kind.endswith("E") else "start")
    if kind[0] == "M":
        return d.day == day
    if kind[0] == "Q":
        return (d.month - res.month) % 3 == 0 and d.day == day
    return d.month == res.month and d.day == day


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
