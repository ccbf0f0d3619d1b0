"""Retained metric history: the flight recorder's time axis.

Counterpart of ``gordo_components_tpu/observability/timeseries.py``.
``/stats``, ``/metrics`` and ``/slo`` say what a value is now; the
:class:`HistoryStore` keeps what it was over the last hours, in process.

- A sampler (the server's thread; this module owns the store) calls
  :meth:`HistoryStore.sample` every ``GORDO_HISTORY_INTERVAL_S`` (10 s).
  A sample copies every series' value out of the registry under its lock
  (histograms as their count and sum), then releases the lock before the
  store's own work, so the engine never waits on more than that copy.
- Tiered rings (``GORDO_HISTORY_TIERS``, default ``10s@15m,1m@6h``):
  tier 0 holds the raw samples, a coarser tier the averages of
  ``period / interval`` of them. Each tier is a fixed ring of
  ``array('d')`` columns sharing one write index; a series admitted late
  reads NaN before it was first seen.
- Counters become per-second rates (``<name>:rate``): a negative delta is
  a reset (a swap, a restart) and reads as the new total, so a rate is
  never negative. Gauges are stored raw; a histogram gives
  ``_count:rate`` and ``_sum:rate``.
- A strict memory bound (``GORDO_HISTORY_MAX_MB``, 8): the bytes a
  series takes across the tiers are known at construction, which caps
  the series admitted; past the cap a new series is dropped and counted.

Off by default (``GORDO_HISTORY=1`` turns it on); off, there is no store.
Timestamps come from the app's clock seam.
"""

import math
import os
import threading
from array import array
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from gordo_components_torch.replay.clock import SYSTEM_CLOCK, Clock

__all__ = ["HistoryStore", "history_from_env", "parse_tiers"]

_NAN = float("nan")

DEFAULT_INTERVAL_S = 10.0
DEFAULT_TIERS = "10s@15m,1m@6h"
DEFAULT_MAX_MB = 8.0

# a series' bookkeeping beyond its rings: the key string, dict slots and
# one array header a tier
_SERIES_OVERHEAD_BYTES = 256


def _parse_duration(raw: str) -> float:
    """``'10s' | '15m' | '6h' | '90'`` -> seconds (a bare number is s)."""
    raw = raw.strip().lower()
    mult = 1.0
    if raw.endswith(("s", "m", "h")):
        mult = {"s": 1.0, "m": 60.0, "h": 3600.0}[raw[-1]]
        raw = raw[:-1]
    try:
        val = float(raw) * mult
    except ValueError:
        raise ValueError(f"bad duration {raw!r} (want e.g. 10s, 15m, 6h)") from None
    if val <= 0:
        raise ValueError(f"duration must be > 0, got {val}")
    return val


def parse_tiers(spec: str) -> List[Tuple[float, float]]:
    """``'10s@15m,1m@6h'`` -> ``[(period_s, retain_s), ...]``, finest
    first; retention must grow with the period."""
    tiers: List[Tuple[float, float]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "@" not in part:
            raise ValueError(f"bad tier {part!r} (want <period>@<retention>)")
        period_raw, retain_raw = part.split("@", 1)
        period, retain = _parse_duration(period_raw), _parse_duration(retain_raw)
        if retain < period:
            raise ValueError(f"tier {part!r}: retention shorter than period")
        tiers.append((period, retain))
    if not tiers:
        raise ValueError(f"no tiers in {spec!r}")
    tiers.sort(key=lambda t: t[0])
    for (p0, r0), (p1, r1) in zip(tiers, tiers[1:]):
        if r1 < r0:
            raise ValueError(f"tier retentions must grow with period ({r1} < {r0})")
    return tiers


class _Tier:
    """One resolution: a ring of times and one of values a series; a slot
    averages ``factor`` raw samples (1: the raw tier)."""

    __slots__ = ("period_s", "retain_s", "factor", "capacity", "times", "columns", "idx", "size",
                 "_acc", "_acc_t", "_acc_n")

    def __init__(self, period_s: float, retain_s: float, factor: int):
        self.period_s = period_s
        self.retain_s = retain_s
        self.factor = max(1, int(factor))
        self.capacity = max(2, int(math.ceil(retain_s / period_s)))
        self.times = array("d", [_NAN] * self.capacity)
        self.columns: Dict[str, array] = {}
        self.idx = 0  # the next slot
        self.size = 0
        self._acc: Dict[str, List[float]] = {}  # key -> [sum, count]
        self._acc_t = 0.0
        self._acc_n = 0

    def admit(self, key: str) -> None:
        self.columns[key] = array("d", [_NAN] * self.capacity)

    def offer(self, t: float, values: Dict[str, float]) -> None:
        """One raw sample; a slot lands every ``factor`` of them, stamped
        with its last sample's time, NaNs left out of its averages."""
        if self.factor == 1:
            self._push(t, values)
            return
        self._acc_t = t
        self._acc_n += 1
        acc = self._acc
        for key, v in values.items():
            if v != v:
                continue
            cell = acc.get(key)
            if cell is None:
                acc[key] = [v, 1.0]
            else:
                cell[0] += v
                cell[1] += 1.0
        if self._acc_n >= self.factor:
            self._push(self._acc_t, {k: s / n for k, (s, n) in acc.items() if n})
            acc.clear()
            self._acc_n = 0

    def _push(self, t: float, values: Dict[str, float]) -> None:
        i = self.idx
        self.times[i] = t
        for key, col in self.columns.items():
            col[i] = values.get(key, _NAN)
        self.idx = (i + 1) % self.capacity
        if self.size < self.capacity:
            self.size += 1

    def points(self, key: str) -> Iterable[Tuple[float, float]]:
        """(t, value) oldest first; a value may be NaN."""
        col = self.columns.get(key)
        if col is None or self.size == 0:
            return
        start = (self.idx - self.size) % self.capacity
        for off in range(self.size):
            i = (start + off) % self.capacity
            yield self.times[i], col[i]

    def oldest_time(self) -> Optional[float]:
        if self.size == 0:
            return None
        return self.times[(self.idx - self.size) % self.capacity]

    def describe(self) -> Dict[str, Any]:
        return {"period_s": self.period_s, "retain_s": self.retain_s, "capacity": self.capacity,
                "size": self.size}


def _series_key(name: str, labels: Dict[str, str]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


def _registry_values(registry) -> List[Tuple[str, str, List[Tuple[Dict[str, str], Any]]]]:
    """Every series of ``registry`` as (name, type, [(labels, value)]),
    copied under its lock: a histogram as its (count, sum)."""
    out = []
    with registry._lock:
        for name, (mtype, _help, samples) in registry._all_samples().items():
            rows = []
            for labels, value in samples:
                if hasattr(value, "buckets"):
                    rows.append((labels, (float(value.count), float(value.sum))))
                else:
                    rows.append((labels, value))
            out.append((name, mtype, rows))
    return out


class HistoryStore:
    """Bounded in-process history of one metrics registry, under a lock
    (the sampler thread writes while requests read)."""

    def __init__(self, registry, *, interval_s: float = DEFAULT_INTERVAL_S,
                 tiers: Optional[Sequence[Tuple[float, float]]] = None, max_mb: float = DEFAULT_MAX_MB,
                 clock: Clock = SYSTEM_CLOCK):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.registry = registry
        self.clock = clock
        self.interval_s = float(interval_s)
        spec = tiers if tiers is not None else parse_tiers(DEFAULT_TIERS)
        self.tiers: List[_Tier] = []
        for period_s, retain_s in spec:
            factor = max(1, int(round(period_s / self.interval_s)))
            self.tiers.append(_Tier(factor * self.interval_s, retain_s, factor))
        self.max_bytes = int(float(max_mb) * (1 << 20))
        self._bytes_per_series = _SERIES_OVERHEAD_BYTES + sum(t.capacity * 8 for t in self.tiers)
        base = sum(t.capacity * 8 for t in self.tiers)  # the time rings
        self.max_series = max(0, (self.max_bytes - base) // self._bytes_per_series)
        self._lock = threading.Lock()
        self._keys: Dict[str, str] = {}  # key -> "gauge" | "rate"
        self._prev: Dict[str, Tuple[float, float]] = {}  # key -> (t, cumulative)
        self.samples_taken = 0
        self.dropped_series = 0

    def _admit(self, key: str, kind: str) -> bool:
        if key in self._keys:
            return True
        if len(self._keys) >= self.max_series:
            self.dropped_series += 1
            return False
        self._keys[key] = kind
        for tier in self.tiers:
            tier.admit(key)
        return True

    def sample(self) -> None:
        """One sample of the registry into every tier, rates derived here
        (the coarse tiers average rates)."""
        t = self.clock.time()
        raw = _registry_values(self.registry)
        out: Dict[str, float] = {}
        with self._lock:
            prev = self._prev
            for name, mtype, samples in raw:
                for labels, value in samples:
                    if isinstance(value, tuple):  # a histogram's (count, sum)
                        base = _series_key(name, labels)
                        for suffix, cum in zip(("_count", "_sum"), value):
                            self._rate(f"{base}{suffix}:rate", t, cum, prev, out)
                        continue
                    try:
                        v = float(value)
                    except (TypeError, ValueError):
                        continue
                    key = _series_key(name, labels)
                    if mtype == "counter":
                        self._rate(f"{key}:rate", t, v, prev, out)
                    elif self._admit(key, "gauge"):
                        out[key] = v
            for tier in self.tiers:
                tier.offer(t, out)
            self.samples_taken += 1

    def _rate(self, key: str, t: float, cum: float, prev: Dict[str, Tuple[float, float]],
              out: Dict[str, float]) -> None:
        last = prev.get(key)
        prev[key] = (t, cum)
        if last is None:
            return  # first sight: no interval yet
        t0, v0 = last
        dt = t - t0
        if dt <= 0:
            return
        delta = cum - v0
        if delta < 0:
            delta = cum  # a reset: the new total is the delta
        if self._admit(key, "rate"):
            out[key] = delta / dt

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._keys)

    def _pick_tier(self, since: Optional[float], step: Optional[float]) -> _Tier:
        """The finest tier no finer than ``step`` that reaches back to
        ``since``; else the coarsest."""
        candidates = [t for t in self.tiers if step is None or t.period_s >= step or t is self.tiers[-1]] \
            or self.tiers
        if since is not None:
            for tier in candidates:
                oldest = tier.oldest_time()
                if oldest is not None and oldest <= since:
                    return tier
        return candidates[0] if since is None else candidates[-1]

    def query(self, series: Sequence[str], since: Optional[float] = None, until: Optional[float] = None,
              step: Optional[float] = None) -> Dict[str, Any]:
        """``{series: {tier, period_s, points: [[t, v or None], ...]}}``; a
        name without labels matches every retained series of that metric,
        an unknown one gets no points."""
        requested: List[str] = []
        with self._lock:
            for name in series:
                if name in self._keys or "{" in name:
                    requested.append(name)
                else:
                    expanded = sorted(k for k in self._keys if k.split("{", 1)[0] == name)
                    requested.extend(expanded if expanded else [name])
            tier = self._pick_tier(since, step)
            out: Dict[str, Any] = {}
            for key in requested:
                pts: List[List[Optional[float]]] = []
                last_t: Optional[float] = None
                for t, v in tier.points(key):
                    if t != t:
                        continue
                    if since is not None and t < since:
                        continue
                    if until is not None and t > until:
                        continue
                    if step is not None and step > tier.period_s and last_t is not None and t - last_t < step:
                        continue
                    last_t = t
                    pts.append([t, None if v != v else v])
                out[key] = {"tier": self.tiers.index(tier), "period_s": tier.period_s, "points": pts}
            return out

    def memory_bytes(self) -> int:
        """The retained bytes' upper bound, held under ``max_bytes``."""
        with self._lock:
            n = len(self._keys)
        return sum(t.capacity * 8 for t in self.tiers) + n * self._bytes_per_series

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": True,
                "interval_s": self.interval_s,
                "max_bytes": self.max_bytes,
                "max_series": self.max_series,
                "n_series": len(self._keys),
                "dropped_series": self.dropped_series,
                "samples": self.samples_taken,
                "memory_bytes": sum(t.capacity * 8 for t in self.tiers) + len(self._keys) * self._bytes_per_series,
                "tiers": [t.describe() for t in self.tiers],
            }

    def attach_registry(self) -> None:
        """The store's own series in the registry it samples (plain
        attribute reads: no wait on the store's lock)."""

        def collect():
            yield ("gordo_history_series", "gauge", "Series currently retained by the history store", {},
                   float(len(self._keys)))
            yield ("gordo_history_samples_total", "counter", "History sampler passes completed", {},
                   float(self.samples_taken))
            yield ("gordo_history_dropped_series_total", "counter", "Series rejected by the history memory bound",
                   {}, float(self.dropped_series))

        self.registry.collector(collect, key="history")


def history_from_env(registry, clock: Clock = SYSTEM_CLOCK) -> Optional[HistoryStore]:
    """A store configured from ``GORDO_HISTORY_INTERVAL_S``,
    ``GORDO_HISTORY_TIERS`` and ``GORDO_HISTORY_MAX_MB`` when
    ``GORDO_HISTORY`` is on (1, true, yes, on), else None."""
    if os.environ.get("GORDO_HISTORY", "").strip().lower() not in ("1", "true", "yes", "on"):
        return None
    interval = float(os.environ.get("GORDO_HISTORY_INTERVAL_S") or DEFAULT_INTERVAL_S)
    tiers = parse_tiers(os.environ.get("GORDO_HISTORY_TIERS") or DEFAULT_TIERS)
    max_mb = float(os.environ.get("GORDO_HISTORY_MAX_MB") or DEFAULT_MAX_MB)
    store = HistoryStore(registry, interval_s=interval, tiers=tiers, max_mb=max_mb, clock=clock)
    store.attach_registry()
    return store
