"""Dependency-free metrics registry with Prometheus text exposition.

Counterpart of ``gordo_components_tpu/observability/metrics.py``: the same
log-binned :class:`Histogram` (same bin edges), labeled counter, gauge and
histogram families, read-at-render-time collectors, the per-metric series
cap (``GORDO_METRIC_MAX_SERIES``), and the same exposition text byte for
byte (escaping, ``+Inf``/``NaN``, cumulative ``le`` buckets, family
order), so a scrape of the port reads as a scrape of the JAX server.

Threads: where the JAX server mutates its metrics on one event-loop
thread, the port's server answers each connection on its own thread and
scores on the engine's. So every mutation runs under a lock. A registry's
cells (its families' children) share the registry's re-entrant lock, which
:meth:`MetricsRegistry.render` and :meth:`MetricsRegistry.snapshot` hold
for the whole read: a scrape sees one state. A :class:`Histogram` made
outside a registry has a lock of its own. The hot path pays one
uncontended lock acquire per record.
"""

import math
import os
import re
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Histogram",
    "LATENCY_BINS_PER_DECADE",
    "MetricFamily",
    "MetricsRegistry",
    "get_registry",
    "parse_prometheus_text",
    "render_samples",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# 50 us .. 100 s at 10 bins a decade, overflow above (the JAX defaults)
_DEF_LO = 5e-5
_DEF_HI = 100.0
_DEF_BPD = 10

# latency histograms' resolution (server.stats.LatencyHistogram): 32 bins
# a decade bound a percentile's error at 10^(1/32) - 1, about 7.5%
LATENCY_BINS_PER_DECADE = 32

# per-metric labeled-series cap: a family that would grow past it hands
# back a detached child and counts the drop instead
_DEF_MAX_SERIES = 1024


class Histogram:
    """Log-spaced fixed-bin histogram with percentile reads.

    Values at or below ``lo`` land in bin 0, values above ``hi`` in the
    overflow bin, where the exact ``max`` is the only upper bound. Every
    method runs under ``lock`` (a lock of its own unless one is given)."""

    __slots__ = ("counts", "count", "sum", "max", "_lo", "_log_lo", "_bpd", "_n_bins", "_lock")

    def __init__(self, lo: float = _DEF_LO, hi: float = _DEF_HI, bins_per_decade: int = _DEF_BPD,
                 lock=None):
        if lo <= 0 or hi <= lo:
            raise ValueError(f"need 0 < lo < hi, got lo={lo!r} hi={hi!r}")
        self._lo = float(lo)
        self._bpd = int(bins_per_decade)
        self._n_bins = int(math.ceil(math.log10(hi / lo) * self._bpd)) + 1
        self._log_lo = math.log10(lo)
        # re-entrant: the reads call one another under it
        self._lock = lock if lock is not None else threading.RLock()
        self.counts = [0] * (self._n_bins + 1)  # +1: overflow bin
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def _idx(self, value: float) -> int:
        """Bin index of ``value``: the one copy of the log-bin math."""
        if value <= self._lo:
            return 0
        return min(self._n_bins, 1 + int((math.log10(value) - self._log_lo) * self._bpd))

    def record(self, value: float) -> None:
        if value < 0:  # clock weirdness must not corrupt the histogram
            value = 0.0
        i = self._idx(value)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += value
            if value > self.max:
                self.max = value

    def _edge(self, i: int) -> float:
        """Upper edge of bin i (i < n_bins)."""
        return 10 ** (self._log_lo + i / self._bpd)

    def bucket_le(self, value: float) -> float:
        """Upper edge of the bucket ``record(value)`` lands in (``inf`` for
        the overflow bin), as :meth:`buckets` gives the edges."""
        if value <= self._lo:
            return self._lo
        idx = self._idx(value)
        return math.inf if idx >= self._n_bins else self._edge(idx)

    def count_le(self, value: float) -> int:
        """Observations at or below the bucket holding ``value``."""
        with self._lock:
            return sum(self.counts[: self._idx(value) + 1])

    def percentile(self, q: float) -> float:
        """Upper edge of the bin holding the q-quantile observation, at
        most the exact max; 0.0 when empty. q >= 1 gives the max, q <= 0
        the first observation's bin."""
        with self._lock:
            if self.count == 0:
                return 0.0
            if q >= 1.0:
                return self.max
            rank = max(1.0, q * self.count)
            seen = 0
            for i, c in enumerate(self.counts):
                if not c:
                    continue
                seen += c
                if seen >= rank:
                    if i >= self._n_bins:
                        return self.max  # overflow bin: max bounds it
                    return min(self.max, self._edge(i))
            return self.max

    def snapshot(self) -> dict:
        """Summary in milliseconds (the serving ``/stats`` body)."""
        with self._lock:
            if self.count == 0:
                return {"count": 0}
            ms = 1e3
            return {
                "count": self.count,
                "mean_ms": round(self.sum / self.count * ms, 3),
                "p50_ms": round(self.percentile(0.50) * ms, 3),
                "p95_ms": round(self.percentile(0.95) * ms, 3),
                "p99_ms": round(self.percentile(0.99) * ms, 3),
                "max_ms": round(self.max * ms, 3),
            }

    def summary(self) -> dict:
        """Summary in raw units (for histograms that are not latencies)."""
        with self._lock:
            if self.count == 0:
                return {"count": 0}
            return {
                "count": self.count,
                "sum": round(self.sum, 6),
                "mean": round(self.sum / self.count, 6),
                "p50": round(self.percentile(0.50), 6),
                "p95": round(self.percentile(0.95), 6),
                "p99": round(self.percentile(0.99), 6),
                "max": round(self.max, 6),
            }

    def buckets(self) -> List[Tuple[float, int]]:
        """Cumulative (upper_edge, count) pairs for exposition; the last
        edge is ``inf`` and carries the total count."""
        with self._lock:
            out: List[Tuple[float, int]] = []
            cum = 0
            for i in range(self._n_bins):
                cum += self.counts[i]
                out.append((self._lo if i == 0 else self._edge(i), cum))
            out.append((math.inf, cum + self.counts[self._n_bins]))
            return out

    def _read(self) -> Tuple[List[Tuple[float, int]], float, int]:
        """(buckets, sum, count) from one state."""
        with self._lock:
            return self.buckets(), self.sum, self.count


class _Value:
    """One labeled counter or gauge series."""

    __slots__ = ("value", "_fn", "_lock")

    def __init__(self, lock):
        self.value = 0
        self._fn: Optional[Callable[[], float]] = None
        self._lock = lock

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self.value += n

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v

    def set_function(self, fn: Callable[[], float]) -> None:
        """Read-through series: ``fn()`` is called at render time instead
        of storing a mirrored value."""
        with self._lock:
            self._fn = fn

    def get(self) -> float:
        fn = self._fn
        if fn is None:
            return self.value
        try:
            return fn()
        except Exception:  # a dead closure must not take down the scrape
            return float("nan")


class MetricFamily:
    """All series of one metric name (children keyed by label values)."""

    def __init__(self, name: str, mtype: str, help: str, labelnames: Tuple[str, ...],
                 child_factory: Callable[[], Any], max_series: Optional[int], lock):
        self.name = name
        self.type = mtype
        self.help = help
        self.labelnames = labelnames
        self._child_factory = child_factory
        self._children: Dict[Tuple[str, ...], Any] = {}
        self._max_series = max_series
        self._lock = lock  # the registry's
        # series dropped by the cap: gordo_metrics_dropped_series_total
        self.dropped = 0

    def labels(self, *values: Any, **kv: Any):
        if kv:
            if values:
                raise ValueError("pass label values positionally or by name, not both")
            values = tuple(kv[label] for label in self.labelnames)
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(f"{self.name}: expected labels {self.labelnames}, got {key}")
        child = self._children.get(key)
        if child is not None:
            return child
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if self._max_series is not None and len(self._children) >= self._max_series:
                    # a detached child: its writes land where nothing renders
                    self.dropped += 1
                    return self._child_factory()
                child = self._children[key] = self._child_factory()
            return child

    # unlabeled-family conveniences
    def inc(self, n: float = 1) -> None:
        self.labels().inc(n)

    def set(self, v: float) -> None:
        self.labels().set(v)

    def record(self, v: float) -> None:
        self.labels().record(v)

    def samples(self) -> Iterable[Tuple[Dict[str, str], Any]]:
        with self._lock:
            children = sorted(self._children.items())
        for key, child in children:
            labels = dict(zip(self.labelnames, key))
            yield labels, (child if isinstance(child, Histogram) else child.get())


class MetricsRegistry:
    """App- or process-scoped metric registry.

    Registering a name again returns its family (counters stay monotonic
    across a server's ``/reload``); a type conflict raises.
    ``collector(fn, key=...)`` adds a read-at-render-time sample source;
    the same key replaces the earlier one."""

    def __init__(self, max_series_per_metric: Optional[int] = None):
        self._families: Dict[str, MetricFamily] = {}
        self._collectors: Dict[str, Callable[[], Iterable[tuple]]] = {}
        # registration, every cell's mutation and whole reads
        self._lock = threading.RLock()
        if max_series_per_metric is None:
            raw = os.environ.get("GORDO_METRIC_MAX_SERIES")
            max_series_per_metric = int(raw) if raw else _DEF_MAX_SERIES
        # <= 0 disables the cap
        self._max_series = max_series_per_metric if max_series_per_metric > 0 else None

    # --------------------------- registration ------------------------- #

    def _family(self, name: str, mtype: str, help: str, labelnames: Tuple[str, ...],
                child_factory: Callable[[], Any]) -> MetricFamily:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for label in labelnames:
            if not _LABEL_RE.match(label):
                raise ValueError(f"invalid label name {label!r} for {name}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.type != mtype or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.type}"
                        f"{fam.labelnames}, not {mtype}{tuple(labelnames)}"
                    )
                return fam
            fam = MetricFamily(name, mtype, help, tuple(labelnames), child_factory,
                               max_series=self._max_series, lock=self._lock)
            self._families[name] = fam
            return fam

    def get_family(self, name: str) -> Optional[MetricFamily]:
        """The family registered under ``name``, or None."""
        with self._lock:
            return self._families.get(name)

    def counter(self, name: str, help: str = "", labelnames=()) -> MetricFamily:
        return self._family(name, "counter", help, tuple(labelnames), lambda: _Value(self._lock))

    def gauge(self, name: str, help: str = "", labelnames=()) -> MetricFamily:
        return self._family(name, "gauge", help, tuple(labelnames), lambda: _Value(self._lock))

    def histogram(self, name: str, help: str = "", labelnames=(), lo: float = _DEF_LO,
                  hi: float = _DEF_HI, bins_per_decade: int = _DEF_BPD) -> MetricFamily:
        def factory():
            return Histogram(lo=lo, hi=hi, bins_per_decade=bins_per_decade, lock=self._lock)

        return self._family(name, "histogram", help, tuple(labelnames), factory)

    def collector(self, fn: Callable[[], Iterable[tuple]], key: str) -> None:
        """``fn()`` yields ``(name, type, help, labels_dict, value)`` tuples
        at render time; ``value`` is a number or a Histogram."""
        with self._lock:
            self._collectors[key] = fn

    def get_collector(self, key: str) -> Optional[Callable[[], Iterable[tuple]]]:
        with self._lock:
            return self._collectors.get(key)

    # ----------------------------- reads ------------------------------ #

    def _all_samples(self):
        """-> ordered {name: (type, help, [(labels, value), ...])}; the
        caller holds the lock."""
        out: Dict[str, Tuple[str, str, List[Tuple[Dict[str, str], Any]]]] = {}
        dropped: List[Tuple[Dict[str, str], Any]] = []
        for fam in list(self._families.values()):
            out[fam.name] = (fam.type, fam.help, list(fam.samples()))
            if fam.dropped:
                dropped.append(({"metric": fam.name}, fam.dropped))
        if dropped:
            out["gordo_metrics_dropped_series_total"] = (
                "counter",
                "Labeled series dropped by the per-metric cardinality "
                "guard (GORDO_METRIC_MAX_SERIES)",
                dropped,
            )
        for fn in list(self._collectors.values()):
            try:
                rows = list(fn())
            except Exception:
                continue  # a broken collector must not take down the scrape
            for name, mtype, help, labels, value in rows:
                if name not in out:
                    out[name] = (mtype, help, [])
                out[name][2].append((labels, value))
        return out

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4, from one state."""
        lines: List[str] = []
        with self._lock:
            for name, (mtype, help, samples) in self._all_samples().items():
                if help:
                    lines.append(f"# HELP {name} {_escape_help(help)}")
                lines.append(f"# TYPE {name} {mtype}")
                for labels, value in samples:
                    if isinstance(value, Histogram):
                        buckets, total, count = value._read()
                        for edge, cum in buckets:
                            le = "+Inf" if math.isinf(edge) else _fmt(edge)
                            lines.append(f"{name}_bucket{_labels({**labels, 'le': le})} {cum}")
                        lines.append(f"{name}_sum{_labels(labels)} {_fmt(total)}")
                        lines.append(f"{name}_count{_labels(labels)} {count}")
                    else:
                        lines.append(f"{name}{_labels(labels)} {_fmt(value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """JSON view of the same cells :meth:`render` reads."""
        out: Dict[str, Any] = {}
        with self._lock:
            for name, (mtype, help, samples) in self._all_samples().items():
                values = []
                for labels, value in samples:
                    if isinstance(value, Histogram):
                        values.append({"labels": labels, **value.summary()})
                    else:
                        v = float(value)
                        if not math.isfinite(v):
                            # JSON has no NaN/Inf; null keeps /stats parseable
                            values.append({"labels": labels, "value": None})
                        else:
                            values.append({"labels": labels, "value": int(v) if v == int(v) else v})
                out[name] = {"type": mtype, "values": values}
        return out


# the process-default registry (a bank built without one records here);
# the server builds one registry per app
_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _DEFAULT


# ------------------------------------------------------------------ #
# exposition helpers and parser
# ------------------------------------------------------------------ #


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt(v: float) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"  # a dead set_function closure reads as NaN
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return format(f, ".9g")


def render_samples(
    samples: Iterable[Tuple[str, Dict[str, str], float]],
    types: Optional[Dict[str, str]] = None,
    help_texts: Optional[Dict[str, str]] = None,
) -> str:
    """Render flat ``(name, labels, value)`` samples as Prometheus text,
    grouped by family with one TYPE line each. ``<base>_bucket``/``_sum``/
    ``_count`` samples of a base declared ``histogram`` in ``types`` group
    under the base, buckets sorted by numeric ``le`` (``+Inf`` last)."""
    types = types or {}
    help_texts = help_texts or {}
    hist_bases = {n for n, t in types.items() if t == "histogram"}

    def family_of(name: str) -> str:
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in hist_bases:
                return name[: -len(suffix)]
        return name

    by_family: Dict[str, Dict[str, List[Tuple[Dict[str, str], float]]]] = {}
    for name, labels, value in samples:
        by_family.setdefault(family_of(name), {}).setdefault(name, []).append((labels, value))

    def le_key(labels: Dict[str, str]):
        le = labels.get("le", "")
        try:
            return (0, float("inf") if le == "+Inf" else float(le))
        except ValueError:
            return (1, 0.0)

    lines: List[str] = []
    for family, names in by_family.items():
        if family in help_texts:
            lines.append(f"# HELP {family} {_escape_help(help_texts[family])}")
        if family in types:
            lines.append(f"# TYPE {family} {types[family]}")
        # histogram order: buckets, then sum, then count
        order = ([family, f"{family}_bucket", f"{family}_sum", f"{family}_count"]
                 if family in hist_bases else sorted(names))
        for name in order:
            for labels, value in sorted(
                names.get(name, ()),
                key=lambda r: (sorted((k, v) for k, v in r[0].items() if k != "le"), le_key(r[0])),
            ):
                lines.append(f"{name}{_labels(labels)} {_fmt(value)}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+([^\s]+)(?:\s+\d+)?$")
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_UNESCAPE_RE = re.compile(r"\\(.)")
_UNESCAPE_MAP = {"n": "\n", '"': '"', "\\": "\\"}


def _unescape_label(s: str) -> str:
    # one pass: chained str.replace would re-read what an earlier one wrote
    return _UNESCAPE_RE.sub(lambda m: _UNESCAPE_MAP.get(m.group(1), m.group(1)), s)


def parse_prometheus_text(text: str) -> Tuple[Dict[str, str], List[Tuple[str, Dict[str, str], float]]]:
    """Exposition text -> ``(types, samples)``: family name -> declared
    type, and a flat list of ``(name, labels, value)``. Malformed lines are
    skipped."""
    types: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, labelstr, valuestr = m.group(1), m.group(2), m.group(3)
        try:
            value = float(valuestr)
        except ValueError:
            continue
        labels = {k: _unescape_label(v) for k, v in _LABEL_PAIR_RE.findall(labelstr)} if labelstr else {}
        samples.append((name, labels, value))
    return types, samples
