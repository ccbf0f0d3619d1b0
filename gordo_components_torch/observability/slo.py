"""Rolling multi-window SLO objectives and burn rates.

Counterpart of ``gordo_components_tpu/observability/slo.py``. An
:class:`SLOTracker` samples the :class:`~.goodput.GoodputLedger`'s
cumulative cells on a fixed cadence into a bounded ring and computes, per
objective and per window (default 5m/1h/6h), the windowed good/total
delta, its ratio and the burn rate::

    burn_rate = (1 - windowed_good_ratio) / (1 - target)

Objectives (``GORDO_SLO_OBJECTIVES``, JSON; ``DEFAULT_OBJECTIVES``):
``availability`` (good: not a server-side failure), ``p<NN>_latency_ms``
(good: served within ``target`` ms, at the ledger histogram's bucket
resolution) and ``goodput_ratio`` (the ledger's wall-second split).

Windows are computed from the sample ring alone and cached until the next
sample lands, so ``GET /slo``, the ``/stats`` embed and the
``gordo_slo_burn_rate`` series read the same numbers between samples.

The JAX package samples from an asyncio task every ``GORDO_SLO_SAMPLE_S``
(default 10 s); the port's server runs :meth:`SLOTracker.start`, a daemon
thread that the server's close stops. Sampling and reading take the
tracker's lock; nothing here is on the scoring path.
"""

import json
import os
import re
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from gordo_components_torch.utils import env_num

__all__ = ["DEFAULT_OBJECTIVES", "DEFAULT_WINDOWS", "SLOTracker", "merge_slo_snapshots",
           "parse_objectives", "parse_windows"]

DEFAULT_OBJECTIVES: Tuple[Dict[str, Any], ...] = (
    {"name": "availability", "target": 0.999},
    {"name": "p99_latency_ms", "target": 100.0},
    {"name": "goodput_ratio", "target": 0.9},
)

DEFAULT_WINDOWS: Tuple[Tuple[str, float], ...] = (("5m", 300.0), ("1h", 3600.0), ("6h", 21600.0))

# the canonical fast-burn threshold of the first (5m) window
DEFAULT_FAST_BURN = 14.4

_LATENCY_RE = re.compile(r"^p(\d{1,2})_latency_ms$")
_WINDOW_RE = re.compile(r"^(\d+(?:\.\d+)?)([smh])$")
_WINDOW_UNITS = {"s": 1.0, "m": 60.0, "h": 3600.0}


class _Objective:
    """One parsed objective: name, target, budget (and a latency one's quantile)."""

    __slots__ = ("name", "target", "quantile", "budget")

    def __init__(self, name: str, target: float, quantile: Optional[float] = None):
        self.name = name
        self.target = float(target)
        m = _LATENCY_RE.match(name)
        if m:
            self.quantile = float(quantile) if quantile is not None else int(m.group(1)) / 100.0
            if not 0.0 < self.quantile < 1.0:
                raise ValueError(f"objective {name!r}: quantile must be in (0, 1), got {self.quantile!r}")
            self.budget = 1.0 - self.quantile
            if self.target <= 0:
                raise ValueError(f"objective {name!r}: target must be positive milliseconds, got {target!r}")
        elif name in ("availability", "goodput_ratio"):
            self.quantile = None
            if not 0.0 < self.target < 1.0:
                raise ValueError(f"objective {name!r}: target must be a ratio in (0, 1), got {target!r}")
            self.budget = 1.0 - self.target
        else:
            raise ValueError(f"unknown SLO objective {name!r} (availability, p<NN>_latency_ms, goodput_ratio)")

    def describe(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"name": self.name, "target": self.target}
        if self.quantile is not None:
            out["quantile"] = self.quantile
        out["budget"] = round(self.budget, 6)
        return out


def parse_objectives(raw: Optional[str] = None) -> List[_Objective]:
    """``GORDO_SLO_OBJECTIVES`` (a JSON list of ``{"name", "target"}``) as
    objectives; a malformed one raises."""
    if raw is None:
        raw = os.environ.get("GORDO_SLO_OBJECTIVES", "")
    if not raw.strip():
        specs: Sequence[Dict[str, Any]] = DEFAULT_OBJECTIVES
    else:
        try:
            specs = json.loads(raw)
        except json.JSONDecodeError as exc:
            raise ValueError(f"GORDO_SLO_OBJECTIVES must be JSON: {exc}") from None
        if not isinstance(specs, list):
            raise ValueError("GORDO_SLO_OBJECTIVES must be a JSON list")
    out = []
    for spec in specs:
        if not isinstance(spec, dict) or "name" not in spec or "target" not in spec:
            raise ValueError(f"each SLO objective needs name+target, got {spec!r}")
        out.append(_Objective(str(spec["name"]), float(spec["target"]), spec.get("quantile")))
    if len({o.name for o in out}) != len(out):
        raise ValueError("duplicate SLO objective names")
    return out


def parse_windows(raw: Optional[str] = None) -> List[Tuple[str, float]]:
    """``GORDO_SLO_WINDOWS`` (e.g. ``"5m,1h,6h"``) as [(label, seconds)],
    shortest first (the first is the fast-burn window)."""
    if raw is None:
        raw = os.environ.get("GORDO_SLO_WINDOWS", "")
    if not raw.strip():
        return list(DEFAULT_WINDOWS)
    out = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        m = _WINDOW_RE.match(part)
        if not m:
            raise ValueError(f"GORDO_SLO_WINDOWS entry {part!r} must look like 5m/1h/30s")
        out.append((part, float(m.group(1)) * _WINDOW_UNITS[m.group(2)]))
    if not out:
        raise ValueError("GORDO_SLO_WINDOWS parsed to no windows")
    return sorted(out, key=lambda w: w[1])


def _window_cell(actual: float, good: float, total: float, budget: float) -> Dict[str, Any]:
    if total <= 0:
        ratio, burn = None, 0.0
    else:
        ratio = good / total
        burn = max(0.0, 1.0 - ratio) / budget
    return {
        "window_s": round(actual, 3),
        "good": round(good, 6),
        "total": round(total, 6),
        "ratio": None if ratio is None else round(ratio, 6),
        "burn_rate": round(burn, 4),
    }


_EMPTY_WINDOW = {"window_s": 0.0, "good": 0.0, "total": 0.0, "ratio": None, "burn_rate": 0.0}


class SLOTracker:
    """Samples a ledger into a bounded ring and computes multi-window burn
    rates per objective and per (tenant, class)."""

    def __init__(self, ledger, objectives: Optional[Sequence] = None,
                 windows: Optional[Sequence[Tuple[str, float]]] = None,
                 sample_interval_s: Optional[float] = None, fast_burn: Optional[float] = None,
                 registry=None, clock=time.monotonic):
        self.ledger = ledger
        self.objectives = list(objectives) if objectives is not None else parse_objectives()
        if self.objectives and isinstance(self.objectives[0], dict):
            self.objectives = [_Objective(o["name"], o["target"], o.get("quantile")) for o in self.objectives]
        self.windows = list(windows) if windows is not None else parse_windows()
        if sample_interval_s is None:
            sample_interval_s = env_num("GORDO_SLO_SAMPLE_S", 10.0, float)
        self.sample_interval_s = max(0.001, float(sample_interval_s))
        self.fast_burn_threshold = (float(fast_burn) if fast_burn is not None
                                    else env_num("GORDO_SLO_FAST_BURN", DEFAULT_FAST_BURN, float))
        self._clock = clock
        max_window = max(s for _, s in self.windows)
        # enough samples for the longest window at the cadence, capped
        self._samples: deque = deque(maxlen=min(8192, int(max_window / self.sample_interval_s) + 8))
        self._lock = threading.Lock()
        self._cached: Optional[Dict[str, Any]] = None
        # one budget for the per-class burn: the availability objective's
        self._class_budget = next((o.budget for o in self.objectives if o.name == "availability"), 0.001)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if registry is not None:
            registry.collector(self._collect, key="slo")

    # ------------------------------ sampling ----------------------------- #

    def _take_sample(self, now: float) -> Dict[str, float]:
        led = self.ledger
        cells = led.sample_cells()
        sample: Dict[str, float] = {
            "t": now,
            "total": cells["total"],
            "err": cells["err"],
            "wall_good_s": cells["wall_good_s"],
            "wall_total_s": cells["wall_total_s"],
            # latency objectives rate over served requests only
            "latency_total": float(led.latency.count),
        }
        for obj in self.objectives:
            if obj.quantile is not None:
                sample[f"le:{obj.name}"] = float(led.latency.count_le(obj.target / 1e3))
        for (tenant, cls), cell in cells["tenant_cells"]:
            key = f"tc:{tenant}|{cls}"
            sample[f"{key}:good"] = float(cell[0])
            sample[f"{key}:total"] = float(cell[0] + cell[1] + cell[2])
        return sample

    def sample(self, now: Optional[float] = None, force: bool = False) -> bool:
        """Append a sample if the cadence (or ``force``) says so; whether
        one landed."""
        if now is None:
            now = self._clock()
        with self._lock:
            if not force and self._samples and now - self._samples[-1]["t"] < self.sample_interval_s:
                return False
            self._samples.append(self._take_sample(now))
            self._cached = None
            return True

    def start(self) -> None:
        """A baseline sample, then a daemon thread that samples every
        ``sample_interval_s`` until :meth:`stop`."""
        if self._thread is not None:
            return
        self.sample(force=True)
        self._stop.clear()

        def tick():
            while not self._stop.wait(self.sample_interval_s):
                self.sample()

        self._thread = threading.Thread(target=tick, name="gordo-slo-sampler", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout)
        self._thread = None

    # ---------------------------- windows, burn -------------------------- #

    def _window_delta(self, window_s: float) -> Optional[Tuple[Dict[str, float], float]]:
        """(latest - baseline, covered seconds): the baseline is the oldest
        sample inside the window, else the one before the latest."""
        if len(self._samples) < 2:
            return None
        latest = self._samples[-1]
        start = latest["t"] - window_s
        baseline = None
        for s in self._samples:
            if s["t"] >= start:
                baseline = s
                break
        if baseline is None or baseline is latest:
            baseline = self._samples[-2]
        delta = {k: latest[k] - baseline.get(k, 0.0) for k in latest if k != "t"}
        return delta, max(1e-9, latest["t"] - baseline["t"])

    def _objective_windows(self, obj: _Objective) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for wname, wsec in self.windows:
            got = self._window_delta(wsec)
            if got is None:
                out[wname] = dict(_EMPTY_WINDOW)
                continue
            delta, actual = got
            if obj.name == "availability":
                total = delta["total"]
                good = total - delta["err"]
            elif obj.quantile is not None:
                total = delta.get("latency_total", 0.0)
                good = delta.get(f"le:{obj.name}", 0.0)
            else:  # goodput_ratio
                total = delta["wall_total_s"]
                good = delta["wall_good_s"]
            out[wname] = _window_cell(actual, good, total, obj.budget)
        return out

    def snapshot(self) -> Dict[str, Any]:
        """Per-objective windowed ratios and burn rates, cached until the
        next sample."""
        self.sample()  # lands only when the cadence is due
        with self._lock:
            if self._cached is not None:
                return self._cached
            fast_window = self.windows[0][0]
            objectives = []
            worst: Optional[Dict[str, Any]] = None
            for obj in self.objectives:
                windows = self._objective_windows(obj)
                entry = {**obj.describe(), "windows": windows}
                fast = windows[fast_window]["burn_rate"]
                entry["fast_burn"] = bool(fast is not None and fast >= self.fast_burn_threshold)
                obj_worst = max(((w["burn_rate"], name) for name, w in windows.items()
                                 if w["burn_rate"] is not None), default=(0.0, fast_window))
                entry["worst_burn"] = {"window": obj_worst[1], "burn_rate": obj_worst[0]}
                if worst is None or obj_worst[0] > worst["burn_rate"]:
                    worst = {"objective": obj.name, "window": obj_worst[1], "burn_rate": obj_worst[0]}
                objectives.append(entry)
            self._cached = {
                "sample_interval_s": self.sample_interval_s,
                "n_samples": len(self._samples),
                "fast_burn_threshold": self.fast_burn_threshold,
                "windows": {name: sec for name, sec in self.windows},
                "objectives": objectives,
                "worst": worst,
                "classes": self._class_windows(),
            }
            return self._cached

    def _class_windows(self) -> Dict[str, Any]:
        """Per-(tenant, class) windowed burn (lock held): good is goodput,
        total every classified request, against the class budget."""
        latest = self._samples[-1] if self._samples else {}
        keys = sorted(k[3:-5] for k in latest if k.startswith("tc:") and k.endswith(":good"))
        if not keys:
            return {}
        deltas = {wname: self._window_delta(wsec) for wname, wsec in self.windows}
        fast_window = self.windows[0][0]
        out: Dict[str, Any] = {}
        for key in keys:
            windows: Dict[str, Any] = {}
            for wname, _wsec in self.windows:
                got = deltas[wname]
                if got is None:
                    windows[wname] = dict(_EMPTY_WINDOW)
                    continue
                delta, actual = got
                windows[wname] = _window_cell(actual, delta.get(f"tc:{key}:good", 0.0),
                                              delta.get(f"tc:{key}:total", 0.0), self._class_budget)
            out[key] = {
                "budget": round(self._class_budget, 6),
                "windows": windows,
                "fast_burn": bool(windows[fast_window]["burn_rate"] >= self.fast_burn_threshold),
            }
        return out

    def class_burn(self, qos_class: str) -> Optional[float]:
        """Fast-window burn of one priority class over every tenant; None
        when the class served nothing in the window."""
        snap = self.snapshot()
        fast_window = self.windows[0][0]
        good = total = 0.0
        for key, entry in snap.get("classes", {}).items():
            if key.rsplit("|", 1)[-1] != qos_class:
                continue
            w = entry["windows"].get(fast_window)
            if w:
                good += w["good"]
                total += w["total"]
        if total <= 0:
            return None
        return max(0.0, 1.0 - good / total) / self._class_budget

    def _collect(self):
        """Registry gauges from the cached snapshot ``/slo`` serves."""
        snap = self.snapshot()
        for obj in snap["objectives"]:
            for wname, w in obj["windows"].items():
                yield ("gordo_slo_burn_rate", "gauge",
                       "Error-budget burn rate per objective and window (1.0 = burning exactly at budget)",
                       {"objective": obj["name"], "window": wname}, w["burn_rate"])
                if w["ratio"] is not None:
                    yield ("gordo_slo_objective_ratio", "gauge", "Windowed good-event ratio per objective",
                           {"objective": obj["name"], "window": wname}, w["ratio"])
        for key, entry in snap.get("classes", {}).items():
            tenant, _, qos_class = key.rpartition("|")
            for wname, w in entry["windows"].items():
                yield ("gordo_slo_burn_rate", "gauge",
                       "Error-budget burn rate per objective and window (1.0 = burning exactly at budget)",
                       {"tenant": tenant, "class": qos_class, "window": wname}, w["burn_rate"])


# --------------------------------------------------------------------- #
# fleet rollup
# --------------------------------------------------------------------- #


def _finish_windows(windows: Dict[str, Dict[str, Any]], budget: float) -> None:
    for w in windows.values():
        if w["total"] > 0:
            ratio = w["good"] / w["total"]
            w["ratio"] = round(ratio, 6)
            w["burn_rate"] = round(max(0.0, 1.0 - ratio) / budget, 4)
        else:
            w["ratio"] = None
            w["burn_rate"] = 0.0
        w["good"] = round(w["good"], 6)
        w["total"] = round(w["total"], 6)


def merge_slo_snapshots(bodies: Sequence[Optional[Dict[str, Any]]]) -> Dict[str, Any]:
    """Per-replica ``GET /slo`` bodies as one fleet view: good/total sum per
    (objective, window) and the burn recomputes from the summed ratio;
    ``worst_burn`` names the replica index of the hottest burn. A replica
    that did not answer (None) or has SLOs off is counted out."""
    merged: Dict[str, Dict[str, Any]] = {}
    order: List[str] = []
    worst: Optional[Dict[str, Any]] = None
    classes: Dict[str, Dict[str, Any]] = {}
    scraped = 0
    for idx, body in enumerate(bodies):
        if not body or not body.get("enabled", True):
            continue
        objectives = body.get("objectives")
        if not isinstance(objectives, list):
            continue
        scraped += 1
        for key, cent in (body.get("classes") or {}).items():
            agg = classes.setdefault(key, {"budget": cent.get("budget"), "windows": {}})
            for wname, w in (cent.get("windows") or {}).items():
                cell = agg["windows"].setdefault(wname, {"good": 0.0, "total": 0.0})
                cell["good"] += float(w.get("good") or 0.0)
                cell["total"] += float(w.get("total") or 0.0)
        for obj in objectives:
            name = obj.get("name")
            if not name:
                continue
            entry = merged.get(name)
            if entry is None:
                entry = merged[name] = {"name": name, "target": obj.get("target"), "budget": obj.get("budget"),
                                        "windows": {}}
                order.append(name)
            for wname, w in (obj.get("windows") or {}).items():
                cell = entry["windows"].setdefault(wname, {"good": 0.0, "total": 0.0})
                cell["good"] += float(w.get("good") or 0.0)
                cell["total"] += float(w.get("total") or 0.0)
                burn = w.get("burn_rate")
                if burn is not None and (worst is None or burn > worst["burn_rate"]):
                    worst = {"objective": name, "window": wname, "replica": idx, "burn_rate": burn}
    objectives_out = []
    for name in order:
        entry = merged[name]
        _finish_windows(entry["windows"], entry.get("budget") or 1.0)
        objectives_out.append(entry)
    for agg in classes.values():
        _finish_windows(agg["windows"], agg.get("budget") or 0.001)
    out = {"replicas_scraped": scraped, "objectives": objectives_out, "worst_burn": worst}
    if classes:
        out["classes"] = dict(sorted(classes.items()))
    return out
