"""Goodput accounting: where the serving time went.

Counterpart of ``gordo_components_tpu/observability/goodput.py``. The
:class:`GoodputLedger` attributes every scoring request's wall time over
the span stages (``queue_wait`` / ``coalesce`` / ``pad`` /
``device_execute`` / ``postprocess``) and classifies time three ways:

- **goodput**: device and wall time of requests that met their deadline
  with finite scores;
- **wasted**: time spent on requests that produced nothing (504s, failed
  bucket groups, non-finite output for finite input, other 4xx and 5xx)
  and the device time spent on padded rows;
- **overhead**: host stage time (queueing, coalescing, padding,
  postprocess), the price of batching.

``gordo_goodput_ratio`` is goodput wall seconds over all classified wall
seconds; ``gordo_device_busy_ratio`` device seconds over the ledger's
uptime; ``gordo_padded_row_waste_ratio`` padded device seconds over
device seconds. The bank's device seconds are host-observed windows
(``server/bank.py``, ``_account_group``).

Threads: the bank's caller (the engine's worker) writes the group cells
(:meth:`account_group`), the engine the queue wait, each HTTP thread its
request's outcome (:meth:`finish_request`); every write and every read
of the cells runs under the ledger's lock, held across no bank call.
``GORDO_SLO=0`` means no ledger at all: every call site checks one
``None``.
"""

import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from gordo_components_torch.observability.metrics import LATENCY_BINS_PER_DECADE, Histogram

__all__ = ["GoodputLedger", "STAGES", "attribute_trace"]

# the stages wall time is attributed over; "other" is attribute_trace's
# residual no named stage covers (parse, response write)
STAGES = ("queue_wait", "coalesce", "pad", "device_execute", "postprocess")

_ENV_ENABLE = "GORDO_SLO"

# a tenant cell's layout: [goodput, wasted, expired]
_TENANT_IDX = {"goodput": 0, "wasted": 1, "expired": 2}
_TENANT_OUTCOMES = ("goodput", "wasted", "expired")
_MAX_TENANT_CELLS = 256


class GoodputLedger:
    """Cumulative goodput, waste and overhead of one serving app. Every
    cell is a monotonic accumulator; the ratios are derived at read time,
    so ``/stats``, ``/metrics`` and ``/slo`` read the same numbers."""

    def __init__(self, registry=None):
        self._lock = threading.RLock()
        self.started = time.monotonic()
        # request cells (finish_request, record_queue_wait)
        self.requests = {"goodput": 0, "wasted": 0, "expired": 0}
        self.errors_5xx = 0  # the availability objective's errors, 504s included
        self.wall_goodput_s = 0.0
        self.wall_wasted_s = 0.0  # wasted and expired requests' wall time
        self.device_goodput_s = 0.0
        self.device_wasted_s = 0.0  # device time of requests that failed
        # served (status < 400) requests' service time, for the latency
        # objectives; failures burn the availability objective instead
        self.latency = Histogram(bins_per_decade=LATENCY_BINS_PER_DECADE)
        # (bounded tenant label, qos class) -> [goodput, wasted, expired]
        self.tenant_cells: Dict[Tuple[str, str], List[int]] = {}
        self._stage_queue_wait_s = 0.0
        # group cells (account_group)
        self.device_padded_s = 0.0  # device window spent on pad rows
        self.device_failed_s = 0.0  # device window of failed bucket groups
        self.stage_s = {"coalesce": 0.0, "pad": 0.0, "postprocess": 0.0}
        # bucket label -> [useful_s, padded_s, failed_s]
        self.per_bucket: Dict[str, List[float]] = {}
        # bucket label -> [routed_rows, padded_rows] (the cost model's split)
        self.bucket_rows: Dict[str, List[float]] = {}
        # shard label -> [routed_rows, padded_rows]
        self.per_shard: Dict[str, List[float]] = {}
        if registry is not None:
            registry.collector(self._collect, key="goodput")

    @classmethod
    def from_env(cls, registry=None) -> Optional["GoodputLedger"]:
        """A ledger, or None when ``GORDO_SLO=0``."""
        if os.environ.get(_ENV_ENABLE, "1") == "0":
            return None
        return cls(registry=registry)

    # ------------------------------ writers ------------------------------ #

    def record_queue_wait(self, seconds: float) -> None:
        """One request's submit -> dispatch wait (the engine)."""
        with self._lock:
            self._stage_queue_wait_s += seconds

    def account_group(self, bucket: str, window_s: float, useful_s: float, padded_s: float, ok: bool,
                      coalesce_s: float = 0.0, pad_s: float = 0.0, postprocess_s: float = 0.0,
                      shard_rows: Iterable[Tuple[str, int, int]] = ()) -> None:
        """One bucket group's trip through the pipeline. ``useful_s`` and
        ``padded_s`` split its device window by real and pad rows; a failed
        group's useful share is wasted outright. The requests' useful
        shares ride out on ``ScoreResult.device_s`` and are classified in
        :meth:`finish_request`."""
        with self._lock:
            self.device_padded_s += padded_s
            if not ok:
                self.device_failed_s += useful_s
            self.stage_s["coalesce"] += coalesce_s
            self.stage_s["pad"] += pad_s
            self.stage_s["postprocess"] += postprocess_s
            cells = self.per_bucket.get(bucket)
            if cells is None:
                cells = self.per_bucket[bucket] = [0.0, 0.0, 0.0]
            if ok:
                cells[0] += useful_s
            else:
                cells[2] += useful_s
            cells[1] += padded_s
            brows = self.bucket_rows.get(bucket)
            if brows is None:
                brows = self.bucket_rows[bucket] = [0.0, 0.0]
            for shard, routed, padded in shard_rows:
                rows = self.per_shard.get(shard)
                if rows is None:
                    rows = self.per_shard[shard] = [0.0, 0.0]
                rows[0] += routed
                rows[1] += padded
                brows[0] += routed
                brows[1] += padded

    def finish_request(self, status: int = 200, elapsed_s: float = 0.0, device_s: float = 0.0,
                       scores_finite: bool = True, tenant: str = "default",
                       qos_class: str = "interactive") -> None:
        """Classify one finished scoring request: goodput (status < 400,
        finite scores), expired (504) or wasted (everything else).
        ``tenant`` must be the bounded label."""
        if status == 504:
            cls = "expired"
        elif status < 400 and scores_finite:
            cls = "goodput"
        else:
            cls = "wasted"
        with self._lock:
            self.requests[cls] += 1
            key = (tenant, qos_class)
            cell = self.tenant_cells.get(key)
            if cell is None:
                if len(self.tenant_cells) >= _MAX_TENANT_CELLS:
                    key = ("other", qos_class)
                    cell = self.tenant_cells.get(key)
                if cell is None:
                    cell = self.tenant_cells[key] = [0, 0, 0]
            cell[_TENANT_IDX[cls]] += 1
            if status >= 500 or (status < 400 and not scores_finite):
                self.errors_5xx += 1
            if status < 400:
                self.latency.record(elapsed_s)
            if cls == "goodput":
                self.wall_goodput_s += elapsed_s
                self.device_goodput_s += device_s
            else:
                self.wall_wasted_s += elapsed_s
                self.device_wasted_s += device_s

    # ------------------------------- reads ------------------------------- #

    def _device_total_s(self) -> float:
        return self.device_goodput_s + self.device_wasted_s + self.device_failed_s + self.device_padded_s

    def goodput_ratio(self) -> Optional[float]:
        """Goodput wall seconds over classified wall seconds (None before
        any request is classified)."""
        with self._lock:
            total = self.wall_goodput_s + self.wall_wasted_s
            return (self.wall_goodput_s / total) if total > 0 else None

    def device_busy_ratio(self) -> float:
        with self._lock:
            return self._device_total_s() / max(1e-9, time.monotonic() - self.started)

    def padded_waste_ratio(self) -> Optional[float]:
        with self._lock:
            total = self._device_total_s()
            return (self.device_padded_s / total) if total > 0 else None

    def sample_cells(self) -> Dict[str, Any]:
        """The cells the SLO tracker samples, from one state."""
        with self._lock:
            return {
                "total": float(sum(self.requests.values())),
                "err": float(self.errors_5xx),
                "wall_good_s": self.wall_goodput_s,
                "wall_total_s": self.wall_goodput_s + self.wall_wasted_s,
                "tenant_cells": sorted((k, list(v)) for k, v in self.tenant_cells.items()),
            }

    def snapshot(self) -> Dict[str, Any]:
        """JSON view (``/stats`` ``goodput``), with the derivations the
        registry collector renders."""
        with self._lock:
            device_total = self._device_total_s()
            ratio = self.goodput_ratio()
            dev_ratio = self.device_goodput_s / device_total if device_total > 0 else None
            padded = self.padded_waste_ratio()
            stages = dict(self.stage_s)
            stages["queue_wait"] = self._stage_queue_wait_s
            return {
                "uptime_s": round(time.monotonic() - self.started, 3),
                "requests": dict(self.requests),
                "goodput_ratio": None if ratio is None else round(ratio, 6),
                "wall": {"goodput_s": round(self.wall_goodput_s, 6), "wasted_s": round(self.wall_wasted_s, 6)},
                "device": {
                    "total_s": round(device_total, 6),
                    "goodput_s": round(self.device_goodput_s, 6),
                    "wasted_s": round(self.device_wasted_s + self.device_failed_s, 6),
                    "padded_s": round(self.device_padded_s, 6),
                    "goodput_ratio": None if dev_ratio is None else round(dev_ratio, 6),
                    "busy_ratio": round(self.device_busy_ratio(), 6),
                    "padded_waste_ratio": None if padded is None else round(padded, 6),
                },
                "stages_s": {k: round(v, 6) for k, v in sorted(stages.items())},
                "tenants": {f"{tenant}|{cls}": dict(zip(_TENANT_OUTCOMES, cell))
                            for (tenant, cls), cell in sorted(self.tenant_cells.items())},
                "latency": self.latency.snapshot(),
                "per_bucket": {
                    label: {
                        "useful_s": round(u, 6),
                        "padded_s": round(p, 6),
                        "failed_s": round(f, 6),
                        "routed_rows": int(self.bucket_rows.get(label, (0, 0))[0]),
                        "padded_rows": int(self.bucket_rows.get(label, (0, 0))[1]),
                    }
                    for label, (u, p, f) in sorted(self.per_bucket.items())
                },
                "per_shard": {
                    shard: {
                        "routed_rows": int(routed),
                        "padded_rows": int(padded_rows),
                        "padded_ratio": (round(padded_rows / (routed + padded_rows), 6)
                                         if (routed + padded_rows) > 0 else None),
                    }
                    for shard, (routed, padded_rows) in sorted(self.per_shard.items())
                },
            }

    def _collect(self):
        """The same cells as registry series, read from one state."""
        with self._lock:
            return list(self._samples())

    def _samples(self):
        ratio = self.goodput_ratio()
        if ratio is not None:
            yield ("gordo_goodput_ratio", "gauge",
                   "Goodput wall seconds / total classified wall seconds "
                   "(deadline-met finite-score work over everything served)", {}, round(ratio, 6))
        yield ("gordo_device_busy_ratio", "gauge", "Device-busy seconds / process uptime", {},
               round(self.device_busy_ratio(), 6))
        padded = self.padded_waste_ratio()
        if padded is not None:
            yield ("gordo_padded_row_waste_ratio", "gauge",
                   "Padded-row device seconds / device-busy seconds (the routing-skew FLOP waste)", {},
                   round(padded, 6))
        for cls, n in sorted(self.requests.items()):
            yield ("gordo_goodput_requests_total", "counter", "Scoring requests by goodput class",
                   {"class": cls}, n)
        for (tenant, cls), cell in sorted(self.tenant_cells.items()):
            for outcome, n in zip(_TENANT_OUTCOMES, cell):
                yield ("gordo_goodput_tenant_requests_total", "counter",
                       "Scoring requests by tenant, priority class, and goodput outcome",
                       {"tenant": tenant, "class": cls, "outcome": outcome}, n)
        for cls, v in (("goodput", self.device_goodput_s),
                       ("wasted", self.device_wasted_s + self.device_failed_s),
                       ("padded", self.device_padded_s)):
            yield ("gordo_goodput_device_seconds_total", "counter", "Device window seconds by goodput class",
                   {"class": cls}, round(v, 6))
        stages = dict(self.stage_s)
        stages["queue_wait"] = self._stage_queue_wait_s
        for stage, v in sorted(stages.items()):
            yield ("gordo_goodput_stage_seconds_total", "counter",
                   "Host-side stage seconds (batching overhead) by stage", {"stage": stage}, round(v, 6))
        for label, (useful, padded_s, failed) in sorted(self.per_bucket.items()):
            for cls, v in (("useful", useful), ("padded", padded_s), ("failed", failed)):
                yield ("gordo_goodput_bucket_device_seconds_total", "counter",
                       "Device window seconds per bucket, split useful / padded / failed-group",
                       {"bucket": label, "class": cls}, round(v, 6))
        for shard, (routed, padded_rows) in sorted(self.per_shard.items()):
            total = routed + padded_rows
            if total > 0:
                yield ("gordo_goodput_shard_padded_row_ratio", "gauge",
                       "Pad rows / dispatched rows per shard (per-shard padding waste share)",
                       {"shard": shard}, round(padded_rows / total, 6))


# --------------------------------------------------------------------- #
# per-request stage attribution from a trace
# --------------------------------------------------------------------- #


def _flatten_spans(node: Dict[str, Any], out: List[Dict[str, Any]]) -> None:
    out.append(node)
    for child in node.get("children", ()):
        _flatten_spans(child, out)


def _merged_len(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s)


def attribute_trace(trace) -> Dict[str, Any]:
    """One request's wall time over the stage spans: ``{"wall_ms",
    "stages_ms": {stage: ms, ..., "other": ms}, "coverage"}``. ``trace`` is
    a :class:`~gordo_components_torch.observability.tracing.Trace` or the
    summary ``GET .../traces`` serves. A stage's time is the union of its
    spans (overlaps count once), clamped to the wall; ``other`` is the
    residual no stage covers, ``coverage`` the stages' share of the wall."""
    if hasattr(trace, "summary"):
        trace = trace.summary()
    root = trace.get("spans") or {}
    wall_ms = float(trace.get("duration_ms") or root.get("duration_ms") or 0.0)
    flat: List[Dict[str, Any]] = []
    if root:
        _flatten_spans(root, flat)
    by_stage: Dict[str, List[Tuple[float, float]]] = {s: [] for s in STAGES}
    all_intervals: List[Tuple[float, float]] = []
    for span in flat:
        name = span.get("name")
        if name not in by_stage:
            continue
        start = max(0.0, float(span.get("start_ms", 0.0)))
        end = min(wall_ms, start + float(span.get("duration_ms", 0.0)))
        if end <= start:
            continue
        by_stage[name].append((start, end))
        all_intervals.append((start, end))
    stages_ms = {stage: round(_merged_len(list(iv)), 3) for stage, iv in by_stage.items()}
    covered = _merged_len(all_intervals)
    stages_ms["other"] = round(max(0.0, wall_ms - covered), 3)
    return {
        "wall_ms": round(wall_ms, 3),
        "stages_ms": stages_ms,
        "coverage": round(covered / wall_ms, 4) if wall_ms > 0 else 0.0,
    }
