"""Streaming ingestion: per-member bounded window buffers.

Counterpart of ``gordo_components_tpu/streaming/ingest.py``, the same
accounting to the row.

Each streamed member owns a :class:`WindowBuffer` — a preallocated ring
of the freshest rows with an event-time watermark. The buffer accounts
for the stream's failure modes instead of assuming them away:

- **out-of-order rows** (event time behind the watermark but within the
  allowed lateness) are accepted and counted — the drift window sorts by
  event time, so a gateway flushing its backlog still contributes;
- **late rows** (behind the watermark by more than
  ``GORDO_STREAM_LATENESS_S``) are counted and DROPPED — a stale row
  entering the recalibration window would teach the thresholds
  yesterday's distribution;
- **sensor dropout** (NaN cells) is masked and counted; rows with any
  missing sensor are excluded from scoring/refit windows (the same
  dropna contract the training datasets apply);
- **duplicated delivery** (a gateway re-sending rows it already
  delivered — at-least-once transports do this on every reconnect) is
  deduplicated by EXACT ``(timestamp, row)`` match against the buffered
  window and counted (``gordo_stream_duplicate_rows_total``) instead of
  double-filling the window: a window where half the rows are one
  repeated sample would drag the drift EWMA toward that sample and
  mis-teach recalibration. Rows that share a timestamp but carry
  DIFFERENT values (two sensors legitimately sampled in the same
  second, or a corrected re-send) are not duplicates and are kept.

Ingestion is host-side numpy on the request's handler thread (bounded
by the request body size) and never touches the scoring hot path; the
``stream.ingest`` faultpoint makes the endpoint a chaos target. Wall-clock reads
(arrival stamps, staleness) go through the injectable clock seam
(``replay/clock.py``) so time-compressed replay drives the same code;
the default is the real clock and costs one attribute read.
"""

import threading
from typing import Dict, Optional, Tuple

import numpy as np

from gordo_components_torch.replay.clock import SYSTEM_CLOCK
from gordo_components_torch.resilience.faults import faultpoint

# chaos site: fired per ingest call, BEFORE any
# buffer mutation — an injected failure must leave counters and windows
# exactly as they were (the monotonic-counters contract)
_FP_INGEST = faultpoint("stream.ingest")


class WindowBuffer:
    """Bounded ring of the freshest ``capacity`` rows for one member."""

    __slots__ = (
        "capacity", "n_features", "lateness_s", "_values", "_ts", "_n",
        "_head", "watermark", "rows_total", "late_rows", "dropped_rows",
        "duplicate_rows", "dropout_cells", "last_ingest_wall", "_lock",
        "clock",
    )

    def __init__(
        self, capacity: int, n_features: int, lateness_s: float, clock=None
    ):
        self.capacity = int(capacity)
        self.n_features = int(n_features)
        self.lateness_s = float(lateness_s)
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        self._values = np.empty((self.capacity, self.n_features), np.float32)
        self._ts = np.empty((self.capacity,), np.float64)
        self._n = 0  # valid rows in the ring
        self._head = 0  # next write slot
        self.watermark = None  # max event time seen (epoch seconds)
        self.rows_total = 0  # accepted rows
        self.late_rows = 0  # rows behind the watermark at arrival
        self.dropped_rows = 0  # late beyond the allowed lateness
        self.duplicate_rows = 0  # exact (ts, row) re-sends, deduplicated
        self.dropout_cells = 0  # NaN sensor cells accepted
        self.last_ingest_wall = None  # wall clock of the last accept
        # ingest runs on handler threads, drift evaluation reads windows
        # from another thread: guard the ring's (head, n) pair
        self._lock = threading.Lock()

    def add(self, event_ts: np.ndarray, values: np.ndarray) -> Dict[str, int]:
        """Append a batch in arrival order. Returns the accounting delta
        for the response body."""
        event_ts = np.asarray(event_ts, np.float64).reshape(-1)
        values = np.asarray(values, np.float32)
        if values.ndim != 2 or values.shape[1] != self.n_features:
            raise ValueError(
                f"expected (rows, {self.n_features}) values, got "
                f"{values.shape}"
            )
        if len(event_ts) != len(values):
            raise ValueError(
                f"{len(event_ts)} timestamps for {len(values)} rows"
            )
        if len(event_ts) and not np.isfinite(event_ts).all():
            # a NaN timestamp would poison the watermark permanently
            # (every comparison against NaN is False — lateness
            # accounting silently dies); reject the batch instead
            raise ValueError("timestamps must be finite epoch seconds")
        wm = self.watermark if self.watermark is not None else -np.inf
        behind = event_ts < wm
        too_late = event_ts < (wm - self.lateness_s)
        keep = ~too_late
        n_keep = int(keep.sum())
        overflow = 0
        n_dup = 0
        with self._lock:
            self.late_rows += int(behind.sum())
            self.dropped_rows += int(too_late.sum())
            if n_keep:
                kept_v = values[keep]
                kept_t = event_ts[keep]
                dup = self._find_duplicates(kept_t, kept_v)
                if dup is not None:
                    n_dup = int(dup.sum())
                    self.duplicate_rows += n_dup
                    kept_v, kept_t = kept_v[~dup], kept_t[~dup]
                    n_keep -= n_dup
            if n_keep:
                if n_keep > self.capacity:
                    # a batch larger than the ring keeps only the
                    # freshest rows BY EVENT TIME (arrival order could
                    # end on the batch's oldest under late delivery);
                    # the overflow is accounted as dropped — every
                    # posted row lands in exactly one counter
                    order = np.argsort(kept_t, kind="stable")[-self.capacity:]
                    order.sort()  # keep arrival order among survivors
                    kept_v, kept_t = kept_v[order], kept_t[order]
                    overflow = n_keep - self.capacity
                    self.dropped_rows += overflow
                    n_keep = self.capacity
                self.dropout_cells += int(np.isnan(kept_v).sum())
                end = self._head + n_keep
                if end <= self.capacity:
                    self._values[self._head:end] = kept_v
                    self._ts[self._head:end] = kept_t
                else:
                    split = self.capacity - self._head
                    self._values[self._head:] = kept_v[:split]
                    self._ts[self._head:] = kept_t[:split]
                    self._values[: end - self.capacity] = kept_v[split:]
                    self._ts[: end - self.capacity] = kept_t[split:]
                self._head = end % self.capacity
                self._n = min(self.capacity, self._n + n_keep)
                self.rows_total += n_keep
                self.last_ingest_wall = self.clock.time()
            if len(event_ts):
                high = float(event_ts.max())
                if self.watermark is None or high > self.watermark:
                    self.watermark = high
        return {
            "accepted": n_keep,
            "late": int(behind.sum()),
            "dropped": int(too_late.sum()) + overflow,
            "duplicates": n_dup,
        }

    def _find_duplicates(self, kept_t, kept_v) -> Optional[np.ndarray]:
        """Mask of exact ``(timestamp, row)`` re-sends among the rows
        about to be accepted — against the buffered window AND within
        the batch itself. Called under the lock. Healthy streams
        (advancing stamps, unique within the batch) exit after two
        vectorized checks with no per-row work; ``None`` means "no
        duplicates" without allocating the mask."""
        ring_ts = self._ts[: self._n]
        hits_ring = self._n > 0 and bool(np.isin(kept_t, ring_ts).any())
        if not hits_ring and len(np.unique(kept_t)) == len(kept_t):
            return None
        # NaN dropout cells compare via the row's BYTES, so an exact
        # re-send matches even though NaN != NaN elementwise
        seen = set()
        if hits_ring:
            for i in np.flatnonzero(np.isin(ring_ts, kept_t)):
                seen.add((float(ring_ts[i]), self._values[i].tobytes()))
        dup = np.zeros(len(kept_t), bool)
        for j in range(len(kept_t)):
            key = (float(kept_t[j]), kept_v[j].tobytes())
            if key in seen:
                dup[j] = True
            else:
                seen.add(key)
        return dup

    def window(self) -> Tuple[np.ndarray, np.ndarray]:
        """The buffered rows in EVENT-TIME order (copies): ``(ts, values)``.
        Out-of-order accepts land in their true position here."""
        with self._lock:
            if self._n < self.capacity:
                ts = self._ts[: self._n].copy()
                vals = self._values[: self._n].copy()
            else:
                ts = np.roll(self._ts, -self._head, axis=0).copy()
                vals = np.roll(self._values, -self._head, axis=0).copy()
        order = np.argsort(ts, kind="stable")
        return ts[order], vals[order]

    def clean_window(self) -> Tuple[np.ndarray, np.ndarray]:
        """``window()`` with dropout-masked (any-NaN) rows removed — the
        scoring/recalibration/refit view."""
        ts, vals = self.window()
        ok = ~np.isnan(vals).any(axis=1)
        return ts[ok], vals[ok]

    def __len__(self) -> int:
        return self._n

    def watermark_lag_s(self, now: Optional[float] = None) -> Optional[float]:
        """Wall-vs-event-time lag: how far behind real time the stream's
        high-water mark sits."""
        if self.watermark is None:
            return None
        return max(
            0.0, (now if now is not None else self.clock.time()) - self.watermark
        )

    def staleness_s(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds since fresh data last ARRIVED (wall clock) — the
        data-staleness signal ``gordo_model_staleness_seconds`` exports."""
        if self.last_ingest_wall is None:
            return None
        return max(
            0.0,
            (now if now is not None else self.clock.time())
            - self.last_ingest_wall,
        )


class StreamIngestor:
    """Per-member :class:`WindowBuffer` registry behind ``POST /ingest``."""

    def __init__(
        self, capacity: int = 512, lateness_s: float = 300.0, clock=None
    ):
        self.capacity = int(capacity)
        self.lateness_s = float(lateness_s)
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        self.buffers: Dict[str, WindowBuffer] = {}
        # each request runs on its own handler thread: two first ingests of
        # one member must share one buffer, not replace each other's
        self._lock = threading.Lock()

    def ingest(
        self, name: str, event_ts: np.ndarray, values: np.ndarray
    ) -> Dict[str, int]:
        _FP_INGEST.fire()
        values = np.asarray(values, np.float32)
        if values.ndim != 2:
            raise ValueError(f"expected (rows, features) values, got {values.shape}")
        buf = self.buffers.get(name)
        if buf is None:
            with self._lock:
                buf = self.buffers.get(name)
                if buf is None:
                    buf = self.buffers[name] = WindowBuffer(
                        self.capacity, values.shape[1], self.lateness_s,
                        clock=self.clock,
                    )
        out = buf.add(event_ts, values)
        out["window_rows"] = len(buf)
        out["watermark"] = buf.watermark
        return out

    # ------------------------- aggregate views ------------------------- #

    def totals(self) -> Dict[str, int]:
        bufs = list(self.buffers.values())
        return {
            "rows_total": sum(b.rows_total for b in bufs),
            "late_rows_total": sum(b.late_rows for b in bufs),
            "dropped_rows_total": sum(b.dropped_rows for b in bufs),
            "duplicate_rows_total": sum(b.duplicate_rows for b in bufs),
            "dropout_cells_total": sum(b.dropout_cells for b in bufs),
            "buffers": len(bufs),
        }

    def max_watermark_lag_s(self, now: Optional[float] = None) -> Optional[float]:
        lags = [
            lag
            for b in list(self.buffers.values())
            if (lag := b.watermark_lag_s(now)) is not None
        ]
        return max(lags) if lags else None

    def max_staleness_s(self, now: Optional[float] = None) -> Optional[float]:
        vals = [
            s
            for b in list(self.buffers.values())
            if (s := b.staleness_s(now)) is not None
        ]
        return max(vals) if vals else None
