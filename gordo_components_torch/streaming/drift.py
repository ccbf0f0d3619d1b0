"""Per-member drift detection over the streaming window buffers.

Counterpart of ``gordo_components_tpu/streaming/drift.py``: the same
signals, the same EWMA, the same view.

Three complementary signals per member, each cheap and each answering a
different operator question:

- **reconstruction-error drift** (``drift_score``): the EWMA of the mean
  scaled anomaly total over fresh windows, divided by the member's
  TRAIN-TIME total threshold (``DiffBasedAnomalyDetector``'s
  ``total_threshold_``, the same quantity ``parallel/fleet.py``'s error
  scalers produce for fleet builds). Healthy data scores well below the
  threshold (it is a max/quantile of training errors), so a sustained
  ratio above ``GORDO_DRIFT_THRESHOLD`` (default 1.0) means the model's
  idea of "normal" no longer matches the stream — concept drift, a
  shifted sensor, or a degrading machine.
- **input-distribution shift** (``input_oob``): the fraction of scaled
  input cells outside the training band — a direct, model-free "is this
  the data we trained on" probe that fires even when the model happens
  to reconstruct the shifted data well. The band is calibrated for the
  min-max scaler family (the fleet default: training data maps into
  [0, 1]); for a standard-scaled (z-score) member the ADVISORY number
  reads high on healthy data — the drift VERDICT never depends on it
  (it is error-ratio-based), so treat ``input_oob`` as a delta-over-
  baseline signal there, not an absolute.
- **flatline** (``flatline_tags``): scaled-input channels whose window
  standard deviation collapsed to ~0 — a sensor stuck at its last value
  LOOKS alive and reconstructs well (the autoencoder happily copies a
  constant), so reconstruction error never flags it; the variance
  collapse is the only cheap signal that does. A flatlined channel
  marks the member drifted: its model is scoring on dead input.
- **staleness** (``staleness_seconds``): seconds since fresh rows last
  arrived — a model scoring live traffic on week-old calibration is
  burning device time on answers nobody can trust.

Scoring runs through the bank when the member is banked (``bank.score``:
the banked anomaly-score kernel, K2, the same math the serving path
uses, so drift is measured in the units the operator already watches),
its scaled inputs read from the bucket's ``in_shift``/``in_scale`` rows;
any other member is scored through its own ``anomaly()`` (K1).
Evaluation is blocking (device work): it runs on the thread of the
request or loop that asked for it.

Clock seam (replay/clock.py): freshness quantities — ``last_eval_wall``,
the staleness the view reports — read the ingestor's injectable clock so
time-compressed replay ages them on the replayed timeline. Sweep
DURATIONS (``last_eval_s``, span timings) stay on the real
``time.monotonic``: they measure actual device/host cost, which replay
must report honestly, not compress.
"""

import logging
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

# scaled training inputs live in [0, 1] for the min-max pipeline; the
# margin absorbs resampling/noise wobble so healthy streams read ~0
_OOB_MARGIN = 0.05

# a scaled channel whose window std sits below this is flat: training
# data maps into [0, 1] (std O(0.1+)), and even a quiet-but-alive sensor
# keeps its noise floor; an exactly-held value reads 0.0
_FLATLINE_STD = 1e-4


class MemberDrift:
    """Rolling drift state for one member."""

    __slots__ = (
        "ewma_total", "drift_score", "input_oob", "flatline_tags",
        "rows_scored", "last_eval_wall", "drifted", "error",
    )

    def __init__(self):
        self.ewma_total: Optional[float] = None
        self.drift_score: Optional[float] = None
        self.input_oob: Optional[float] = None
        self.flatline_tags = 0
        self.rows_scored = 0
        self.last_eval_wall: Optional[float] = None
        self.drifted = False
        self.error: Optional[str] = None

    def as_dict(self) -> Dict[str, Any]:
        out = {
            "drift_score": _round(self.drift_score),
            "ewma_total_scaled": _round(self.ewma_total),
            "input_oob_fraction": _round(self.input_oob),
            "flatline_tags": self.flatline_tags,
            "rows_scored": self.rows_scored,
            "drifted": self.drifted,
        }
        if self.error:
            out["error"] = self.error
        return out


def _round(v: Optional[float], nd: int = 4) -> Optional[float]:
    return None if v is None else round(float(v), nd)


class DriftDetector:
    """Evaluates every buffered member's drift state against the serving
    models (bank-first). One instance per streaming plane."""

    def __init__(
        self,
        app,  # the server's App: its tracer, bank and collection
        ingestor,
        threshold: float = 1.0,
        alpha: float = 0.5,
        min_rows: int = 32,
    ):
        self.app = app
        self.ingestor = ingestor
        self.clock = ingestor.clock  # the shared seam (replay/clock.py)
        self.threshold = float(threshold)
        self.alpha = float(alpha)  # EWMA weight of the NEWEST window
        self.min_rows = int(min_rows)
        self.members: Dict[str, MemberDrift] = {}
        self.evaluations = 0
        self.last_eval_wall: Optional[float] = None
        self.last_eval_s: Optional[float] = None
        # two concurrent GET /drift?refresh=1 sweeps (each on its own
        # handler thread) must not interleave their EWMA updates; dict
        # READS elsewhere are safe (one-call snapshots under the GIL)
        self._eval_lock = threading.Lock()

    # --------------------------- evaluation ---------------------------- #

    def evaluate(self) -> Dict[str, Any]:
        """Score every member's fresh window and update the rolling drift
        states. BLOCKING (device work); concurrent sweeps serialize so
        EWMA updates never interleave.
        Returns the drift view (same body ``GET /drift`` serves)."""
        with self._eval_lock:
            return self._evaluate_locked()

    def _evaluate_locked(self) -> Dict[str, Any]:
        t0 = time.monotonic()
        tracer = self.app.tracer
        trace = tracer.start_trace("drift_eval") if tracer is not None else None
        bank = self.app.bank
        collection = self.app.collection
        models = collection.models if collection is not None else {}
        drifted: List[str] = []
        for name, buf in list(self.ingestor.buffers.items()):
            st = self.members.get(name)
            if st is None:
                st = self.members[name] = MemberDrift()
            _ts, X = buf.clean_window()
            if len(X) < self.min_rows:
                continue
            model = models.get(name)
            if model is None:
                st.error = "not in the serving collection"
                continue
            t_m = time.monotonic()
            try:
                self._score_member(st, name, model, bank, X)
                st.error = None
            except Exception as exc:
                # one member's scoring failure (quarantine-worthy model,
                # injected fault) must not abort the whole sweep
                st.error = f"{type(exc).__name__}: {exc}"
                logger.warning("drift scoring failed for %r", name, exc_info=True)
                continue
            st.rows_scored += len(X)
            st.last_eval_wall = self.clock.time()
            st.drifted = (
                st.drift_score is not None and st.drift_score > self.threshold
            ) or st.flatline_tags > 0
            if st.drifted:
                drifted.append(name)
                if trace is not None:
                    # bounded: spans only for members that FLAGGED —
                    # the interesting ones — not the whole fleet
                    trace.add_span(
                        f"drift:{name}", t_m, time.monotonic(),
                        drift_score=_round(st.drift_score),
                        rows=len(X),
                    )
        self.evaluations += 1
        self.last_eval_wall = self.clock.time()
        self.last_eval_s = time.monotonic() - t0
        if trace is not None:
            trace.finish(
                error=False, members=len(self.members), drifted=len(drifted)
            )
        return self.view()

    def _score_member(self, st: MemberDrift, name: str, model, bank, X) -> None:
        threshold = getattr(model, "total_threshold_", None)
        if bank is not None and name in bank:
            result = bank.score(name, X)
            totals = np.asarray(result.total_scaled)
            scaled_in = self._scaled_inputs_banked(bank, name, X)
        else:
            totals = np.asarray(model.anomaly(X)["total-anomaly-scaled"])
            scaled_in = (
                model._model_space(X) if hasattr(model, "_model_space") else None
            )
        window_mean = float(np.nanmean(totals)) if len(totals) else None
        if window_mean is not None and np.isfinite(window_mean):
            st.ewma_total = (
                window_mean
                if st.ewma_total is None
                else self.alpha * window_mean + (1 - self.alpha) * st.ewma_total
            )
        if st.ewma_total is not None and threshold:
            st.drift_score = st.ewma_total / float(threshold)
        if scaled_in is not None and scaled_in.size:
            st.input_oob = float(
                np.mean(
                    (scaled_in < -_OOB_MARGIN) | (scaled_in > 1.0 + _OOB_MARGIN)
                )
            )
            # variance collapse: a stuck-at-value sensor reconstructs
            # fine (error stays low) — the collapsed window std is the
            # signal that flags it
            if scaled_in.shape[0] >= 8:
                st.flatline_tags = int(
                    (np.nanstd(scaled_in, axis=0) < _FLATLINE_STD).sum()
                )

    @staticmethod
    def _scaled_inputs_banked(bank, name: str, X) -> Optional[np.ndarray]:
        """Inputs mapped through the member's TRAIN-TIME affine scaler,
        read from its rows of the bucket's ``in_shift``/``in_scale`` stacks
        — the same composed (shift, scale) the bank applies."""
        entry = bank._index.get(name)
        if entry is None:
            return None
        bucket = bank._buckets.get(entry[0])
        if bucket is None:
            return None
        in_shift, in_scale = bucket.input_scaler(entry[1])
        return (np.asarray(X, np.float32) - in_shift) * in_scale

    def reset_members(self, names) -> None:
        """Forget the rolling drift state of ``names``, under the sweeps'
        lock so that a sweep in flight cannot write the old EWMA back."""
        with self._eval_lock:
            for name in names:
                st = self.members.get(name)
                if st is not None:
                    st.ewma_total = None
                    st.drift_score = None
                    st.drifted = False

    # ----------------------------- views ------------------------------- #

    def drifted_members(self) -> List[str]:
        return sorted(n for n, st in self.members.items() if st.drifted)

    def view(self) -> Dict[str, Any]:
        now = self.clock.time()
        members = {}
        for name, buf in sorted(self.ingestor.buffers.items()):
            entry: Dict[str, Any] = {
                "window_rows": len(buf),
                "rows_total": buf.rows_total,
                "late_rows": buf.late_rows,
                "dropped_rows": buf.dropped_rows,
                "duplicate_rows": buf.duplicate_rows,
                "dropout_cells": buf.dropout_cells,
                "watermark_lag_seconds": _round(buf.watermark_lag_s(now), 1),
                "staleness_seconds": _round(buf.staleness_s(now), 1),
            }
            st = self.members.get(name)
            if st is not None:
                entry.update(st.as_dict())
            members[name] = entry
        return {
            "threshold": self.threshold,
            "alpha": self.alpha,
            "min_rows": self.min_rows,
            "evaluations": self.evaluations,
            "last_eval_seconds": _round(self.last_eval_s, 3),
            "drifted": self.drifted_members(),
            "members": members,
            **self.ingestor.totals(),
        }
