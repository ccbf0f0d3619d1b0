"""The online adaptation loop: recalibrate cheaply, refit selectively,
apply through the zero-downtime swap.

Counterpart of ``gordo_components_tpu/streaming/adapt.py``. Two response
tiers, ordered by cost:

1. **Rolling EWMA threshold recalibration** (no retrain): a drifted
   member's error scaler is re-fit on its fresh window and EWMA-blended
   with the serving scaler (``GORDO_RECAL_ALPHA`` weights the new
   window), then the anomaly thresholds are re-derived from the window
   under the blended scaler at the member's configured quantile. The
   model's weights are untouched.
2. **Incremental refit** (bounded retrain): drifted members fine-tune
   for ``GORDO_REFIT_EPOCHS`` epochs through ``FleetTrainer`` on their
   fresh windows, warm-started from the serving weights (one gang per
   architecture group), giving whole replacement detectors with freshly
   fitted scalers and thresholds.

Either path publishes the updated members into the live collection
(``ModelCollection.publish``) and lands them as a new bank generation
through ``server/swap.py``'s ``build_bank``/``swap_bank``, the flip
``/reload`` rides, so an adaptation answers no request with an error.
Failures roll back completely: the ``stream.refit`` fault point fires
before training, and a failed build or swap restores the collection and
the registry's bank collectors, so the serving generation is untouched.

The JAX plane runs its ``GORDO_STREAM_ADAPT=auto`` loop and its push
loop as asyncio tasks and serializes adaptations on the app's asyncio
reload lock. The port's server is threaded: both loops are daemon
threads with a stop event, started by the app and stopped by
:meth:`App.close <gordo_components_torch.server.App.close>`, and an
adaptation holds ``app.reload_lock`` (the lock ``/reload`` takes) from
the member selection to the swap, as the JAX plane holds its lock.
"""

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from gordo_components_torch.dataset.base import TagFrame
from gordo_components_torch.ops.scaler import ScalerParams
from gordo_components_torch.resilience.faults import faultpoint
from gordo_components_torch.streaming.drift import DriftDetector
from gordo_components_torch.streaming.ingest import StreamIngestor
from gordo_components_torch.utils import env_num

logger = logging.getLogger(__name__)

# chaos site: fired at the head of the refit path — a failed refit must
# leave the serving generation untouched
_FP_REFIT = faultpoint("stream.refit")


def stream_enabled() -> bool:
    """``GORDO_STREAM`` on: the server builds the streaming plane."""
    return os.environ.get("GORDO_STREAM", "0") not in ("0", "", "false")


class StreamingPlane:
    """One per serving app (``App.stream`` when ``GORDO_STREAM=1``). Owns
    the ingestor, the drift detector, the adaptation entry points, the
    ``GORDO_STREAM_ADAPT=auto`` loop, the push loop and broker
    (``GORDO_PUSH=1``), and the ``gordo_stream_*``, ``gordo_drift_*`` and
    ``gordo_push_*`` series."""

    def __init__(self, app):
        self.app = app
        self.clock = app.clock
        self.ingestor = StreamIngestor(
            capacity=env_num("GORDO_STREAM_WINDOW", 512, int),
            lateness_s=env_num("GORDO_STREAM_LATENESS_S", 300.0, float),
            clock=self.clock,
        )
        self.detector = DriftDetector(
            app,
            self.ingestor,
            threshold=env_num("GORDO_DRIFT_THRESHOLD", 1.0, float),
            alpha=env_num("GORDO_DRIFT_ALPHA", 0.5, float),
            min_rows=env_num("GORDO_STREAM_MIN_ROWS", 32, int),
        )
        # EWMA weight of the fresh window in scaler recalibration
        self.recal_alpha = env_num("GORDO_RECAL_ALPHA", 0.5, float)
        self.refit_epochs = env_num("GORDO_REFIT_EPOCHS", 3, int)
        # auto-loop refit gate: drift_score above this escalates from
        # recalibration to refit (0 = the loop never refits on its own;
        # POST /adapt {"mode": "refit"} still works)
        self.refit_threshold = env_num("GORDO_REFIT_THRESHOLD", 0.0, float)
        self.interval_s = env_num("GORDO_STREAM_INTERVAL_S", 30.0, float)
        self.auto = os.environ.get("GORDO_STREAM_ADAPT", "").strip().lower() == "auto"
        # score-on-ingest push mode (streaming/push.py; default off)
        self.push_enabled = os.environ.get("GORDO_PUSH", "0") not in ("0", "", "false")
        self.broker = None
        self._push_dirty: set = set()
        self._push_dirty_lock = threading.Lock()
        self._pushed_wm: Dict[str, float] = {}
        self.push_stats: Dict[str, int] = {"windows_scored": 0, "publish_failed": 0}
        if self.push_enabled:
            from gordo_components_torch.streaming.push import PushBroker

            self.push_interval_s = env_num("GORDO_PUSH_INTERVAL_S", 0.25, float)
            self.broker = PushBroker(
                queue_max=env_num("GORDO_PUSH_QUEUE", 64, int),
                max_subscribers=env_num("GORDO_PUSH_SUBSCRIBERS_MAX", 16, int),
                sub_ttl_s=env_num("GORDO_PUSH_SUB_TTL_S", 120.0, float),
                clock=self.clock,
            )
        self.stats: Dict[str, Any] = {
            "adaptations": 0,
            "recalibrated_members": 0,
            "refit_members": 0,
            "refit_failed": 0,
            "last_mode": None,
            "last_error": None,
            "last_generation": None,
        }
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        app.metrics.collector(self._collect, key="stream")

    # ------------------------- metric surface -------------------------- #

    def _collect(self):
        """The same integers ``GET /drift`` reports (JAX ``_collect``)."""
        totals = self.ingestor.totals()
        yield ("gordo_stream_rows_total", "counter", "Ingested stream rows accepted into window buffers", {},
               totals["rows_total"])
        yield ("gordo_stream_late_rows_total", "counter",
               "Ingested rows that arrived behind the event-time watermark", {}, totals["late_rows_total"])
        yield ("gordo_stream_dropped_rows_total", "counter", "Late rows beyond GORDO_STREAM_LATENESS_S, dropped",
               {}, totals["dropped_rows_total"])
        yield ("gordo_stream_duplicate_rows_total", "counter",
               "Exact (timestamp, row) re-sends deduplicated at ingest", {}, totals["duplicate_rows_total"])
        yield ("gordo_stream_members", "gauge", "Members with live window buffers", {}, totals["buffers"])
        now = self.clock.time()
        lag = self.ingestor.max_watermark_lag_s(now)
        if lag is not None:
            yield ("gordo_stream_watermark_lag_seconds", "gauge",
                   "Worst wall-vs-event-time lag across window buffers", {}, lag)
        stale = self.ingestor.max_staleness_s(now)
        if stale is not None:
            yield ("gordo_model_staleness_seconds", "gauge",
                   "Seconds since fresh stream rows last arrived (worst member)", {}, stale)
        for name, st in sorted(self.detector.members.items()):
            if st.drift_score is not None:
                yield ("gordo_drift_score", "gauge",
                       "EWMA scaled reconstruction error / train-time threshold (>1 = drifted)", {"model": name},
                       st.drift_score)
        yield ("gordo_drift_members", "gauge", "Members currently flagged as drifted", {},
               len(self.detector.drifted_members()))
        yield ("gordo_stream_adaptations_total", "counter",
               "Applied adaptations (recalibrations or refits that swapped a new generation in)", {},
               self.stats["adaptations"])
        yield ("gordo_stream_recalibrated_members_total", "counter", "Members whose thresholds were recalibrated",
               {}, self.stats["recalibrated_members"])
        yield ("gordo_stream_refit_members_total", "counter", "Members incrementally refit", {},
               self.stats["refit_members"])
        yield ("gordo_stream_refit_failed_total", "counter",
               "Refit/recalibration attempts that failed and rolled back", {}, self.stats["refit_failed"])
        if self.broker is not None:
            bs = self.broker.stats()
            yield ("gordo_push_windows_scored_total", "counter",
                   "Windows scored by the push loop as watermarks advanced", {}, self.push_stats["windows_scored"])
            yield ("gordo_push_published_total", "counter",
                   "Scored-window results delivered to at least one subscriber", {}, bs["published_total"])
            yield ("gordo_push_dropped_total", "counter",
                   "Results dropped from slow subscribers' bounded queues (drop-oldest)", {}, bs["dropped_total"])
            yield ("gordo_push_subscribers", "gauge", "Live push subscribers", {}, bs["subscribers"])

    # ---------------------------- ingestion ---------------------------- #

    def ingest(self, name: str, event_ts, values) -> Dict[str, Any]:
        counts = self.ingestor.ingest(name, event_ts, values)
        if self.broker is not None and counts.get("accepted"):
            # the push loop scores the member's advanced window off the
            # request path
            with self._push_dirty_lock:
                self._push_dirty.add(name)
        return counts

    # ------------------------- drift evaluation ------------------------ #

    def evaluate(self) -> Dict[str, Any]:
        """One drift sweep; a member newly flagged or newly cleared lands
        on the event log as ``drift.flagged`` / ``drift.cleared``."""
        before = set(self.detector.drifted_members())
        result = self.detector.evaluate()
        events = self.app.events
        after = set(self.detector.drifted_members())
        generation = self.app.generation()
        for name in sorted(after - before):
            events.emit("drift.flagged", severity="warning", generation=generation, target=name)
        for name in sorted(before - after):
            events.emit("drift.cleared", generation=generation, target=name)
        return result

    def drift_view(self) -> Dict[str, Any]:
        body = self.detector.view()
        body["auto"] = self.auto
        body["interval_s"] = self.interval_s
        body["refit_threshold"] = self.refit_threshold
        body["stats"] = dict(self.stats)
        push: Dict[str, Any] = {"enabled": self.push_enabled}
        if self.broker is not None:
            push.update(self.broker.stats())
            push.update(self.push_stats)
        body["push"] = push
        return body

    # ----------------------- score-on-ingest push ----------------------- #

    def push_once(self) -> None:
        """One turn of the push loop: score each dirty member's window rows
        past its last pushed watermark and publish the result. Banked
        members go through the batching engine the request path uses, all
        submitted before any is awaited, so they coalesce; the others
        through their own ``anomaly()``. A member whose scoring fails keeps
        its watermark and is tried again at its next advance."""
        with self._push_dirty_lock:
            dirty, self._push_dirty = self._push_dirty, set()
        engine = self.app.engine
        pending = []
        for name in sorted(dirty):
            try:
                work = self._push_submit(name, engine)
            except Exception:
                self.push_stats["publish_failed"] += 1
                logger.warning("push scoring failed for %r", name, exc_info=True)
                continue
            if work is not None:
                pending.append((name, *work))
        for name, det, ts, vals, fut, total in pending:
            try:
                if fut is not None:
                    total = np.asarray(fut.result().total_scaled).ravel()
                self._publish(name, det, ts, vals, total)
            except Exception:
                self.push_stats["publish_failed"] += 1
                logger.warning("push scoring failed for %r", name, exc_info=True)

    def _push_submit(self, name: str, engine):
        """``(detector, event times, rows, the engine's future, None)`` for
        a banked member's rows to push, ``(..., None, totals)`` for another
        member's, None when there is nothing to push."""
        buf = self.ingestor.buffers.get(name)
        det = self.app.collection.models.get(name)
        if buf is None or det is None:
            return None
        ts, vals = buf.clean_window()
        last = self._pushed_wm.get(name)
        if last is not None:
            keep = ts > last
            ts, vals = ts[keep], vals[keep]
        if not len(vals):
            return None
        rows = np.ascontiguousarray(vals, np.float32)
        if engine is not None and name in engine.bank:
            return det, ts, vals, engine.submit(name, rows), None
        return det, ts, vals, None, np.asarray(det.anomaly(rows)["total-anomaly-scaled"]).ravel()

    def _publish(self, name: str, det, ts, vals, total) -> None:
        if total.size == 0:
            # a sequence member's warm-up ate the whole increment: keep
            # the watermark so these rows rejoin the next window
            return
        self.push_stats["windows_scored"] += 1
        self._pushed_wm[name] = float(ts.max())
        threshold = getattr(det, "total_threshold_", None)
        threshold = None if threshold is None else float(threshold)
        doc = {
            "target": name,
            "watermark": float(ts.max()),
            "rows": int(len(vals)),
            "scored": int(total.size),
            "total_scaled": [float(v) for v in total],
            "threshold": threshold,
            "anomalies": None if threshold is None else int((total > threshold).sum()),
            "at": self.clock.time(),
        }
        self.broker.publish(name, doc)

    # --------------------------- adaptation ---------------------------- #

    def adapt(self, mode: str = "recalibrate", targets: Optional[List[str]] = None) -> Dict[str, Any]:
        """Recalibrate (or refit) ``targets`` (default: the currently
        drifted members) and apply the result as a new bank generation.
        Failures leave the serving generation untouched and re-raise."""
        if mode not in ("recalibrate", "refit"):
            raise ValueError(f"mode must be recalibrate|refit, got {mode!r}")
        app = self.app
        with app.reload_lock:
            names = list(targets) if targets else self.detector.drifted_members()
            if not names:
                return {"applied": False, "reason": "no drifted members", "mode": mode}
            collection = app.collection
            prev_state = collection.snapshot()
            registry = app.metrics
            worker = self._refit_sync if mode == "refit" else self._recalibrate_sync
            try:
                updates = worker(names)
            except Exception as exc:
                self.stats["refit_failed"] += 1
                self.stats["last_error"] = f"{type(exc).__name__}: {exc}"
                raise
            if not updates:
                return {"applied": False, "mode": mode, "reason": "no member had a usable fresh window"}
            swap_info = None
            collection.publish(updates, note={"adapted": mode, "at": self.clock.time()})
            if app.bank is not None:
                from gordo_components_torch.server.swap import (
                    build_bank,
                    restore_collectors,
                    snapshot_collectors,
                    swap_bank,
                )

                prev_collectors = snapshot_collectors(registry)
                try:
                    result = swap_bank(app, build_bank(app), prev_collectors=prev_collectors)
                except Exception as exc:
                    # full rollback: the published models AND the registry's
                    # bank collectors return to the serving generation's
                    collection.restore(prev_state)
                    restore_collectors(registry, prev_collectors)
                    self.stats["refit_failed"] += 1
                    self.stats["last_error"] = f"{type(exc).__name__}: {exc}"
                    app.events.emit("adapt.rolled_back", severity="error", generation=app.generation(),
                                    mode=mode, members=sorted(updates), error=f"{type(exc).__name__}: {exc}")
                    raise
                swap_info = {
                    "generation": result.generation,
                    "pause_ms": round(result.pause_s * 1e3, 3),
                    "build_s": round(result.build_s, 3),
                }
                self.stats["last_generation"] = result.generation
            self.stats["adaptations"] += 1
            self.stats["last_mode"] = mode
            self.stats["last_error"] = None
            key = "refit_members" if mode == "refit" else "recalibrated_members"
            self.stats[key] += len(updates)
            # the adapted members' EWMA was measured under the old
            # calibration: reset so the next sweep measures afresh
            self.detector.reset_members(updates)
            app.events.emit(f"adapt.{mode}", generation=app.generation(), members=sorted(updates))
            body: Dict[str, Any] = {"applied": True, "mode": mode, "members": sorted(updates)}
            if swap_info is not None:
                body["swap"] = swap_info
            return body

    # ------------------- recalibration (no retrain) -------------------- #

    def _recalibrate_sync(self, names: List[str]) -> Dict[str, Any]:
        """Per member: re-fit the error scaler on the fresh window,
        EWMA-blend it with the serving scaler, re-derive the thresholds at
        the member's quantile. name -> replacement detector; a member that
        fails is skipped (logged), never the batch."""
        models = self.app.collection.models
        updates: Dict[str, Any] = {}
        for name in names:
            try:
                new_det = self._recalibrate_one(models, name, self.recal_alpha)
            except Exception:
                logger.warning("recalibration failed for %r; other members proceed", name, exc_info=True)
                continue
            if new_det is not None:
                updates[name] = new_det
        return updates

    def _recalibrate_one(self, models, name: str, a: float):
        det = models.get(name)
        buf = self.ingestor.buffers.get(name)
        if det is None or buf is None:
            return None
        _ts, X = buf.clean_window()
        # a sequence member consumes its warm-up rows before the first
        # scored row exists, the floor the refit path applies
        if len(X) < max(self.detector.min_rows, det.offset + 8):
            return None
        old = getattr(det, "error_scaler_", None)
        if old is None:
            return None
        Xv = np.asarray(X, np.float32)
        output = det._predict_model_space(Xv)
        target = det._model_space(Xv)
        target = target[det.offset:][: output.shape[0]]
        diff = np.abs(target - output)
        # window min-max in error space, blended with the serving scaler in
        # (shift, range) form: blending the reciprocal scale directly
        # would bias toward the tighter range
        w_min = np.nanmin(diff, axis=0)
        w_max = np.nanmax(diff, axis=0)
        w_range = np.where(np.abs(w_max - w_min) < 1e-12, 1.0, w_max - w_min)
        old_shift = np.asarray(old.shift, np.float32)
        old_range = np.where(np.asarray(old.scale) == 0, 1.0, 1.0 / np.asarray(old.scale))
        shift = ((1 - a) * old_shift + a * w_min).astype(np.float32)
        rng_ = ((1 - a) * old_range + a * w_range).astype(np.float32)
        scaler = ScalerParams(shift=shift, scale=(1.0 / rng_).astype(np.float32))
        scaled = (diff - shift) * scaler.scale
        q = float(getattr(det, "threshold_quantile", 1.0))
        return det.recalibrated(scaler, np.quantile(scaled, q, axis=0),
                                float(np.quantile(np.linalg.norm(scaled, axis=-1), q)), "recalibrated-ewma")

    # --------------------- incremental refit (gang) -------------------- #

    def _refit_sync(self, names: List[str]) -> Dict[str, Any]:
        """Fine-tune the named members for a few epochs through
        ``FleetTrainer`` on their fresh windows, warm-started from the
        serving weights (``initial_params``). Members group by
        architecture: one gang per (model type, kind, factory kwargs,
        lookback, target offset, quantile, compute dtype)."""
        _FP_REFIT.fire()
        from gordo_components_torch.parallel.fleet import FleetTrainer

        models = self.app.collection.models
        groups: Dict[str, Dict[str, Any]] = {}
        for name in names:
            det = models.get(name)
            buf = self.ingestor.buffers.get(name)
            if det is None or buf is None or not hasattr(det, "to_entry"):
                continue
            try:
                entry = det.to_entry(name)
            except Exception:
                continue
            ts, X = buf.clean_window()
            if len(X) < max(self.detector.min_rows, entry.lookback + entry.target_offset + 8):
                continue
            q = float(getattr(det, "threshold_quantile", 1.0))
            sig = repr((entry.registry_type, entry.kind, sorted(entry.factory_kwargs.items()), entry.lookback,
                        entry.target_offset, q, entry.compute_dtype))
            g = groups.setdefault(sig, {"entry": entry, "q": q, "members": {}, "initial": {}})
            tags = list(getattr(det, "tags_", None) or [f"feature-{i}" for i in range(X.shape[1])])
            index = (np.asarray(ts) * 1e9).astype("int64").astype("datetime64[ns]")
            g["members"][name] = TagFrame(np.asarray(X, np.float32), index, tags)
            g["initial"][name] = {k: np.asarray(v, np.float32) for k, v in entry.params.items()}
        updates: Dict[str, Any] = {}
        for g in groups.values():
            entry = g["entry"]
            trainer = FleetTrainer(
                model_type=entry.registry_type,
                kind=entry.kind,
                epochs=max(1, self.refit_epochs),
                batch_size=64,
                lookback_window=entry.lookback,
                threshold_quantile=g["q"],
                compute_dtype=entry.compute_dtype,
                device=self.app.device,
                **entry.factory_kwargs,
            )
            fleet = trainer.fit(g["members"], initial_params=g["initial"])
            for name, member in fleet.items():
                new_det = member.to_estimator()
                new_det.threshold_method_ = "incremental-refit"
                updates[name] = new_det
        return updates

    # ------------------------- the loops ------------------------------- #

    def start(self) -> None:
        """Start the auto loop (``GORDO_STREAM_ADAPT=auto``) and the push
        loop (``GORDO_PUSH=1``) on daemon threads."""
        if self._threads:
            return
        self._stop.clear()
        if self.auto:
            self._threads.append(threading.Thread(target=self._run, name="gordo-stream-adapt", daemon=True))
        if self.broker is not None:
            self._threads.append(threading.Thread(target=self._push_run, name="gordo-stream-push", daemon=True))
        for t in self._threads:
            t.start()

    def stop(self, timeout: float = 30.0) -> None:
        """Stop both loops (a turn in progress finishes first) and release
        every parked long poll."""
        self._stop.set()
        if self.broker is not None:
            self.broker.close()
        for t in self._threads:
            t.join(timeout)
        self._threads = []

    def _push_run(self) -> None:
        # the interval is in event seconds: under a replay clock the real
        # sleep shrinks by its timescale
        while not self._stop.wait(self.push_interval_s / max(1.0, self.clock.timescale)):
            self.push_once()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s / max(1.0, self.clock.timescale)):
            try:
                self.auto_once()
            except Exception:
                # the adapt() rollback contract already ran; the loop
                # survives to try again next interval
                logger.warning("auto adaptation attempt failed; serving generation untouched", exc_info=True)

    def auto_once(self) -> None:
        """One turn of the auto loop: a sweep, then recalibrate every
        drifted member and refit those at or above
        ``GORDO_REFIT_THRESHOLD`` (when it is above 0)."""
        self.evaluate()
        drifted = self.detector.drifted_members()
        if not drifted:
            return
        hot = []
        if self.refit_threshold > 0:
            hot = [n for n in drifted if (self.detector.members[n].drift_score or 0) >= self.refit_threshold]
        self.adapt("recalibrate", targets=drifted)
        if hot:
            self.adapt("refit", targets=hot)
