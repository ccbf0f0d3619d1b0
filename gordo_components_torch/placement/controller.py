"""The placement control loop.

Counterpart of ``gordo_components_tpu/placement/controller.py``. One
controller a serving app with the bank on (``build_app`` attaches it as
``app.placement``). It owns:

- the decision window: per-member routed rows read as deltas since the
  last applied plan, so a long balanced history never buries a newly hot
  member;
- the plan and the swap (build, flip, bounded drain), under the app's
  reload lock: a rebalance and a ``/reload`` both rebuild the bank and never
  interleave;
- the ``GORDO_REBALANCE=auto`` evaluator, a thread of the app (the JAX one
  is an asyncio task), stopped by :meth:`stop`;
- the ``gordo_rebalance_*`` and ``gordo_bank_generation`` series and the
  forced ``rebalance`` trace with the spans ``plan``, ``build``, ``swap`` and
  ``drain``.
"""

import logging
import os
import threading
import time
from typing import Any, Dict, Optional

from gordo_components_torch.placement.planner import (
    RebalancePlan,
    default_threshold,
    plan_rebalance,
    skew_ratio,
)
from gordo_components_torch.server.swap import (
    build_bank,
    restore_collectors,
    snapshot_collectors,
    swap_bank,
    wait_drained,
)
from gordo_components_torch.utils import env_num

logger = logging.getLogger(__name__)


def _shard_loads(bucket: Dict[str, Any], loads: Dict[str, float]) -> list:
    """A placement bucket's per-shard sums of ``loads``."""
    size = int(bucket["shard_size"]) or len(bucket["members"])
    n_shards = max(1, int(bucket["n_shards"]))
    per_shard = [0.0] * n_shards
    for i, name in enumerate(bucket["members"]):
        per_shard[min(i // size, n_shards - 1)] += loads.get(name, 0.0)
    return per_shard


class PlacementController:
    """Evaluates the planner against the live bank and applies its plans
    through the zero-downtime swap."""

    def __init__(self, app, threshold: Optional[float] = None, min_rows: Optional[int] = None,
                 min_pad_ratio: Optional[float] = None, interval_s: Optional[float] = None,
                 drain_timeout_s: Optional[float] = None):
        self.app = app
        self.threshold = default_threshold() if threshold is None else float(threshold)
        # a handful of warm-up requests is not a traffic distribution
        self.min_rows = env_num("GORDO_REBALANCE_MIN_ROWS", 4096, int) if min_rows is None else int(min_rows)
        # the goodput gate (0 disables it)
        self.min_pad_ratio = (env_num("GORDO_REBALANCE_MIN_PAD_RATIO", 0.0, float)
                              if min_pad_ratio is None else float(min_pad_ratio))
        self.interval_s = env_num("GORDO_REBALANCE_INTERVAL_S", 60.0, float) if interval_s is None else float(interval_s)
        self.drain_timeout_s = (env_num("GORDO_SWAP_DRAIN_S", 5.0, float)
                                if drain_timeout_s is None else float(drain_timeout_s))
        self.auto = os.environ.get("GORDO_REBALANCE", "").strip().lower() == "auto"
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # routed rows a member at the last applied plan (or the start)
        self._load_baseline: Dict[str, float] = {}
        self.stats: Dict[str, Any] = {
            "evaluated": 0,
            "applied": 0,
            "noop": 0,
            "failed": 0,
            "last_reason": None,
            "last_improvement": None,
            "last_pause_ms": None,
            "last_generation": 0,
            "last_drained": None,
            "last_error": None,
        }
        registry = app.metrics
        self._pause_hist = None
        if registry is not None:
            self._pause_hist = registry.histogram(
                "gordo_rebalance_swap_pause_seconds",
                "Generation-flip pause per applied swap (the only serving pause a rebalance or reload incurs)",
                lo=1e-6, hi=10.0).labels()
            registry.collector(self._collect, key="placement")

    def _collect(self):
        """The same integers ``GET /placement`` reports."""
        s = self.stats
        yield ("gordo_bank_generation", "gauge",
               "Bank generation serving right now (bumps on every applied swap: rebalance or reload)", {},
               int(self.app.generation() or 0))
        yield ("gordo_rebalance_total", "counter", "Rebalance plans applied (bank swapped)", {}, s["applied"])
        yield ("gordo_rebalance_noop_total", "counter", "Rebalance evaluations that decided not to swap", {},
               s["noop"])
        yield ("gordo_rebalance_failed_total", "counter",
               "Rebalance attempts that failed and rolled back to the old generation", {}, s["failed"])
        yield ("gordo_rebalance_last_improvement", "gauge",
               "Predicted skew improvement factor of the last applied plan", {}, s["last_improvement"] or 0.0)

    # ------------------------- load window ---------------------------- #

    def observed_loads(self) -> Dict[str, float]:
        """Per-member routed rows since the last applied plan."""
        bank = self.app.bank
        rows = getattr(bank, "model_rows", None) or {}
        rows = rows.copy()  # one copy: scoring threads insert into it
        base = self._load_baseline
        return {name: delta for name, total in rows.items() if (delta := total - base.get(name, 0.0)) > 0}

    def observed_skew(self) -> Optional[float]:
        """The window's skew over the live placement."""
        bank = self.app.bank
        if bank is None:
            return None
        loads = self.observed_loads()
        placement = bank.placement()["buckets"]
        n_shards = max((int(b["n_shards"]) for b in placement), default=0)
        if n_shards < 2:
            return None
        per_shard = [0.0] * n_shards
        for b in placement:
            for d, rows in enumerate(_shard_loads(b, loads)):
                per_shard[d] += rows
        return skew_ratio(per_shard)

    # --------------------------- planning ----------------------------- #

    def plan(self) -> RebalancePlan:
        bank = self.app.bank
        if bank is None:
            return plan_rebalance([], {}, threshold=self.threshold)
        ledger = self.app.ledger
        return plan_rebalance(bank.placement()["buckets"], self.observed_loads(), threshold=self.threshold,
                              min_rows=self.min_rows, goodput=ledger.snapshot() if ledger is not None else None,
                              min_pad_ratio=self.min_pad_ratio)

    def placement_view(self, dry_run: bool = False) -> Dict[str, Any]:
        """The ``GET /placement`` body: the live assignment with each
        shard's window load, the observed loads (``member_rows``: the
        watchman's fleet planner reads them), the knobs and counters, and
        with ``dry_run`` the plan ``POST /rebalance`` would apply now."""
        bank = self.app.bank
        loads = self.observed_loads()
        body: Dict[str, Any] = {
            "enabled": True,
            "generation": int(self.app.generation() or 0),
            "auto": self.auto,
            "threshold": self.threshold,
            "min_rows": self.min_rows,
            "interval_s": self.interval_s,
            "observed": {
                "rows": int(sum(loads.values())),
                "members_with_traffic": len(loads),
                "skew_ratio": self.observed_skew(),
            },
            "member_rows": {name: int(v) for name, v in loads.items()},
            "stats": dict(self.stats),
        }
        if bank is not None:
            placement = bank.placement()
            for b in placement["buckets"]:
                b["shard_loads"] = [round(v, 1) for v in _shard_loads(b, loads)]
            body.update(placement)
        if dry_run:
            body["plan"] = self.plan().summary()
        return body

    # ---------------------------- acting ------------------------------ #

    def record_swap(self, result) -> None:
        """Record a flip, whichever path made it (a rebalance, ``/reload``,
        a mesh acquire or release)."""
        self.stats["last_pause_ms"] = round(result.pause_s * 1e3, 3)
        self.stats["last_generation"] = result.generation
        if self._pause_hist is not None:
            self._pause_hist.record(result.pause_s)

    def rebalance(self, force: bool = False, dry_run: bool = False) -> Dict[str, Any]:
        """Evaluate the planner and, unless ``dry_run``, apply its plan
        through the swap. ``force`` overrides the threshold and the
        min-rows gate, never a plan with nothing to move. A failed swap has
        rolled back when this raises."""
        with self.app.reload_lock:
            self.stats["evaluated"] += 1
            plan = self.plan()
            applicable = plan.should_apply or (
                force and plan.moved > 0 and any(b.n_shards > 1 for b in plan.buckets))
            if dry_run or not applicable:
                if not dry_run:
                    self.stats["noop"] += 1
                    self.stats["last_reason"] = plan.reason
                return {"applied": False, "dry_run": dry_run, "plan": plan.summary()}
            return self._apply(plan, forced=force and not plan.should_apply)

    def _apply(self, plan: RebalancePlan, forced: bool) -> Dict[str, Any]:
        app = self.app
        tracer = app.tracer
        trace = tracer.start_trace("rebalance", force=True) if tracer is not None else None
        t_plan = time.monotonic()
        old_bank = app.bank
        # the applied plan consumed exactly this window
        baseline = dict(old_bank.model_rows.copy() if old_bank.model_rows else {})
        registry = app.metrics
        prev_collectors = snapshot_collectors(registry)
        try:
            t_build = time.monotonic()
            new_bank = build_bank(app, member_order=plan.member_order())
            t_swap = time.monotonic()
            result = swap_bank(app, new_bank, prev_collectors=prev_collectors)
            t_drain = time.monotonic()
            drained = wait_drained(old_bank, self.drain_timeout_s)
        except Exception as exc:
            # a failed build may already have replaced the bank collectors
            restore_collectors(registry, prev_collectors)
            self.stats["failed"] += 1
            self.stats["last_error"] = f"{type(exc).__name__}: {exc}"
            if trace is not None:
                trace.add_span("plan", t_plan, time.monotonic(), error=True)
                trace.finish(error=True)
            raise
        self._load_baseline = baseline
        self.stats["applied"] += 1
        self.stats["last_reason"] = plan.reason
        self.stats["last_improvement"] = plan.improvement
        self.stats["last_drained"] = drained
        self.stats["last_error"] = None
        self.record_swap(result)
        if trace is not None:
            t_end = time.monotonic()
            trace.add_span("plan", t_plan, t_build, moved=plan.moved, improvement=plan.improvement)
            trace.add_span("build", t_build, t_swap, models=result.bank_models)
            trace.add_span("swap", t_swap, t_drain, generation=result.generation,
                           pause_ms=round(result.pause_s * 1e3, 3))
            trace.add_span("drain", t_drain, t_end, drained=drained)
            trace.finish(error=False, generation=result.generation)
        logger.info("rebalance applied: %s (generation %d, pause %.3fms, drained=%s)", plan.reason,
                    result.generation, result.pause_s * 1e3, drained)
        return {
            "applied": True,
            "forced": forced,
            "plan": plan.summary(),
            "swap": {
                "generation": result.generation,
                "pause_ms": round(result.pause_s * 1e3, 3),
                "build_s": round(result.build_s, 3),
                "warmup_s": round(result.warmup_s, 3),
                "drained": drained,
            },
        }

    # ------------------------- the auto loop -------------------------- #

    def start(self) -> None:
        """Start the ``GORDO_REBALANCE=auto`` evaluator (nothing in manual
        mode: the routes work either way)."""
        if self.auto and self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, name="gordo-rebalance", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(30.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.rebalance()
            except Exception:
                # rolled back and counted: the loop tries again
                logger.warning("auto rebalance attempt failed; old generation keeps serving", exc_info=True)
