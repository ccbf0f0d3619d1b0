"""Deterministic load-aware shard rebalance planner.

Counterpart of ``gordo_components_tpu/placement/planner.py``, line for line:
pure host code, so a plan equals the JAX one on the same loads.

The bank places each bucket's members in contiguous blocks of
``shard_size`` along the stacked model axis (``server/bank.py``
``_Bucket``): member i lives on shard ``i // shard_size``. That
placement is fixed at build time by insertion order — so a hot model
(or several that happen to sort adjacently) concentrates routed rows on
one shard while the others dispatch the same ``Bl * T`` rows as padding.

This module turns the observed per-model routed-row counters into a
better stacking order:

- **Constraint**: every shard holds exactly ``shard_size`` stack slots
  (the equal-HBM-per-chip capacity constraint — the stacked pytree's
  leading axis must split evenly over the mesh, so a plan can only
  permute members between equal-sized blocks, never grow one).
- **Objective**: minimize predicted skew = max/mean of per-shard routed
  rows, the exact quantity ``gordo_fleet_shard_skew_ratio`` reports.
- **Algorithm**: greedy longest-processing-time (LPT) per bucket —
  members sorted by observed load descending (name tiebreak, so equal
  inputs always produce the identical plan) are assigned one at a time
  to the least-loaded shard that still has a free slot. LPT is the
  textbook 4/3-approximation for makespan on identical machines; under
  the slot cap it stays within one hot member of optimal, which is all
  a serving rebalance needs.
- **Hysteresis**: a plan only marks itself applicable when the
  predicted improvement factor (skew_before / skew_after) clears a
  configurable threshold — a no-op or marginal plan must never trigger
  a bank rebuild (``GORDO_REBALANCE_THRESHOLD``, default 1.2).

The planner is pure (no bank mutation, no clocks): bank placement in,
:class:`RebalancePlan` out. The goodput ledger snapshot rides in as a
second gate — when the fleet's padded-row waste ratio is already below
``min_pad_ratio`` there is nothing worth rebuilding a bank over, no
matter what the raw skew number says.
"""

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence

DEFAULT_IMPROVEMENT_THRESHOLD = 1.2


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}") from None


def default_threshold() -> float:
    """Improvement factor a plan must predict before it applies
    (``GORDO_REBALANCE_THRESHOLD``; docs/operations.md knob table)."""
    return _env_float(
        "GORDO_REBALANCE_THRESHOLD", DEFAULT_IMPROVEMENT_THRESHOLD
    )


def skew_ratio(loads: Sequence[float]) -> Optional[float]:
    """max/mean over per-shard loads — the fleet skew definition
    (``watchman/server.py::aggregate_fleet_metrics``). ``None`` when
    there is no load at all (no signal is not "perfectly balanced")."""
    vals = list(loads)
    if not vals:
        return None
    mean = sum(vals) / len(vals)
    if mean <= 0:
        return None
    return max(vals) / mean


@dataclass
class BucketPlan:
    """One bucket's planned stacking order."""

    bucket: str  # the bucket's metric label
    key: str  # the bank's internal bucket key (identity across rebuilds)
    n_shards: int
    shard_size: int
    order: List[str]  # new stack order; shard d = order[d*size:(d+1)*size]
    moved: int  # members whose owning shard changed
    skew_before: Optional[float]
    skew_after: Optional[float]
    shard_loads_before: List[float] = field(default_factory=list)
    shard_loads_after: List[float] = field(default_factory=list)

    def summary(self) -> Dict[str, Any]:
        return {
            "bucket": self.bucket,
            "n_shards": self.n_shards,
            "shard_size": self.shard_size,
            "members": len(self.order),
            "moved": self.moved,
            "skew_before": _r(self.skew_before),
            "skew_after": _r(self.skew_after),
            "shard_loads_before": self.shard_loads_before,
            "shard_loads_after": self.shard_loads_after,
        }


@dataclass
class RebalancePlan:
    """A full plan over every sharded bucket, plus the verdict."""

    buckets: List[BucketPlan]
    skew_before: Optional[float]  # combined per-shard loads, all buckets
    skew_after: Optional[float]
    improvement: Optional[float]
    threshold: float
    should_apply: bool
    reason: str
    observed_rows: int  # total routed rows feeding the plan
    moved: int

    def member_order(self) -> Dict[str, List[str]]:
        """Per-bucket-key planned stack order, the shape
        :func:`~gordo_components_torch.server.swap.build_bank` takes."""
        return {b.key: list(b.order) for b in self.buckets}

    def summary(self) -> Dict[str, Any]:
        return {
            "should_apply": self.should_apply,
            "reason": self.reason,
            "skew_before": _r(self.skew_before),
            "skew_after": _r(self.skew_after),
            "improvement": _r(self.improvement),
            "threshold": self.threshold,
            "observed_rows": self.observed_rows,
            "moved": self.moved,
            "buckets": [b.summary() for b in self.buckets],
        }


def _r(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(float(v), 4)


def _plan_bucket(
    bucket: Mapping[str, Any], loads: Mapping[str, float]
) -> BucketPlan:
    members: List[str] = list(bucket["members"])
    n_shards = max(1, int(bucket["n_shards"]))
    shard_size = int(bucket["shard_size"]) or len(members)
    mload = {name: float(loads.get(name, 0.0)) for name in members}

    before = [0.0] * n_shards
    for i, name in enumerate(members):
        before[min(i // shard_size, n_shards - 1)] += mload[name]

    # LPT under the slot cap: hottest first into the least-loaded shard
    # with a free slot; ties break on shard index, then member name —
    # the same inputs must always emit the same plan (the determinism
    # contract tests/test_torch_placement.py pins)
    ranked = sorted(members, key=lambda n: (-mload[n], n))
    assigned: List[List[str]] = [[] for _ in range(n_shards)]
    shard_load = [0.0] * n_shards
    for name in ranked:
        d = min(
            (di for di in range(n_shards) if len(assigned[di]) < shard_size),
            key=lambda di: (shard_load[di], di),
        )
        assigned[d].append(name)
        shard_load[d] += mload[name]

    old_shard = {
        name: min(i // shard_size, n_shards - 1)
        for i, name in enumerate(members)
    }
    moved = sum(
        1
        for d, block in enumerate(assigned)
        for name in block
        if old_shard[name] != d
    )
    order = [name for block in assigned for name in block]
    return BucketPlan(
        bucket=str(bucket.get("bucket", "?")),
        key=str(bucket.get("key", bucket.get("bucket", "?"))),
        n_shards=n_shards,
        shard_size=shard_size,
        order=order,
        moved=moved,
        skew_before=skew_ratio(before),
        skew_after=skew_ratio(shard_load),
        shard_loads_before=[round(v, 1) for v in before],
        shard_loads_after=[round(v, 1) for v in shard_load],
    )


def plan_rebalance(
    placement: Sequence[Mapping[str, Any]],
    loads: Mapping[str, float],
    threshold: Optional[float] = None,
    min_rows: int = 0,
    goodput: Optional[Mapping[str, Any]] = None,
    min_pad_ratio: float = 0.0,
) -> RebalancePlan:
    """Plan a rebalance over a bank's current placement.

    ``placement`` is ``ModelBank.placement()["buckets"]`` (per bucket:
    members in stack order, ``n_shards``, ``shard_size``); ``loads``
    maps member name -> observed routed rows over the decision window
    (the controller feeds the delta since the last applied plan, so an
    old hot streak cannot bury a new one). ``goodput`` (optional, a
    ``GoodputLedger.snapshot()``) gates the plan on the fleet's
    padded-row waste ratio: below ``min_pad_ratio`` the skew isn't
    costing device time worth a rebuild. The plan is advisory —
    ``should_apply`` encodes the verdict, the caller decides."""
    if threshold is None:
        threshold = default_threshold()
    sharded = [b for b in placement if int(b.get("n_shards", 1)) > 1]
    observed_rows = int(sum(loads.values())) if loads else 0
    plans = [_plan_bucket(b, loads) for b in sharded]
    moved = sum(p.moved for p in plans)

    # combined per-shard loads across buckets: the per-shard routed-row
    # counters (and the fleet skew gauge) sum over buckets, so the
    # verdict must be computed on the same aggregate, not per bucket
    n_shards = max((p.n_shards for p in plans), default=0)
    combined_before = [0.0] * n_shards
    combined_after = [0.0] * n_shards
    for p in plans:
        for d in range(p.n_shards):
            combined_before[d] += p.shard_loads_before[d]
            combined_after[d] += p.shard_loads_after[d]
    skew_before = skew_ratio(combined_before)
    skew_after = skew_ratio(combined_after)
    improvement = (
        skew_before / skew_after
        if skew_before is not None and skew_after not in (None, 0.0)
        else None
    )

    def plan(should_apply: bool, reason: str) -> RebalancePlan:
        return RebalancePlan(
            buckets=plans,
            skew_before=skew_before,
            skew_after=skew_after,
            improvement=improvement,
            threshold=float(threshold),
            should_apply=should_apply,
            reason=reason,
            observed_rows=observed_rows,
            moved=moved,
        )

    if not plans:
        return plan(False, "no sharded buckets (single-shard bank)")
    if observed_rows < min_rows:
        return plan(
            False,
            f"insufficient load signal ({observed_rows} routed rows "
            f"observed, need >= {min_rows})",
        )
    if goodput is not None and min_pad_ratio > 0.0:
        pad = goodput.get("padded_row_waste_ratio")
        if pad is not None and pad < min_pad_ratio:
            return plan(
                False,
                f"padded-row waste ratio {pad:.4f} below floor "
                f"{min_pad_ratio:.4f}: skew is not costing device time",
            )
    if moved == 0:
        return plan(False, "placement already optimal (nothing to move)")
    if improvement is None:
        return plan(False, "no routed-row signal on any sharded bucket")
    if improvement < threshold:
        return plan(
            False,
            f"predicted improvement {improvement:.2f}x below threshold "
            f"{threshold:.2f}x",
        )
    return plan(
        True,
        f"predicted skew {skew_before:.2f} -> {skew_after:.2f} "
        f"({improvement:.2f}x improvement, {moved} member(s) move)",
    )


# ---------------------------------------------------------------------- #
# fleet tier (multi-host serving mesh): which REPLICA owns each member
# ---------------------------------------------------------------------- #
#
# The intra-host tier above permutes members between a bank's shards —
# free to apply (one local rebuild + flip). The fleet tier moves members
# between REPLICAS, which costs an artifact ship plus a bank rebuild on
# BOTH sides — so it plans few, high-value moves (bounded by max_moves)
# instead of a full LPT reshuffle, and it must never target a replica
# that is degraded, unreachable, or burning its SLO budget: handing a
# hot member to a sick replica converts a skew problem into an outage.


def default_fleet_threshold() -> float:
    """Improvement factor a fleet plan must predict before it applies
    (``GORDO_MESH_THRESHOLD``; falls back to the intra-host rebalance
    threshold so one tuned hysteresis covers both tiers unless the
    operator splits them)."""
    return _env_float("GORDO_MESH_THRESHOLD", default_threshold())


def default_max_moves() -> int:
    """Cross-replica moves per plan (``GORDO_MESH_MAX_MOVES``): each
    move ships an artifact and rebuilds two banks, so the default keeps
    a single plan's disruption small and lets the watchman loop converge
    over several evaluations instead of one big bang."""
    return int(_env_float("GORDO_MESH_MAX_MOVES", 4))


@dataclass
class FleetMove:
    """One planned cross-replica ownership change."""

    member: str
    src: int  # replica index losing the member
    dst: int  # replica index gaining it
    rows: float  # the member's observed window load

    def summary(self) -> Dict[str, Any]:
        return {
            "member": self.member,
            "src": self.src,
            "dst": self.dst,
            "rows": int(self.rows),
        }


@dataclass
class FleetPlan:
    """A fleet-tier plan: ordered moves plus the verdict."""

    moves: List[FleetMove]
    replica_rows_before: Dict[int, float]
    replica_rows_after: Dict[int, float]
    skew_before: Optional[float]
    skew_after: Optional[float]
    improvement: Optional[float]
    threshold: float
    should_apply: bool
    reason: str
    observed_rows: int
    eligible: List[int]  # replicas eligible as move DESTINATIONS

    def summary(self) -> Dict[str, Any]:
        return {
            "should_apply": self.should_apply,
            "reason": self.reason,
            "moves": [m.summary() for m in self.moves],
            "replica_rows_before": {
                str(k): round(v, 1)
                for k, v in sorted(self.replica_rows_before.items())
            },
            "replica_rows_after": {
                str(k): round(v, 1)
                for k, v in sorted(self.replica_rows_after.items())
            },
            "skew_before": _r(self.skew_before),
            "skew_after": _r(self.skew_after),
            "improvement": _r(self.improvement),
            "threshold": self.threshold,
            "observed_rows": self.observed_rows,
            "eligible": list(self.eligible),
        }


def plan_fleet(
    members_by_replica: Mapping[int, Sequence[str]],
    loads: Mapping[str, float],
    replica_health: Optional[Mapping[int, str]] = None,
    threshold: Optional[float] = None,
    min_rows: int = 0,
    max_moves: Optional[int] = None,
) -> FleetPlan:
    """Plan cross-replica member moves over the fleet's observed loads.

    ``members_by_replica``: the routing plane's observed ownership
    (watchman builds it from each replica's ``/models``). ``loads``:
    member -> routed rows over the decision window (fleet-rolled from
    each replica's ``/placement`` ``member_rows``). ``replica_health``:
    replica -> ``"ok" | "degraded" | "unhealthy" | "unreachable" |
    "burning"`` — only ``"ok"`` replicas are eligible move DESTINATIONS
    (any replica may be a source: evacuating a sick replica is exactly
    the point), absent entries default to ok.

    Deterministic greedy descent: while the hottest replica exceeds the
    coolest eligible replica, move the largest member whose relocation
    shrinks the gap (load <= gap, largest-first, name tiebreak). Skew is
    max/mean of per-replica rows — the same definition the shard tier
    uses, one level up. The plan is advisory: ``should_apply`` encodes
    the verdict, watchman decides."""
    if threshold is None:
        threshold = default_fleet_threshold()
    if max_moves is None:
        max_moves = default_max_moves()
    health = dict(replica_health or {})
    replicas = sorted(members_by_replica)
    owner: Dict[str, int] = {}
    for rid in replicas:
        for name in members_by_replica[rid]:
            # dual ownership mid-migration resolves to the lowest index
            # here; the planner only needs a consistent single owner
            owner.setdefault(name, rid)
    rows_now: Dict[int, float] = {
        rid: sum(float(loads.get(n, 0.0)) for n in members_by_replica[rid] if owner[n] == rid)
        for rid in replicas
    }
    eligible = [rid for rid in replicas if health.get(rid, "ok") == "ok"]
    observed_rows = int(sum(float(v) for v in loads.values()))
    before = dict(rows_now)
    skew_before = skew_ratio(list(before.values()))

    def verdict(
        moves: List[FleetMove], should: bool, reason: str
    ) -> FleetPlan:
        after = dict(rows_now)
        skew_after = skew_ratio(list(after.values()))
        improvement = (
            skew_before / skew_after
            if skew_before is not None and skew_after not in (None, 0.0)
            else None
        )
        return FleetPlan(
            moves=moves,
            replica_rows_before=before,
            replica_rows_after=after,
            skew_before=skew_before,
            skew_after=skew_after,
            improvement=improvement,
            threshold=float(threshold),
            should_apply=should,
            reason=reason,
            observed_rows=observed_rows,
            eligible=eligible,
        )

    if len(replicas) < 2:
        return verdict([], False, "fewer than two replicas (nothing to move between)")
    if observed_rows < min_rows:
        return verdict(
            [],
            False,
            f"insufficient load signal ({observed_rows} routed rows "
            f"observed, need >= {min_rows})",
        )
    if not eligible:
        return verdict(
            [], False, "no healthy replica eligible as a move destination"
        )
    if skew_before is None:
        return verdict([], False, "no routed-row signal on any replica")

    moves: List[FleetMove] = []
    moved_members = set()
    while len(moves) < max_moves:
        src = max(replicas, key=lambda r: (rows_now[r], -r))
        dst_candidates = [r for r in eligible if r != src]
        if not dst_candidates:
            break
        dst = min(dst_candidates, key=lambda r: (rows_now[r], r))
        gap = rows_now[src] - rows_now[dst]
        if gap <= 0:
            break
        # largest member STRICTLY under the gap: moving load L turns the
        # src-dst gap into gap - 2L, and |gap - 2L| < gap iff 0 < L < gap
        # — so every accepted move strictly shrinks the pair's gap, and
        # because src is the fleet max, max/mean skew never increases
        # (L == gap would just swap which replica is hot: thrash)
        candidates = sorted(
            (
                n
                for n in members_by_replica[src]
                if owner[n] == src
                and n not in moved_members
                and 0 < float(loads.get(n, 0.0)) < gap
            ),
            key=lambda n: (-float(loads.get(n, 0.0)), n),
        )
        if not candidates:
            break
        name = candidates[0]
        rows = float(loads.get(name, 0.0))
        moves.append(FleetMove(member=name, src=src, dst=dst, rows=rows))
        moved_members.add(name)
        owner[name] = dst
        rows_now[src] -= rows
        rows_now[dst] += rows

    if not moves:
        return verdict([], False, "placement already balanced (no improving move)")
    # one derivation: verdict() computes skew_after/improvement from
    # rows_now, and the threshold decision reads the SAME values off the
    # plan — two parallel formulas here could silently disagree with
    # what summary() reports
    plan = verdict(moves, False, "")
    if plan.improvement is None or plan.improvement < threshold:
        plan.reason = (
            f"predicted improvement "
            f"{plan.improvement if plan.improvement is None else round(plan.improvement, 2)}x "
            f"below threshold {threshold:.2f}x"
        )
        return plan
    plan.should_apply = True
    plan.reason = (
        f"predicted replica skew {plan.skew_before:.2f} -> "
        f"{plan.skew_after:.2f} ({plan.improvement:.2f}x improvement, "
        f"{len(moves)} cross-replica move(s))"
    )
    return plan
