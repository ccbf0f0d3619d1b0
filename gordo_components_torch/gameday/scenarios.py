"""The game-day scenario catalog and its judge.

Counterpart of ``gordo_components_tpu/gameday/scenarios.py``, field for
field: the fleet compiler validates ``fleet.gameday.gate`` against this
catalog. The drills themselves (``gate.py``, ``harness.py``,
``replica.py``) are not ported yet.

Each :class:`GamedayScenario` is declarative: a name, the mesh shape it
needs, and the BOUNDS its verdict must satisfy. The drill itself (what
gets killed, partitioned or slowed, and what evidence is collected)
lives in ``gameday/harness.py``; the judge here turns evidence into a
verdict the same way the replay harness's ``Scenario.judge`` does —
every declared bound is popped and checked, leftovers fail loudly, and
the shared envelope (``replay/verdict.py``) stamps
``failures``/``passed``.

Bounds vocabulary (all optional):

- ``max_detection_latency_s`` — the observability stack must have seen
  the injected failure (``detected``) within this many seconds of
  injection;
- ``max_non200`` — containment: data-plane non-200s vs the scenario's
  declared budget (default 0);
- ``max_recovery_s`` — ``recovered`` must be True within this many
  seconds of the heal action;
- ``require_event_order`` — these event types must ALL appear in the
  fleet timeline, first occurrences in this causal order;
- ``min_routing_version_steps`` — the routing table must have stepped
  at least this many versions (clients poll off dead owners);
- ``min_hedge_wins`` — the hedging client must have raced the sick
  replica and won at least this often;
- ``min_reroutes`` — stale-table detection must actually have fired;
- ``max_routing_refreshes`` — the refresh-stampede guard: total
  routing-table installs stays bounded during the storm;
- ``min_drift_replicas`` — correlated drift must flag on at least this
  many replicas;
- ``max_drift_recovery_s`` — alias of ``max_recovery_s`` semantics for
  readability in the drift scenario (same check);
- ``min_distinct_reconnect_delays`` — the reconnect herd must have
  spread over at least this many DISTINCT jittered delays;
- ``require_all_subscribers_recovered`` — every push subscriber polled
  successfully again after the blip;
- ``min_burn_peak`` — the SLO burn must actually have peaked at or
  above this (the failure was visible, not theoretical);
- ``min_shed_precision`` — of everything admission shed during the
  drill, at least this fraction must have landed on the flooding class
  (vacuously 1.0 when nothing was shed — no sheds means nobody was
  mis-shed);
- ``min_class_burn_peak`` — the flooding class's own
  ``gordo_slo_burn_rate{class}`` must have peaked at or above this on
  the fleet rollup (the shed was goodput-driven, not just queue luck);
- ``max_interactive_p99_ratio`` — interactive p99 under flood over
  unloaded interactive p99 stays at or under this (the fairness
  headline number).

Load-level bounds that only hold with real parallelism go in
``multicore_bounds`` — the judge merges them only when the host has >=2
CPUs (the single-core honesty rule); structural bounds stay in
``bounds`` and are asserted everywhere.
"""

from dataclasses import dataclass, field
from typing import Any, Dict, List

from gordo_components_torch.replay.verdict import (
    check_detection,
    check_non200,
    finalize_verdict,
)

__all__ = [
    "SCENARIOS",
    "GATE_DEFAULT",
    "GamedayScenario",
    "known_scenarios",
]


@dataclass(frozen=True)
class GamedayScenario:
    name: str
    description: str
    mesh: str  # shape the drill needs: partitioned|replicated|push|streaming|qos
    bounds: Dict[str, Any] = field(default_factory=dict)
    multicore_bounds: Dict[str, Any] = field(default_factory=dict)
    # gate-capable scenarios have a bounded single-replica drill
    # (gameday/gate.py) the fleet compiler can run pre-promotion
    gate_capable: bool = False

    def judge(
        self, verdict: Dict[str, Any], single_core: bool = False
    ) -> List[str]:
        """Bounds -> failure strings (empty = drill passed)."""
        b = dict(self.bounds)
        if not single_core:
            b.update(self.multicore_bounds)
        fails: List[str] = []
        max_lat = b.pop("max_detection_latency_s", None)
        if max_lat is not None:
            check_detection(
                bool(verdict.get("detected")),
                verdict.get("detection_latency_s"),
                max_lat,
                f"scenario {self.name}: injected failure",
                fails,
            )
        check_non200(verdict, int(b.pop("max_non200", 0)), fails)
        max_rec = b.pop("max_recovery_s", b.pop("max_drift_recovery_s", None))
        if max_rec is not None:
            rec_s = verdict.get("recovery_s")
            if not verdict.get("recovered"):
                fails.append("recovery was never observed")
            elif rec_s is not None and rec_s > max_rec:
                fails.append(
                    f"recovery took {rec_s:.1f}s > {max_rec:.1f}s"
                )
        order = b.pop("require_event_order", None)
        if order:
            seq = [
                str(e.get("type"))
                for e in verdict.get("events", [])
                if isinstance(e, dict)
            ]
            last = -1
            for etype in order:
                if etype not in seq:
                    fails.append(
                        f"event {etype!r} missing from the fleet timeline"
                    )
                    continue
                i = seq.index(etype)
                if i < last:
                    fails.append(
                        f"event {etype!r} out of causal order "
                        f"(timeline: {seq})"
                    )
                last = max(last, i)
        min_vs = b.pop("min_routing_version_steps", None)
        if min_vs is not None and verdict.get(
            "routing_version_steps", 0
        ) < min_vs:
            fails.append(
                f"routing version stepped "
                f"{verdict.get('routing_version_steps', 0)} time(s) "
                f"< {min_vs}"
            )
        min_hw = b.pop("min_hedge_wins", None)
        if min_hw is not None and verdict.get("hedge_wins", 0) < min_hw:
            fails.append(
                f"hedge wins {verdict.get('hedge_wins', 0)} < {min_hw} "
                "(hedging never routed around the sick replica)"
            )
        min_rr = b.pop("min_reroutes", None)
        if min_rr is not None and verdict.get("reroutes", 0) < min_rr:
            fails.append(
                f"reroutes {verdict.get('reroutes', 0)} < {min_rr} "
                "(stale-table detection never fired)"
            )
        max_rf = b.pop("max_routing_refreshes", None)
        if max_rf is not None and verdict.get(
            "routing_refreshes", 0
        ) > max_rf:
            fails.append(
                f"{verdict.get('routing_refreshes')} routing refreshes "
                f"> budget {max_rf} (refresh stampede)"
            )
        min_dr = b.pop("min_drift_replicas", None)
        if min_dr is not None and len(
            verdict.get("drifted_replicas", [])
        ) < min_dr:
            fails.append(
                f"drift flagged on {verdict.get('drifted_replicas')} "
                f"(< {min_dr} replicas) — correlation missed"
            )
        min_dd = b.pop("min_distinct_reconnect_delays", None)
        if min_dd is not None and verdict.get(
            "distinct_reconnect_delays", 0
        ) < min_dd:
            fails.append(
                f"{verdict.get('distinct_reconnect_delays', 0)} distinct "
                f"reconnect delays < {min_dd} (the herd did not spread)"
            )
        if b.pop("require_all_subscribers_recovered", False):
            lost = verdict.get("subscribers_lost", [])
            if lost:
                fails.append(f"subscribers never recovered: {lost}")
        min_bp = b.pop("min_burn_peak", None)
        if min_bp is not None and (
            verdict.get("burn_peak") is None
            or verdict["burn_peak"] < min_bp
        ):
            fails.append(
                f"burn peak {verdict.get('burn_peak')} < {min_bp} "
                "(the failure never showed on the SLO surface)"
            )
        min_sp = b.pop("min_shed_precision", None)
        if min_sp is not None:
            # vacuous pass at 1.0: zero sheds means zero MIS-sheds —
            # the bound is about who got hit, not whether anyone did
            prec = verdict.get("shed_precision")
            if prec is None:
                prec = 1.0
            if prec < min_sp:
                fails.append(
                    f"shed precision {prec:.3f} < {min_sp} (sheds "
                    "landed on the wrong class — fairness failed)"
                )
        min_cbp = b.pop("min_class_burn_peak", None)
        if min_cbp is not None and (
            verdict.get("class_burn_peak") is None
            or verdict["class_burn_peak"] < min_cbp
        ):
            fails.append(
                f"flooding-class burn peak "
                f"{verdict.get('class_burn_peak')} < {min_cbp} "
                "(the flood never burned its own class budget — "
                "shed was not goodput-attributed)"
            )
        max_ipr = b.pop("max_interactive_p99_ratio", None)
        if max_ipr is not None:
            ratio = verdict.get("interactive_p99_ratio")
            if ratio is None:
                fails.append(
                    "interactive p99 ratio was never measured "
                    "(baseline or flood phase produced no latencies)"
                )
            elif ratio > max_ipr:
                fails.append(
                    f"interactive p99 under flood = {ratio:.2f}x "
                    f"unloaded > {max_ipr}x (the flood starved "
                    "interactive latency)"
                )
        if b:
            fails.append(f"unknown bounds: {sorted(b)}")
        return fails

    def finalize(
        self, verdict: Dict[str, Any], single_core: bool = False
    ) -> Dict[str, Any]:
        verdict.setdefault("scenario", self.name)
        verdict.setdefault("description", self.description)
        verdict["single_core"] = bool(single_core)
        return finalize_verdict(verdict, self.judge(verdict, single_core))


# --------------------------------------------------------------------- #
# the catalog (docs/operations.md "Game days" is the operator's view)
# --------------------------------------------------------------------- #

SCENARIOS: Dict[str, GamedayScenario] = {
    s.name: s
    for s in [
        GamedayScenario(
            name="replica_crash_restart",
            description=(
                "SIGKILL one partitioned replica under scoring load; "
                "watchman must mark it unreachable (version step + "
                "mesh.replica_unreachable), surviving members must keep "
                "answering 200, and the respawned replica must rejoin "
                "the table."
            ),
            mesh="partitioned",
            bounds={
                "max_detection_latency_s": 20.0,
                # healthy members' responses — the blast radius must
                # stop at the dead replica's partition
                "max_non200": 0,
                "max_recovery_s": 150.0,
                "require_event_order": [
                    "mesh.replica_unreachable",
                    "mesh.replica_recovered",
                ],
                "min_routing_version_steps": 2,
            },
            gate_capable=True,
        ),
        GamedayScenario(
            name="watchman_partition",
            description=(
                "Transport-partition watchman from every replica "
                "(watchman.probe=refuse): the table must mark the fleet "
                "unreachable and step its version, while the DATA plane "
                "keeps serving 200s from the last-good table; healing "
                "the partition must converge the table back."
            ),
            mesh="partitioned",
            bounds={
                "max_detection_latency_s": 15.0,
                "max_non200": 0,
                "max_recovery_s": 30.0,
                "require_event_order": [
                    "mesh.replica_unreachable",
                    "mesh.replica_recovered",
                ],
                "min_routing_version_steps": 2,
            },
        ),
        GamedayScenario(
            name="migration_storm",
            description=(
                "Back-to-back migrations of one member while a routed "
                "client scores the fleet: stale-table 404s must resolve "
                "via ONE bounded refetch+re-post each (reroutes), "
                "refreshes must stay bounded (no stampede against "
                "watchman), and every prediction must end 200."
            ),
            mesh="partitioned",
            bounds={
                "max_non200": 0,
                "min_reroutes": 1,
                "max_routing_refreshes": 12,
                "min_routing_version_steps": 2,
            },
        ),
        GamedayScenario(
            name="gray_failure_slow_replica",
            description=(
                "One replicated replica is alive but slow (injected "
                "engine latency via GORDO_FAULTS): health gating says "
                "ok, so HEDGING is the containment — the client must "
                "race the sick replica's p95 and win on the healthy "
                "one; the sick replica's latency SLO must burn on the "
                "watchman rollup; burn decays once the fault budget is "
                "exhausted."
            ),
            mesh="replicated",
            bounds={
                "max_detection_latency_s": 30.0,
                "max_non200": 0,
                "min_hedge_wins": 1,
                "min_burn_peak": 1.0,
                "max_recovery_s": 90.0,
            },
            multicore_bounds={
                "min_hedge_wins": 3,
            },
            gate_capable=True,
        ),
        GamedayScenario(
            name="thundering_herd",
            description=(
                "A push replica with flaky transport (server."
                "connection=reset over GORDO_FAULTS) is killed and "
                "respawned under N long-poll subscribers: every "
                "subscriber must reconnect and poll again, with "
                "decorrelated-jitter delays spreading the herd; "
                "watchman must see the blip (version step + "
                "replica_unreachable/recovered)."
            ),
            mesh="push",
            bounds={
                "max_detection_latency_s": 20.0,
                "max_non200": 0,
                "require_all_subscribers_recovered": True,
                "min_distinct_reconnect_delays": 4,
                "require_event_order": [
                    "mesh.replica_unreachable",
                    "mesh.replica_recovered",
                ],
                "min_routing_version_steps": 2,
            },
        ),
        GamedayScenario(
            name="tenant_noisy_neighbor",
            description=(
                "A best_effort tenant floods the replicated fleet while "
                "a steady interactive client keeps scoring: weighted-"
                "fair batching + per-class admission must keep every "
                "interactive prediction 200 with bounded p99, land "
                ">=90% of the sheds on the flooding class, and show the "
                "flood burning its OWN class budget on the watchman "
                "per-class rollup — the noisy neighbor pays, the quiet "
                "one does not."
            ),
            # own mesh shape: the replicated shape arms a latency fault
            # for the gray-failure drill, which would pollute this
            # scenario's p99 baseline; qos boots clean with a tight
            # engine queue + per-class SLO windows instead
            mesh="qos",
            bounds={
                # interactive traffic only — the flood is EXPECTED to
                # eat 429s, so its non-200s are excluded by the runner
                "max_non200": 0,
                "min_shed_precision": 0.9,
            },
            multicore_bounds={
                # latency-fairness and burn-visibility bounds only hold
                # when the flood and the probe truly run concurrently
                "max_interactive_p99_ratio": 1.5,
                "min_class_burn_peak": 1.0,
            },
            gate_capable=True,
        ),
        GamedayScenario(
            name="correlated_drift",
            description=(
                "The same upstream shift hits members on EVERY replica "
                "at once (correlated drift): each replica's detector "
                "must flag (drift.flagged on >=2 replicas), the "
                "watchman drift rollup must union the attribution, "
                "scoring must stay 200 throughout, and recalibration "
                "must clear the flags fleet-wide."
            ),
            mesh="streaming",
            bounds={
                "max_detection_latency_s": 60.0,
                "max_non200": 0,
                "min_drift_replicas": 2,
                "max_recovery_s": 120.0,
                # flag first, then the fix lands (adapt resets the flag
                # itself, so the causal pair is flagged -> adapted)
                "require_event_order": ["drift.flagged", "adapt.recalibrate"],
            },
        ),
    ]
}

# the default pre-promotion gate set: the scenarios whose single-replica
# drills catch the failure modes a rollout can actually ship (a canary
# that 5xxs under swap, a canary that answers but is slow)
GATE_DEFAULT = ["replica_crash_restart", "gray_failure_slow_replica"]


def known_scenarios() -> List[str]:
    return sorted(SCENARIOS)
