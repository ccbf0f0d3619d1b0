"""Composable incident library for the replay harness.

Counterpart of ``gordo_components_tpu/replay/incidents.py``: the same
incidents, the same composition and the same judge.

An :class:`Incident` is a window of event time during which one failure
mode (or several — the fields compose) applies to a subset of the
fleet's members:

- ``mean_shift`` / ``var_inflation`` — the calibration-drift family the
  adaptation plane exists for;
- ``dropout_p`` — sensor dropout (NaN cells; the ingest plane masks
  them, the drift window excludes them);
- ``late_fraction`` / ``duplicate_p`` — delivery pathologies (behind-
  watermark arrival, at-least-once re-sends);
- ``flatline_tags`` — a sensor stuck at the value it had when the
  incident began (distinct from dropout: the value LOOKS alive);
- ``season_amp``/``season_period_s`` — a slow seasonal cycle riding the
  mean, the classic false-positive bait a drift detector must ignore;
- ``faults`` — ``faultpoint()`` specs co-fired when the incident
  activates (scrape loss, refit failure mid-incident), so the backtest
  exercises the rollback paths, not just the happy loop.

Incidents overlay: several may be active at once (a correlated fleet
incident is one incident with ``members=None`` — every member). Active
incidents fold into ONE :class:`SimulatedLiveProvider` injection per
(member, batch window) via :func:`combine_injection` — shifts add,
inflations multiply, probabilities take their max.

A :class:`Scenario` is a named timeline of incidents plus the verdict
bounds the regression suite asserts (``Scenario.judge``) — every new
incident class becomes a ``make replay`` regression test for the whole
streaming + placement + SLO stack.
"""

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["Incident", "Scenario", "combine_injection"]


@dataclass
class Incident:
    """One failure-mode window on the replayed timeline. ``start_s`` /
    ``duration_s`` are offsets in EVENT seconds from the scenario's
    start; ``duration_s=None`` runs to the scenario's end. ``members``
    restricts the incident (None = the whole fleet — a correlated
    incident); ``tags`` restricts mean/variance effects to named
    sensors within those members."""

    kind: str
    start_s: float
    duration_s: Optional[float] = None
    members: Optional[Tuple[str, ...]] = None
    mean_shift: float = 0.0
    var_inflation: float = 1.0
    dropout_p: float = 0.0
    late_fraction: float = 0.0
    duplicate_p: float = 0.0
    flatline_tags: Tuple[str, ...] = ()
    season_amp: float = 0.0
    season_period_s: float = 0.0
    tags: Optional[Tuple[str, ...]] = None
    # faultpoint co-fire: ({"site": "stream.refit", "times": 1, ...}, …)
    # armed when the incident activates (resilience/faults.py kwargs)
    faults: Tuple[Dict[str, Any], ...] = ()
    # whether the drift detector is EXPECTED to flag this incident
    # (delivery pathologies and seasonal cycles expect the opposite)
    expect_detect: bool = True

    def end_s(self, scenario_duration_s: float) -> float:
        if self.duration_s is None:
            return scenario_duration_s
        return self.start_s + self.duration_s

    def active(self, t_s: float, scenario_duration_s: float) -> bool:
        return self.start_s <= t_s < self.end_s(scenario_duration_s)

    def applies_to(self, member: str) -> bool:
        return self.members is None or member in self.members

    def key(self, index: int) -> str:
        return f"{index}:{self.kind}"


def combine_injection(
    incidents: Sequence[Incident], t_mid_s: float
) -> Dict[str, Any]:
    """Fold the incidents active for one member over one batch window
    into :meth:`SimulatedLiveProvider.inject` kwargs. Seasonal cycles
    contribute their instantaneous (mid-window) mean offset — a batch
    window is short against any credible season, so piecewise-constant
    is an honest discretization."""
    mean = 0.0
    var = 1.0
    dropout = 0.0
    late = 0.0
    dup = 0.0
    tags: Optional[set] = None
    untagged_value_effect = False
    for inc in incidents:
        shift = inc.mean_shift
        if inc.season_amp and inc.season_period_s:
            shift += inc.season_amp * math.sin(
                2.0 * math.pi * (t_mid_s - inc.start_s) / inc.season_period_s
            )
        mean += shift
        var *= inc.var_inflation
        dropout = max(dropout, inc.dropout_p)
        late = max(late, inc.late_fraction)
        dup = max(dup, inc.duplicate_p)
        has_value_effect = bool(
            shift or inc.var_inflation != 1.0 or inc.season_amp
        )
        if inc.tags is not None:
            tags = set(inc.tags) if tags is None else (tags | set(inc.tags))
        elif has_value_effect:
            # a FLEET-WIDE value effect (no tag scope) is in the mix:
            # the composed injection must widen to all tags, or the
            # untagged shift would silently collapse onto the other
            # incident's tag subset. Untagged dropout/late/duplicate
            # incidents don't count — those knobs ignore tag scope.
            untagged_value_effect = True
    return {
        "mean_shift": mean,
        "var_inflation": var,
        "dropout_p": dropout,
        "late_fraction": late,
        "duplicate_p": dup,
        # purely tag-scoped compositions keep their union; any untagged
        # value effect widens to every tag (the composition's support)
        "tags": (
            sorted(tags)
            if (tags is not None and not untagged_value_effect)
            else None
        ),
    }


@dataclass
class Scenario:
    """A named incident timeline + the bounds its regression test
    asserts. ``bounds`` keys (all optional):

    - ``max_detection_latency_s`` — every expect_detect incident must
      flag within this many EVENT seconds of its start;
    - ``forbid_detection`` — no member may EVER flag (seasonal /
      delivery-pathology scenarios: a detector that cries wolf here
      burns refit budget on phantoms);
    - ``fp_after_max`` — post-adaptation false-positive rate ceiling;
    - ``fp_drop_factor_min`` — fp_before / fp_after floor (>=2 is the
      parity bar);
    - ``fn_after_max`` — post-adaptation false-negative ceiling on the
      gross-fault probe (recalibration must not widen thresholds past
      real faults);
    - ``min_duplicates`` — the dedup counter must have absorbed at
      least this many re-sends;
    - ``max_non200`` — scoring/ingest responses that may be non-200
      (default 0: replay-driven swaps must never 5xx the data plane);
    - ``min_speedup`` — event-seconds / wall-seconds floor (default
      100: the time-compression contract);
    - ``expect_rolled_back`` — at least one adaptation must have failed
      AND rolled back (fault co-fire scenarios);
    - ``require_adapted`` — at least one adaptation must have applied.
    """

    name: str
    duration_s: float
    incidents: Tuple[Incident, ...]
    description: str = ""
    adapt: bool = True  # adapt on detection (recalibrate; refit below)
    refit_targets: Tuple[str, ...] = ()  # additionally refit these
    bounds: Dict[str, Any] = field(default_factory=dict)

    def judge(self, verdict: Dict[str, Any]) -> List[str]:
        """Bounds -> list of failure strings (empty = scenario passed)."""
        b = dict(self.bounds)
        fails: List[str] = []
        max_lat = b.pop("max_detection_latency_s", None)
        for key, inc in verdict.get("incidents", {}).items():
            if not inc.get("expect_detect"):
                continue
            if not inc.get("detected"):
                fails.append(f"incident {key} was never detected")
            elif max_lat is not None and inc["detection_latency_s"] > max_lat:
                fails.append(
                    f"incident {key} detection took "
                    f"{inc['detection_latency_s']:.0f}s > {max_lat:.0f}s"
                )
        if b.pop("forbid_detection", False) and verdict.get("ever_drifted"):
            fails.append(
                f"drift flagged {verdict['ever_drifted']} in a scenario "
                "that must not alarm"
            )
        fp_after_max = b.pop("fp_after_max", None)
        if fp_after_max is not None:
            worst = max(verdict.get("fp_rate_after", {"": 0.0}).values())
            if worst > fp_after_max:
                fails.append(f"fp_rate_after {worst:.3f} > {fp_after_max}")
        drop_min = b.pop("fp_drop_factor_min", None)
        if drop_min is not None:
            before = verdict.get("fp_rate_before", {})
            after = verdict.get("fp_rate_after", {})
            for m, fb in before.items():
                fa = after.get(m, 0.0)
                # a zero post-adaptation rate is an infinite drop
                if fa > 0 and fb / fa < drop_min:
                    fails.append(
                        f"{m}: fp drop {fb:.3f}->{fa:.3f} "
                        f"< {drop_min}x"
                    )
        fn_after_max = b.pop("fn_after_max", None)
        if fn_after_max is not None:
            worst = max(verdict.get("fn_rate_after", {"": 0.0}).values())
            if worst > fn_after_max:
                fails.append(f"fn_rate_after {worst:.3f} > {fn_after_max}")
        min_dup = b.pop("min_duplicates", None)
        if min_dup is not None and verdict.get("duplicate_rows_total", 0) < min_dup:
            fails.append(
                f"duplicates {verdict.get('duplicate_rows_total', 0)} "
                f"< {min_dup}"
            )
        max_non200 = b.pop("max_non200", 0)
        if verdict.get("non_200", 0) > max_non200:
            fails.append(
                f"{verdict['non_200']} non-200 data-plane responses "
                f"(statuses: {verdict.get('statuses')})"
            )
        min_speedup = b.pop("min_speedup", 100.0)
        if verdict.get("speedup", 0.0) < min_speedup:
            fails.append(
                f"speedup {verdict.get('speedup'):.0f}x < {min_speedup}x"
            )
        if b.pop("expect_rolled_back", False) and not verdict.get("rolled_back"):
            fails.append("no adaptation rolled back (fault never bit)")
        if b.pop("require_adapted", False) and not verdict.get("adaptations"):
            fails.append("no adaptation was applied")
        if b:
            fails.append(f"unknown bounds: {sorted(b)}")
        return fails
