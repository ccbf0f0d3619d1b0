"""Canary judge: promote / rollback / hold on measured goodput and SLO burn.

Counterpart of ``gordo_components_tpu/workflow/canary.py``: the same
policy, signals and verdicts. The ``workflow.canary`` fault point is
registered here, and the executor (``executor.py``) fires it on every
judge poll.

"ML Productivity Goodput" (PAPERS.md #5) argues the only honest health
signal for an ML serving change is the fraction of wall/device time that
produced useful answers — not an ad-hoc health check that 200s while the
fleet burns its error budget. This module applies that to generation
rollouts: the executor lands a new generation on the canary slice, then
judges it on

- the server's **SLO burn state** (observability/slo.py): any objective
  fast-burning on the fast window mid-canary is an immediate rollback —
  the multi-window page-now signal, reused as a rollback trigger;
- the **goodput delta vs the incumbent** (observability/goodput.py): the
  canary window's request-success and wall-goodput ratios, computed from
  the ledger's monotonic cells, compared against the incumbent's
  pre-swap cumulative ratios with a configured tolerance.

The zero-traffic case is deliberately a third verdict: a canary window
that served nothing proved nothing, so the judge HOLDS — it must neither
promote on absence of evidence nor roll back a generation nothing
condemned (tests/test_fleet_compiler.py pins this edge).

``workflow.canary`` is the chaos site: an injected fault mid-window must
drive the executor's rollback path — incumbent artifacts restored
through the same zero-downtime swap (placement/swap.py) that landed the
canary, registry collectors riding along — never a half-promoted fleet.
"""

import os
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

from gordo_components_torch.observability.slo import DEFAULT_FAST_BURN
from gordo_components_torch.resilience.faults import faultpoint

__all__ = [
    "CanaryConfig",
    "CanaryHistory",
    "CanarySignal",
    "CanaryVerdict",
    "judge_canary",
    "judge_canary_window",
    "signal_delta",
]

# chaos site (tests/test_fleet_compiler.py): fired on every judge poll
# while the canary generation is serving — the widest mid-canary window
_FP_CANARY = faultpoint("workflow.canary")

PROMOTE = "promote"
ROLLBACK = "rollback"
NO_SIGNAL = "no_signal"

_CANARY_KEYS = {
    "traffic_slice",
    "window_s",
    "poll_s",
    "min_requests",
    "min_samples",
    "burn_polls",
    "fast_burn_threshold",
    "max_goodput_drop",
    "max_success_drop",
}


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw in (None, ""):
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}") from None


@dataclass(frozen=True)
class CanaryConfig:
    """Judge policy. Spec block > ``GORDO_FLEET_*`` env > defaults —
    the env tier exists so operators can tighten a running fleet's
    rollback trigger without editing the reviewed spec."""

    traffic_slice: float = 0.25  # fraction of replicas the canary lands on
    window_s: float = 30.0       # observation window after the slice swap
    poll_s: float = 1.0          # fast-burn poll cadence inside the window
    min_requests: int = 1        # below this the window is no-signal
    # history-window judging (judge_canary_window): the verdict needs a
    # retained multi-sample window, not one lucky poll —
    min_samples: int = 3         # polls observed before promote is possible
    burn_polls: int = 2          # consecutive burning polls before rollback
    fast_burn_threshold: float = DEFAULT_FAST_BURN
    max_goodput_drop: float = 0.05   # wall-goodput ratio tolerance vs incumbent
    max_success_drop: float = 0.02   # request-success ratio tolerance

    @classmethod
    def from_spec(
        cls, spec: Optional[Mapping[str, Any]], use_env: bool = True
    ) -> "CanaryConfig":
        """``use_env=False`` resolves spec > class defaults only — the
        COMPILER path, so DAG content keys and the golden JSON are pure
        functions of the spec, never of whatever ``GORDO_FLEET_*`` the
        compiling shell happened to export. The executor resolves with
        ``use_env=True`` at run time: env fills fields the reviewed spec
        left unset (operator runtime tuning that deliberately does NOT
        stale any step)."""
        spec = dict(spec or {})
        unknown = set(spec) - _CANARY_KEYS
        if unknown:
            raise ValueError(
                f"unknown canary key(s) {sorted(unknown)} "
                f"(expected a subset of {sorted(_CANARY_KEYS)})"
            )

        def default(env_name: str, fallback: float) -> float:
            return _env_float(env_name, fallback) if use_env else fallback

        cfg = cls(
            traffic_slice=float(
                spec.get(
                    "traffic_slice",
                    default("GORDO_FLEET_CANARY_SLICE", cls.traffic_slice),
                )
            ),
            window_s=float(
                spec.get(
                    "window_s",
                    default("GORDO_FLEET_CANARY_WINDOW_S", cls.window_s),
                )
            ),
            poll_s=float(
                spec.get(
                    "poll_s", default("GORDO_FLEET_CANARY_POLL_S", cls.poll_s)
                )
            ),
            min_requests=int(
                spec.get(
                    "min_requests",
                    default("GORDO_FLEET_CANARY_MIN_REQUESTS", cls.min_requests),
                )
            ),
            min_samples=int(
                spec.get(
                    "min_samples",
                    default("GORDO_FLEET_CANARY_MIN_SAMPLES", cls.min_samples),
                )
            ),
            burn_polls=int(
                spec.get(
                    "burn_polls",
                    default("GORDO_FLEET_CANARY_BURN_POLLS", cls.burn_polls),
                )
            ),
            fast_burn_threshold=float(
                spec.get(
                    "fast_burn_threshold",
                    default("GORDO_FLEET_FAST_BURN", cls.fast_burn_threshold),
                )
            ),
            max_goodput_drop=float(
                spec.get(
                    "max_goodput_drop",
                    default("GORDO_FLEET_MAX_GOODPUT_DROP", cls.max_goodput_drop),
                )
            ),
            max_success_drop=float(
                spec.get(
                    "max_success_drop",
                    default("GORDO_FLEET_MAX_SUCCESS_DROP", cls.max_success_drop),
                )
            ),
        )
        if not 0.0 < cfg.traffic_slice <= 1.0:
            raise ValueError(
                f"canary traffic_slice must be in (0, 1], got {cfg.traffic_slice}"
            )
        if cfg.window_s < 0 or cfg.poll_s <= 0:
            raise ValueError("canary window_s must be >= 0 and poll_s > 0")
        if cfg.min_requests < 1:
            raise ValueError("canary min_requests must be >= 1")
        if cfg.min_samples < 1 or cfg.burn_polls < 1:
            raise ValueError("canary min_samples and burn_polls must be >= 1")
        if cfg.fast_burn_threshold <= 0:
            raise ValueError("canary fast_burn_threshold must be > 0")
        return cfg

    def describe(self) -> Dict[str, Any]:
        return {
            "traffic_slice": self.traffic_slice,
            "window_s": self.window_s,
            "poll_s": self.poll_s,
            "min_requests": self.min_requests,
            "min_samples": self.min_samples,
            "burn_polls": self.burn_polls,
            "fast_burn_threshold": self.fast_burn_threshold,
            "max_goodput_drop": self.max_goodput_drop,
            "max_success_drop": self.max_success_drop,
        }


@dataclass(frozen=True)
class CanarySignal:
    """One reading of a replica's cumulative goodput cells — counter
    semantics, so window deltas are plain subtraction (the same pattern
    the SLO tracker samples by)."""

    requests_total: float = 0.0
    requests_goodput: float = 0.0
    wall_goodput_s: float = 0.0
    wall_total_s: float = 0.0

    @classmethod
    def from_goodput_snapshot(
        cls, snap: Optional[Mapping[str, Any]]
    ) -> "CanarySignal":
        """Read the ledger's ``snapshot()`` body (the ``goodput`` embed in
        ``GET /slo`` and ``/stats``); a missing/disabled ledger reads as
        all-zero, which the judge classifies as no-signal rather than
        guessing."""
        if not snap:
            return cls()
        requests = snap.get("requests") or {}
        wall = snap.get("wall") or {}
        good = float(requests.get("goodput", 0) or 0)
        total = float(sum(v or 0 for v in requests.values()))
        wall_good = float(wall.get("goodput_s", 0.0) or 0.0)
        wall_total = wall_good + float(wall.get("wasted_s", 0.0) or 0.0)
        return cls(
            requests_total=total,
            requests_goodput=good,
            wall_goodput_s=wall_good,
            wall_total_s=wall_total,
        )

    def success_ratio(self) -> Optional[float]:
        if self.requests_total <= 0:
            return None
        return self.requests_goodput / self.requests_total

    def goodput_ratio(self) -> Optional[float]:
        if self.wall_total_s <= 0:
            return None
        return self.wall_goodput_s / self.wall_total_s


def signal_delta(before: CanarySignal, after: CanarySignal) -> CanarySignal:
    """Windowed signal between two cumulative readings. Clamped at zero:
    a mid-window generation swap restarts no counters (the ledger is
    app-scoped, deliberately), but defensive clamping keeps a foreign or
    restarted server from producing negative traffic."""
    return CanarySignal(
        requests_total=max(0.0, after.requests_total - before.requests_total),
        requests_goodput=max(0.0, after.requests_goodput - before.requests_goodput),
        wall_goodput_s=max(0.0, after.wall_goodput_s - before.wall_goodput_s),
        wall_total_s=max(0.0, after.wall_total_s - before.wall_total_s),
    )


@dataclass(frozen=True)
class CanaryVerdict:
    decision: str  # promote | rollback | no_signal
    reason: str
    metrics: Dict[str, Any]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "decision": self.decision,
            "reason": self.reason,
            "metrics": self.metrics,
        }


def slo_fast_burn(slo_body: Optional[Mapping[str, Any]]) -> Optional[str]:
    """The first fast-burning objective name in a ``GET /slo`` body, or
    None. Disabled SLO tracking reads as not-burning (the goodput-delta
    checks still apply)."""
    if not slo_body or not slo_body.get("enabled", True):
        return None
    for obj in slo_body.get("objectives") or ():
        if obj.get("fast_burn"):
            return str(obj.get("name"))
    return None


def judge_canary(
    incumbent: CanarySignal,
    canary_window: CanarySignal,
    config: CanaryConfig,
    burning_objective: Optional[str] = None,
) -> CanaryVerdict:
    """The verdict for one observed canary window.

    ``incumbent`` is the incumbent generation's cumulative signal at
    swap time (its lifetime ratios are the comparison baseline);
    ``canary_window`` is the delta accumulated while the canary served.
    Order of checks is deliberate: fast burn first (it is the page-now
    signal and needs no baseline), then the no-signal gate (ratio checks
    on zero traffic would divide nothing into nothing), then the
    relative goodput/success deltas.
    """
    canary_success = canary_window.success_ratio()
    canary_goodput = canary_window.goodput_ratio()
    metrics: Dict[str, Any] = {
        "canary_requests": canary_window.requests_total,
        "canary_success_ratio": canary_success,
        "canary_goodput_ratio": canary_goodput,
        "incumbent_success_ratio": incumbent.success_ratio(),
        "incumbent_goodput_ratio": incumbent.goodput_ratio(),
        "min_requests": config.min_requests,
    }
    if canary_window.requests_total < config.min_requests:
        # the no-signal gate comes FIRST, even over a fast burn: a burn
        # observed while the canary served nothing was inherited from
        # pre-window traffic and cannot be attributed to the canary —
        # rolling back on it would condemn a generation nothing tested
        return CanaryVerdict(
            NO_SIGNAL,
            f"canary window served {int(canary_window.requests_total)} "
            f"request(s), need >= {config.min_requests}: holding "
            "(neither promote nor rollback on no signal)",
            metrics,
        )
    if burning_objective is not None:
        return CanaryVerdict(
            ROLLBACK,
            f"SLO objective {burning_objective!r} fast-burning "
            f"(threshold {config.fast_burn_threshold})",
            dict(metrics, burning_objective=burning_objective),
        )
    incumbent_success = incumbent.success_ratio()
    if (
        incumbent_success is not None
        and canary_success is not None
        and canary_success < incumbent_success - config.max_success_drop
    ):
        return CanaryVerdict(
            ROLLBACK,
            f"request success ratio dropped {incumbent_success:.4f} -> "
            f"{canary_success:.4f} (> {config.max_success_drop} tolerance)",
            metrics,
        )
    incumbent_goodput = incumbent.goodput_ratio()
    if (
        incumbent_goodput is not None
        and canary_goodput is not None
        and canary_goodput < incumbent_goodput - config.max_goodput_drop
    ):
        return CanaryVerdict(
            ROLLBACK,
            f"wall goodput ratio dropped {incumbent_goodput:.4f} -> "
            f"{canary_goodput:.4f} (> {config.max_goodput_drop} tolerance)",
            metrics,
        )
    return CanaryVerdict(
        PROMOTE,
        f"canary healthy over {int(canary_window.requests_total)} request(s)",
        metrics,
    )


class CanaryHistory:
    """The retained multi-sample canary window: every judge poll's
    cumulative signal + burn observation, in order. This is the flight
    recorder applied to rollouts — :func:`judge_canary_window` reads the
    WHOLE window (aggregate delta, burn persistence, sample count)
    where the old single-poll path read only whatever the last ``/slo``
    body happened to say."""

    __slots__ = ("at_swap", "times", "signals", "burns")

    def __init__(self, at_swap: CanarySignal):
        self.at_swap = at_swap
        self.times: list = []
        self.signals: list = []
        self.burns: list = []  # Optional[str] per poll

    def add(
        self,
        t: float,
        signal: CanarySignal,
        burning_objective: Optional[str] = None,
    ) -> None:
        self.times.append(float(t))
        self.signals.append(signal)
        self.burns.append(burning_objective)

    @property
    def n_samples(self) -> int:
        return len(self.signals)

    def window_delta(self) -> CanarySignal:
        """Aggregate signal over the full observed window (cumulative
        last sample minus the at-swap baseline) — inherently every
        poll's traffic, not one poll's luck."""
        if not self.signals:
            return CanarySignal()
        return signal_delta(self.at_swap, self.signals[-1])

    def consecutive_burning(self) -> tuple:
        """``(count, objective)`` of the TRAILING run of burning polls —
        persistence, not a single hot sample."""
        count = 0
        objective: Optional[str] = None
        for burn in reversed(self.burns):
            if burn is None:
                break
            objective = burn
            count += 1
        return count, objective

    def describe(self) -> Dict[str, Any]:
        count, objective = self.consecutive_burning()
        delta = self.window_delta()
        return {
            "samples": self.n_samples,
            "window_requests": delta.requests_total,
            "burning_polls": count,
            "burning_objective": objective,
            "span_s": (
                round(self.times[-1] - self.times[0], 3) if self.times else 0.0
            ),
        }


def judge_canary_window(
    incumbent: CanarySignal,
    history: CanaryHistory,
    config: CanaryConfig,
) -> CanaryVerdict:
    """The verdict over a retained history window (the executor's judge
    since the flight-recorder PR; :func:`judge_canary` remains the
    single-window primitive it builds on).

    Check order mirrors ``judge_canary`` with two window-strength gates
    added: (1) traffic below ``min_requests`` is no-signal, as before;
    (2) an SLO burn must persist for ``burn_polls`` CONSECUTIVE polls to
    condemn the canary (one hot poll no longer rolls back); (3) fewer
    than ``min_samples`` observed polls is no-signal — one lucky poll no
    longer promotes; (4) the goodput/success deltas are computed over
    the aggregate window, every poll's traffic included."""
    window = history.window_delta()
    burn_count, burning = history.consecutive_burning()
    base = judge_canary(incumbent, window, config, burning_objective=None)
    metrics = dict(
        base.metrics,
        samples=history.n_samples,
        min_samples=config.min_samples,
        burning_polls=burn_count,
        burn_polls_required=config.burn_polls,
    )
    if window.requests_total < config.min_requests:
        return CanaryVerdict(NO_SIGNAL, base.reason, metrics)
    if burning is not None and burn_count >= config.burn_polls:
        return CanaryVerdict(
            ROLLBACK,
            f"SLO objective {burning!r} fast-burning for {burn_count} "
            f"consecutive poll(s) (threshold {config.fast_burn_threshold}, "
            f"required {config.burn_polls})",
            dict(metrics, burning_objective=burning),
        )
    if history.n_samples < config.min_samples:
        return CanaryVerdict(
            NO_SIGNAL,
            f"canary window produced {history.n_samples} sample(s), need "
            f">= {config.min_samples}: holding (a single poll must not "
            "promote)",
            metrics,
        )
    return CanaryVerdict(base.decision, base.reason, metrics)
