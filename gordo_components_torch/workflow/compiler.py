"""Fleet compiler: one declarative fleet YAML -> typed deployment DAG.

Counterpart of ``gordo_components_tpu/workflow/compiler.py``: the same
spec, validation and DAG, byte for byte (a machine that leaves its model
to the default gets the port's ``DEFAULT_MODEL_CONFIG``, whose paths name
``gordo_components_torch``, and so other keys than the JAX package's).
The executor (``workflow/executor.py``) runs the DAG.

Reference parity, inverted: where the reference's workflow generator
renders one Argo builder pod per machine from the normalized config
(PAPER.md §0–1), this compiles the SAME normalized config — plus an
optional ``fleet:`` section declaring canary policy, SLO objectives,
refit schedules, and replica targets — into a :class:`FleetDAG` of

    build/<machine> -> bucket/<gang> -> place/fleet -> canary/fleet
                                     [-> gameday/fleet] -> promote/fleet

steps with content-digest keys (workflow/dag.py). The DAG is the
reviewed artifact: ~ten env knobs (canary window, burn threshold,
bucket sizing, ...) become one YAML block that compiles deterministically,
and the executor (workflow/executor.py) re-runs only the stale subgraph
when the spec changes — the content-digest incremental-recompile path a
100k-member config needs.

Spec schema (superset of the reference-era machine config; everything
under ``fleet:`` is optional with validated defaults)::

    machines: [...]            # exactly NormalizedConfig's schema
    globals:  {...}
    fleet:
      models_per_bucket: 1024  # gang width bound (workflow/scheduler.py)
      devices_per_bucket: 8    # TPU slice per build gang
      replicas: 1              # or a list of replica base URLs
      canary:                  # judge policy (workflow/canary.py)
        traffic_slice: 0.25
        window_s: 30
        poll_s: 1.0
        min_requests: 1
        fast_burn_threshold: 14.4
        max_goodput_drop: 0.05
        max_success_drop: 0.02
      slo:
        objectives: [{name: availability, target: 0.999}, ...]
      schedules:
        refit_every: 6h        # re-enter the DAG on this cadence
      gameday:
        gate: [replica_crash_restart, gray_failure_slow_replica]
        # pre-promotion game-day drills (gameday/gate.py) run between
        # canary and promote; a failed drill blocks promote. Names must
        # be gate-capable scenarios from the gameday catalog — validated
        # at compile time.

Unknown keys under ``fleet:`` raise at compile time — a typo'd rollout
policy must fail in review, not deploy a default silently (the same
fail-at-generation discipline generator.py applies to staging knobs).
"""

import json
from typing import Any, Dict, List, Optional, Union

from gordo_components_torch.observability.slo import parse_objectives, parse_windows
from gordo_components_torch.workflow.canary import CanaryConfig
from gordo_components_torch.workflow.config import NormalizedConfig
from gordo_components_torch.workflow.dag import FleetDAG, Step, content_key
from gordo_components_torch.workflow.scheduler import schedule_gangs

_FLEET_KEYS = {
    "models_per_bucket",
    "devices_per_bucket",
    "replicas",
    "canary",
    "slo",
    "schedules",
    "gameday",
}
_SCHEDULE_KEYS = {"refit_every"}
_GAMEDAY_KEYS = {"gate"}


class FleetSpec:
    """Parsed + validated fleet spec: the normalized machine config and
    the ``fleet:`` rollout policy, every field defaulted and checked."""

    def __init__(self, config: Union[str, Dict[str, Any], NormalizedConfig]):
        self.config = (
            config
            if isinstance(config, NormalizedConfig)
            else NormalizedConfig(config)
        )
        raw = self.config.raw.get("fleet") or {}
        if not isinstance(raw, dict):
            raise ValueError("'fleet' section must be a mapping")
        unknown = set(raw) - _FLEET_KEYS
        if unknown:
            raise ValueError(
                f"unknown fleet spec key(s) {sorted(unknown)} "
                f"(expected a subset of {sorted(_FLEET_KEYS)})"
            )
        runtime = self.config.runtime or {}
        self.models_per_bucket = int(
            raw.get("models_per_bucket", runtime.get("models_per_gang", 1024))
        )
        self.devices_per_bucket = int(
            raw.get("devices_per_bucket", runtime.get("devices_per_gang", 8))
        )
        if self.models_per_bucket < 1 or self.devices_per_bucket < 1:
            raise ValueError(
                "models_per_bucket and devices_per_bucket must be >= 1"
            )

        replicas = raw.get("replicas", 1)
        if isinstance(replicas, int):
            if replicas < 1:
                raise ValueError("fleet.replicas must be >= 1")
            self.replica_urls: Optional[List[str]] = None
            self.n_replicas = replicas
        elif isinstance(replicas, list) and all(
            isinstance(r, str) for r in replicas
        ) and replicas:
            self.replica_urls = list(replicas)
            self.n_replicas = len(replicas)
        else:
            raise ValueError(
                "fleet.replicas must be a positive int or a list of base URLs"
            )

        # env-free resolution: the compiled DAG (keys, meta, golden JSON)
        # must be a pure function of the spec. The raw block (only the
        # keys the spec actually set) rides into meta so the EXECUTOR can
        # re-resolve with GORDO_FLEET_* env filling the unset fields
        self.canary_spec: Dict[str, Any] = dict(raw.get("canary") or {})
        self.canary = CanaryConfig.from_spec(self.canary_spec, use_env=False)

        slo = raw.get("slo") or {}
        if not isinstance(slo, dict) or set(slo) - {"objectives", "windows"}:
            raise ValueError(
                "fleet.slo must be a mapping with 'objectives' and/or 'windows'"
            )
        # reuse the SLO layer's own validators: a fleet spec must not be
        # able to declare an objective the burn engine can't compute
        self.slo_objectives = [
            o.describe()
            for o in parse_objectives(json.dumps(slo["objectives"]))
        ] if "objectives" in slo else None
        self.slo_windows = None
        if "windows" in slo:
            windows = slo["windows"]
            if not (
                isinstance(windows, list)
                and windows
                and all(isinstance(w, str) for w in windows)
            ):
                raise ValueError(
                    "fleet.slo.windows must be a non-empty list of "
                    f"duration strings (e.g. ['5m', '1h']), got {windows!r}"
                )
            self.slo_windows = [
                list(w) for w in parse_windows(",".join(windows))
            ]

        schedules = raw.get("schedules") or {}
        if not isinstance(schedules, dict) or set(schedules) - _SCHEDULE_KEYS:
            raise ValueError(
                f"fleet.schedules keys must be a subset of {sorted(_SCHEDULE_KEYS)}"
            )
        self.refit_every_s: Optional[float] = None
        if "refit_every" in schedules:
            # parse_windows validates the 30s/5m/6h duration grammar
            ((_, seconds),) = parse_windows(str(schedules["refit_every"]))
            self.refit_every_s = seconds

        # pre-promotion game-day gate (gameday/gate.py): the declared
        # scenarios become a 'gameday' step between canary and promote.
        # Validated against the scenario catalog at COMPILE time — a
        # typo'd or non-gate-capable scenario must fail in review, not
        # skip a declared drill at rollout time
        gameday = raw.get("gameday") or {}
        if not isinstance(gameday, dict) or set(gameday) - _GAMEDAY_KEYS:
            raise ValueError(
                f"fleet.gameday keys must be a subset of {sorted(_GAMEDAY_KEYS)}"
            )
        self.gameday_gate: Optional[List[str]] = None
        if "gate" in gameday:
            gate = gameday["gate"]
            if not (
                isinstance(gate, list)
                and gate
                and all(isinstance(s, str) for s in gate)
            ):
                raise ValueError(
                    "fleet.gameday.gate must be a non-empty list of "
                    f"scenario names, got {gate!r}"
                )
            from gordo_components_torch.gameday.scenarios import SCENARIOS

            unknown_sc = sorted(set(gate) - set(SCENARIOS))
            if unknown_sc:
                raise ValueError(
                    f"unknown gameday scenario(s) {unknown_sc} "
                    f"(known: {sorted(SCENARIOS)})"
                )
            not_capable = sorted(
                s for s in gate if not SCENARIOS[s].gate_capable
            )
            if not_capable:
                raise ValueError(
                    f"gameday scenario(s) {not_capable} have no gate-mode "
                    "drill (gate-capable: "
                    f"{sorted(n for n, s in SCENARIOS.items() if s.gate_capable)})"
                )
            self.gameday_gate = list(gate)

    def describe(self) -> Dict[str, Any]:
        """The policy block embedded in the DAG meta (and therefore in
        the golden JSON): everything that ISN'T per-step payload."""
        out: Dict[str, Any] = {
            "models_per_bucket": self.models_per_bucket,
            "devices_per_bucket": self.devices_per_bucket,
            "n_replicas": self.n_replicas,
            "canary": self.canary.describe(),
            "canary_spec": self.canary_spec,
        }
        if self.config.runtime:
            # manifest-generator knobs (globals.runtime) survive into the
            # DAG so rendering from a saved fleet_dag.json matches
            # rendering the original spec
            out["runtime"] = dict(self.config.runtime)
        if self.replica_urls:
            out["replica_urls"] = list(self.replica_urls)
        if self.slo_objectives is not None:
            out["slo_objectives"] = self.slo_objectives
        if self.slo_windows is not None:
            out["slo_windows"] = self.slo_windows
        if self.refit_every_s is not None:
            out["refit_every_s"] = self.refit_every_s
        if self.gameday_gate is not None:
            out["gameday_gate"] = list(self.gameday_gate)
        return out


def compile_fleet(
    spec: Union[str, Dict[str, Any], NormalizedConfig, FleetSpec],
    project_name: str = "fleet",
    **overrides: Any,
) -> FleetDAG:
    """Compile a fleet spec into the typed deployment DAG.

    ``overrides`` (``models_per_bucket``/``devices_per_bucket``, plus the
    generator-era aliases ``models_per_gang``/``devices_per_gang``)
    override the spec the way CLI flags always overrode the manifest
    generator. The result is deterministic: same spec -> byte-identical
    ``dag.to_json()``.
    """
    if not isinstance(spec, FleetSpec):
        spec = FleetSpec(spec)
    models_per_bucket = int(
        overrides.get(
            "models_per_bucket",
            overrides.get("models_per_gang", spec.models_per_bucket),
        )
    )
    devices_per_bucket = int(
        overrides.get(
            "devices_per_bucket",
            overrides.get("devices_per_gang", spec.devices_per_bucket),
        )
    )
    unknown = set(overrides) - {
        "models_per_bucket", "devices_per_bucket",
        "models_per_gang", "devices_per_gang",
    }
    if unknown:
        raise ValueError(f"unknown compile override(s) {sorted(unknown)}")

    steps: List[Step] = []

    # ---- build steps: one per machine, keyed by the machine's full
    # normalized config (dataset window + model + metadata + evaluation)
    # — the same content identity the build register cache hashes, so
    # a scheduled refit that advances train_end_date is *automatically* a
    # key change that re-enters the DAG ----
    build_key_by_name: Dict[str, str] = {}
    for machine in spec.config.machines:
        payload = {"machine": machine.to_dict()}
        key = content_key(payload)
        build_key_by_name[machine.name] = key
        steps.append(
            Step(
                step_id=f"build/{machine.name}",
                kind="build",
                key=key,
                payload=payload,
            )
        )

    # ---- bucket steps: the gang scheduler's feature-count buckets,
    # chunked to the HBM/blast-radius bound; deps = member builds ----
    gangs = schedule_gangs(
        spec.config.machines,
        models_per_gang=models_per_bucket,
        devices_per_gang=devices_per_bucket,
    )
    bucket_ids: List[str] = []
    for gang in gangs:
        deps = tuple(f"build/{name}" for name in gang.machine_names())
        payload = {
            "gang_id": gang.gang_id,
            "n_features": gang.n_features,
            "devices": gang.devices,
            "members": gang.machine_names(),
        }
        step_id = f"bucket/{gang.gang_id}"
        bucket_ids.append(step_id)
        steps.append(
            Step(
                step_id=step_id,
                kind="bucket",
                key=content_key(
                    payload,
                    deps=(build_key_by_name[n] for n in gang.machine_names()),
                ),
                deps=deps,
                payload=payload,
            )
        )

    # ---- place -> canary -> promote: one chain per fleet. Their keys
    # chain the upstream content keys, so ANY machine edit re-executes
    # the rollout tail (it must: the generation the tail lands is a
    # different set of bytes), while untouched builds/buckets stay
    # cached. ----
    place_payload = {
        "n_replicas": spec.n_replicas,
        "replica_urls": spec.replica_urls,
        "buckets": sorted(bucket_ids),
    }
    # declared SLO policy is a rollout INPUT (the canary judges against
    # it via the servers it configures), so it must participate in the
    # tail's content keys: tightening an objective stales place/canary/
    # promote — a reviewed policy edit re-rolls, never silently no-ops
    if spec.slo_objectives is not None:
        place_payload["slo_objectives"] = spec.slo_objectives
    if spec.slo_windows is not None:
        place_payload["slo_windows"] = spec.slo_windows
    place_key = content_key(
        place_payload,
        deps=(s.key for s in steps if s.kind == "bucket"),
    )
    steps.append(
        Step(
            step_id="place/fleet",
            kind="place",
            key=place_key,
            deps=tuple(sorted(bucket_ids)),
            payload=place_payload,
        )
    )

    canary_payload = {"canary": spec.canary.describe()}
    canary_key = content_key(canary_payload, deps=(place_key,))
    steps.append(
        Step(
            step_id="canary/fleet",
            kind="canary",
            key=canary_key,
            deps=("place/fleet",),
            payload=canary_payload,
        )
    )
    # optional pre-promotion game-day gate: canary -> gameday -> promote.
    # Its key chains the canary's (a new generation re-drills) plus the
    # declared scenario list (editing the drill set re-drills); promote's
    # key chains the gate's, so a gate edit also re-promotes
    promote_deps: List[str] = ["canary/fleet"]
    promote_key_deps: List[str] = [canary_key]
    if spec.gameday_gate:
        gate_payload = {"scenarios": list(spec.gameday_gate)}
        gate_key = content_key(gate_payload, deps=(canary_key,))
        steps.append(
            Step(
                step_id="gameday/fleet",
                kind="gameday",
                key=gate_key,
                deps=("canary/fleet",),
                payload=gate_payload,
            )
        )
        promote_deps.append("gameday/fleet")
        promote_key_deps.append(gate_key)
    steps.append(
        Step(
            step_id="promote/fleet",
            kind="promote",
            key=content_key({}, deps=promote_key_deps),
            deps=tuple(promote_deps),
            payload={},
        )
    )

    return FleetDAG(
        steps,
        project=project_name,
        meta={"fleet": spec.describe(), "n_machines": len(spec.config.machines)},
    )
