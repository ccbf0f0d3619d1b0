"""Pre-promotion game-day gates: bounded single-replica drills the
fleet compiler runs between canary and promote.

The full harness (``gameday/harness.py``) breaks a whole multi-process
mesh — minutes of wall time, its own fleet. A promotion decision needs
a cheaper question answered about THE canary replica that just served
its window: *would the failure modes this rollout can actually ship
survive a drill right now?* Each ``gate_capable`` scenario in the
catalog has a gate-mode drill here, run through public surfaces only:

- ``replica_crash_restart`` gate-mode: POST ``/reload`` (the same
  zero-downtime swap a crash recovery or promotion lands through)
  while probe traffic is in flight — the zero-non-200 swap invariant,
  judged from both the probes and the server's own error counter;
- ``gray_failure_slow_replica`` gate-mode: a probe window over the
  live replica, judged by its OWN ``/slo`` fast-burn state — a canary
  that answers but burns its latency budget is not a promotable
  canary;
- ``tenant_noisy_neighbor`` gate-mode: a best_effort-tagged scoring
  flood against the canary while interactive probes run, judged from
  ``GET /qos`` counter deltas — the flood must classify, sheds must
  land on it, and the probes must stay all-200.

Verdicts use the shared envelope (``replay/verdict.py``), so the fleet
report and the full harness read the same way. The
executor maps a failed gate to a failed step, which blocks promote via
the ordinary dependency propagation (``workflow/executor.py``).

Sync on purpose: the executor is a sync control-plane process, and the
gate runs inside its step loop.

Counterpart of ``gordo_components_tpu/gameday/gate.py``: the same drills,
verdicts and document. Its HTTP goes over urllib (the JAX gate's over
``requests``), a request a connection, with the same timeouts; an answer
other than 2xx is counted by its status, a transport failure as 599.
"""

import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional

from gordo_components_torch.gameday.scenarios import GATE_DEFAULT, SCENARIOS
from gordo_components_torch.replay.verdict import finalize_verdict

logger = logging.getLogger(__name__)

__all__ = ["GATE_SCHEMA", "run_promotion_gate"]

GATE_SCHEMA = "gordo.gameday-gate/v1"

# latency-class objectives burn on slow hardware regardless of rollout
# quality — their fast burn only fails the gate on multi-core hosts
# (the single-core honesty rule); availability/goodput burns are
# structural and fail everywhere
_LATENCY_OBJECTIVE_PREFIX = "p"


def _status(url: str, timeout: float, data: Optional[bytes] = None,
            headers: Optional[Dict[str, str]] = None) -> str:
    """The status of one request as a string (GET, or POST of ``data``),
    its body read whole; "599" for a transport failure."""
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            resp.read()
            return str(resp.status)
    except urllib.error.HTTPError as exc:
        exc.read()
        return str(exc.code)
    except Exception:
        return "599"  # transport failure pseudo-status


def json_request(url: str, method: str, timeout: float) -> Dict[str, Any]:
    """One request's JSON answer; an answer other than 2xx raises
    ``urllib.error.HTTPError``, as ``raise_for_status`` raises."""
    req = urllib.request.Request(url, data=b"" if method == "POST" else None, method=method)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


class _Probe:
    """Background probe traffic during a drill: cheap control-plane
    GETs (``/healthz``, ``/models``) plus the caller's ``traffic``
    callable (real scoring load, e.g. the executor's traffic hook),
    with client-side status/latency accounting."""

    def __init__(
        self,
        base_url: str,
        project: str,
        traffic: Optional[Callable[[str], Any]] = None,
        interval_s: float = 0.05,
        http_timeout: float = 10.0,
    ):
        self.base_url = base_url.rstrip("/")
        self.project = project
        self.traffic = traffic
        self.interval_s = interval_s
        self.http_timeout = http_timeout
        self.statuses: Dict[str, int] = {}
        self.latencies_s: List[float] = []
        self.traffic_errors = 0
        self.requests = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def non_200(self) -> int:
        return sum(
            n for code, n in self.statuses.items() if code != "200"
        )

    def _run(self) -> None:
        urls = [
            f"{self.base_url}/gordo/v0/{self.project}/healthz",
            f"{self.base_url}/gordo/v0/{self.project}/models",
        ]
        i = 0
        while not self._stop.is_set():
            url = urls[i % len(urls)]
            i += 1
            t0 = time.monotonic()
            status = _status(url, self.http_timeout)
            self.requests += 1
            self.latencies_s.append(time.monotonic() - t0)
            self.statuses[status] = self.statuses.get(status, 0) + 1
            if self.traffic is not None:
                try:
                    self.traffic(self.base_url)
                except Exception:
                    # scoring failures during a drill are the server's
                    # to count (its error counter delta is judged); a
                    # hook crash here must not kill the probe thread
                    self.traffic_errors += 1
            self._stop.wait(self.interval_s)

    def __enter__(self) -> "_Probe":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc_info) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def p95_ms(self) -> Optional[float]:
        if not self.latencies_s:
            return None
        ordered = sorted(self.latencies_s)
        idx = min(len(ordered) - 1, int(0.95 * len(ordered)))
        return round(ordered[idx] * 1000.0, 2)


class _GateContext:
    def __init__(
        self,
        base_url: str,
        project: str,
        traffic: Optional[Callable[[str], Any]],
        http_timeout: float,
        settle_s: float,
    ):
        self.base_url = base_url.rstrip("/")
        self.project = project
        self.traffic = traffic
        self.http_timeout = http_timeout
        self.settle_s = settle_s

    def _url(self, endpoint: str) -> str:
        return f"{self.base_url}/gordo/v0/{self.project}/{endpoint}"

    def get_json(self, endpoint: str) -> Dict[str, Any]:
        return json_request(self._url(endpoint), "GET", self.http_timeout)

    def post_json(self, endpoint: str) -> Dict[str, Any]:
        return json_request(self._url(endpoint), "POST", self.http_timeout)


def _gate_reload_under_load(ctx: _GateContext):
    """The crash/restart scenario's shippable failure mode: a
    generation swap that drops requests. Drill: probe + score while
    POST /reload lands the zero-downtime swap; every response must
    stay 200 and the server's own error counter must not move."""
    errors_before = int(ctx.get_json("stats").get("errors", 0))
    reload_error: Optional[str] = None
    swap: Any = None
    with _Probe(
        ctx.base_url, ctx.project, ctx.traffic,
        http_timeout=ctx.http_timeout,
    ) as probe:
        time.sleep(ctx.settle_s)  # pre-swap baseline probes
        try:
            body = ctx.post_json("reload")
            swap = body.get("swap", body)
        except Exception as exc:
            reload_error = f"{type(exc).__name__}: {exc}"
        time.sleep(ctx.settle_s)  # post-swap probes on the new bank
    errors_after = int(ctx.get_json("stats").get("errors", 0))
    server_error_delta = max(0, errors_after - errors_before)
    verdict: Dict[str, Any] = {
        "gate_mode": "reload_under_load",
        "injected": "POST /reload (zero-downtime swap) under probe load",
        "non_200": probe.non_200 + server_error_delta,
        "probe_requests": probe.requests,
        "probe_statuses": probe.statuses,
        "probe_p95_ms": probe.p95_ms(),
        "server_error_delta": server_error_delta,
        "swap": swap,
        "detected": reload_error is None,
    }
    fails: List[str] = []
    if reload_error is not None:
        fails.append(f"reload failed: {reload_error}")
    if verdict["non_200"]:
        fails.append(
            f"{verdict['non_200']} non-200(s) during the swap window "
            "(budget 0): the zero-downtime invariant broke "
            f"(probe statuses: {probe.statuses}, "
            f"server error delta: {server_error_delta})"
        )
    return verdict, fails


def _gate_latency_burn_probe(ctx: _GateContext):
    """The gray-failure scenario's shippable failure mode: a canary
    that answers 200 but is sick-slow. Drill: a probe window, then
    judge the replica by its OWN SLO surface — a fast-burning
    availability/goodput objective fails everywhere; a fast-burning
    latency objective fails on multi-core hosts (single-core machines
    are allowed to be slow, not allowed to be broken)."""
    from gordo_components_torch.workflow.canary import slo_fast_burn

    with _Probe(
        ctx.base_url, ctx.project, ctx.traffic,
        http_timeout=ctx.http_timeout,
    ) as probe:
        time.sleep(max(ctx.settle_s * 2, 1.0))
    slo = ctx.get_json("slo?refresh=1")
    burning = slo_fast_burn(slo)
    single_core = (os.cpu_count() or 1) < 2
    verdict: Dict[str, Any] = {
        "gate_mode": "latency_burn_probe",
        "injected": "probe window over the live canary replica",
        "non_200": probe.non_200,
        "probe_requests": probe.requests,
        "probe_statuses": probe.statuses,
        "probe_p95_ms": probe.p95_ms(),
        "slo_enabled": bool(slo.get("enabled", True)),
        "fast_burning_objective": burning,
        "detected": True,
    }
    fails: List[str] = []
    if verdict["non_200"]:
        fails.append(
            f"{verdict['non_200']} non-200(s) during the probe window "
            f"(budget 0; statuses: {probe.statuses})"
        )
    if burning is not None:
        is_latency = burning.startswith(
            _LATENCY_OBJECTIVE_PREFIX
        ) and "latency" in burning
        if not is_latency:
            fails.append(
                f"objective {burning!r} is fast-burning on the canary "
                "replica"
            )
        elif not single_core:
            fails.append(
                f"latency objective {burning!r} is fast-burning on the "
                "canary replica (multi-core host: the canary is "
                "sick-slow, not promotable)"
            )
        else:
            verdict["latency_burn_waived"] = "single-core host"
    return verdict, fails


def _gate_qos_fairness(ctx: _GateContext):
    """The noisy-neighbor scenario's shippable failure mode: a rollout
    that breaks classification or admission, so a best_effort flood
    hurts interactive traffic — or the QoS surface itself vanished.
    Drill: flood the canary's scoring endpoint with best_effort-tagged
    requests (valid bodies, widths from GET /qos ``feature_widths``)
    while the probe + the caller's real traffic hook keep running;
    judge from the GET /qos counter DELTAS — the flood must classify
    as best_effort, any admission sheds must land on it, and the probe
    window must stay all-200."""
    qos0 = ctx.get_json("qos")
    widths = (qos0.get("engine") or {}).get("feature_widths") or {}
    fails: List[str] = []
    verdict: Dict[str, Any] = {
        "gate_mode": "qos_fairness_flood",
        "injected": "best_effort-tagged scoring flood against the "
        "canary while interactive probes run",
        "detected": bool(qos0.get("enabled")),
    }
    if not qos0.get("enabled") or not widths:
        fails.append(
            "GET /qos unavailable or no banked targets to flood "
            f"(enabled={qos0.get('enabled')}, widths={len(widths)})"
        )
        verdict["non_200"] = 0
        return verdict, fails
    target, width = sorted(widths.items())[0]
    flood_statuses: Dict[str, int] = {}
    stop = threading.Event()

    def flood() -> None:
        url = (
            f"{ctx.base_url}/gordo/v0/{ctx.project}/{target}/prediction"
        )
        body = json.dumps({"X": [[0.5] * width] * 8}).encode()
        headers = {
            "Content-Type": "application/json",
            "X-Gordo-Tenant": "gate-flood",
            "X-Gordo-Priority": "best_effort",
        }
        while not stop.is_set():
            key = _status(url, ctx.http_timeout, data=body, headers=headers)
            flood_statuses[key] = flood_statuses.get(key, 0) + 1

    threads = [
        threading.Thread(target=flood, daemon=True) for _ in range(4)
    ]
    with _Probe(
        ctx.base_url, ctx.project, ctx.traffic,
        http_timeout=ctx.http_timeout,
    ) as probe:
        for t in threads:
            t.start()
        time.sleep(max(ctx.settle_s * 2, 1.5))
        stop.set()
        for t in threads:
            t.join(timeout=15)
    qos1 = ctx.get_json("qos")

    def _sum(doc, section, want_class=None):
        cells = (doc.get("admission") or {}).get(section) or {}
        return sum(
            n for key, n in cells.items()
            if want_class is None or key.split("|")[1:2] == [want_class]
        )

    admitted_be = _sum(qos1, "admitted", "best_effort") - _sum(
        qos0, "admitted", "best_effort"
    )
    shed_all = _sum(qos1, "shed") - _sum(qos0, "shed")
    shed_be = _sum(qos1, "shed", "best_effort") - _sum(
        qos0, "shed", "best_effort"
    )
    precision = round(shed_be / shed_all, 4) if shed_all > 0 else None
    verdict.update(
        {
            "flood_target": target,
            "flood_statuses": flood_statuses,
            "non_200": probe.non_200 + probe.traffic_errors,
            "probe_requests": probe.requests,
            "probe_statuses": probe.statuses,
            "probe_p95_ms": probe.p95_ms(),
            "best_effort_admitted_delta": admitted_be,
            "shed_delta": shed_all,
            "shed_on_best_effort_delta": shed_be,
            "shed_precision": precision,
        }
    )
    if admitted_be + shed_be <= 0:
        fails.append(
            "the best_effort flood never classified (admitted + shed "
            "deltas are zero): the QoS request path is broken"
        )
    if precision is not None and precision < 0.9:
        fails.append(
            f"shed precision {precision} < 0.9: admission shed "
            "traffic outside the flooding class"
        )
    if verdict["non_200"]:
        fails.append(
            f"{verdict['non_200']} interactive non-200(s) during the "
            f"flood window (budget 0; statuses: {probe.statuses})"
        )
    return verdict, fails


_GATE_DRILLS = {
    "replica_crash_restart": _gate_reload_under_load,
    "gray_failure_slow_replica": _gate_latency_burn_probe,
    "tenant_noisy_neighbor": _gate_qos_fairness,
}


def run_promotion_gate(
    base_url: str,
    project: str,
    scenarios: Optional[List[str]] = None,
    traffic: Optional[Callable[[str], Any]] = None,
    http_timeout: float = 30.0,
    settle_s: float = 0.8,
) -> Dict[str, Any]:
    """Run the gate-mode drills for ``scenarios`` (default
    :data:`~gameday.scenarios.GATE_DEFAULT`) against one live replica
    and return the judged gate document. Unknown or non-gate-capable
    scenario names raise — a compiled spec naming them should have
    failed validation, and a silent skip would turn a declared gate
    into no gate."""
    names = list(scenarios if scenarios is not None else GATE_DEFAULT)
    for name in names:
        if name not in SCENARIOS:
            raise ValueError(
                f"unknown gameday scenario {name!r} "
                f"(known: {sorted(SCENARIOS)})"
            )
        if name not in _GATE_DRILLS:
            raise ValueError(
                f"scenario {name!r} has no gate-mode drill "
                f"(gate-capable: {sorted(_GATE_DRILLS)})"
            )
    ctx = _GateContext(base_url, project, traffic, http_timeout, settle_s)
    doc: Dict[str, Any] = {
        "schema": GATE_SCHEMA,
        "base_url": ctx.base_url,
        "scenarios": {},
    }
    for name in names:
        t0 = time.monotonic()
        try:
            verdict, fails = _GATE_DRILLS[name](ctx)
        except Exception as exc:
            logger.exception("gameday gate drill %s crashed", name)
            verdict, fails = (
                {"gate_mode": "crashed", "detected": False},
                [f"gate drill crashed: {type(exc).__name__}: {exc}"],
            )
        verdict["scenario"] = name
        verdict["wall_seconds"] = round(time.monotonic() - t0, 3)
        doc["scenarios"][name] = finalize_verdict(verdict, fails)
    doc["passed"] = all(
        v["passed"] for v in doc["scenarios"].values()
    ) and bool(doc["scenarios"])
    return doc
