"""Shared scenario-verdict schema.

Counterpart of ``gordo_components_tpu/replay/verdict.py``: the same
envelope, so a verdict of the port reads as one of the JAX package.

Two harnesses judge the system by scenario: the replay engine (recorded
incident timelines against one in-process server) and the mesh
game days (``gameday/`` — injected mesh failures against a live
multi-process fleet). Both emit the SAME verdict envelope so
``BENCH_DETAIL.json`` consumers, the CI lanes, and the fleet compiler's
promotion gate read one shape:

- ``schema``: :data:`VERDICT_SCHEMA`;
- ``scenario`` / ``description``: which drill this was;
- ``failures``: list of human-readable bound violations (empty = pass);
- ``passed``: ``not failures``.

Everything else in the dict is scenario-specific evidence (detection
latency, status counts, timelines, ...) — the envelope promises only
that ``failures``/``passed`` were produced by popping every declared
bound, with leftovers reported as a failure (a typo'd bound must fail
loudly, not silently pass).
"""

from typing import Any, Dict, List, Optional

VERDICT_SCHEMA = "gordo.scenario-verdict/v1"

__all__ = [
    "VERDICT_SCHEMA",
    "check_detection",
    "check_non200",
    "finalize_verdict",
]


def finalize_verdict(
    verdict: Dict[str, Any], failures: List[str]
) -> Dict[str, Any]:
    """Stamp the envelope fields onto a judged verdict (in place)."""
    verdict["schema"] = VERDICT_SCHEMA
    verdict["failures"] = list(failures)
    verdict["passed"] = not verdict["failures"]
    return verdict


def check_non200(
    verdict: Dict[str, Any], budget: int, fails: List[str]
) -> None:
    """Containment bound shared by both harnesses: data-plane non-200
    responses observed vs the scenario's DECLARED budget (default 0 —
    'bounded blast radius' is a number, not a vibe)."""
    non200 = int(verdict.get("non_200", 0))
    if non200 > budget:
        fails.append(
            f"{non200} non-200 data-plane responses > budget {budget} "
            f"(statuses: {verdict.get('statuses')})"
        )


def check_detection(
    detected: bool,
    latency_s: Optional[float],
    max_latency_s: Optional[float],
    what: str,
    fails: List[str],
) -> None:
    """Detection bound: the observability stack must have seen ``what``
    at all, and (when bounded) within ``max_latency_s``."""
    if not detected:
        fails.append(f"{what} was never detected")
    elif (
        max_latency_s is not None
        and latency_s is not None
        and latency_s > max_latency_s
    ):
        fails.append(
            f"{what} detection took {latency_s:.1f}s > {max_latency_s:.1f}s"
        )
