"""Incident correlation: SLO-burn episodes x the fleet event timeline.

Counterpart of ``gordo_components_tpu/watchman/correlate.py``, the same
functions over the same plain data.

The server-side flight recorder retains two axes per replica — metric
history (observability/timeseries.py) and the structured event log
(observability/events.py). This module is the watchman-side join: find
the windows where a replica's ``gordo_slo_burn_rate`` history ran above
threshold (**episodes**), group overlapping episodes fleet-wide into
**incidents**, and attach every event that falls inside the incident's
window (plus a margin) as an ordered, rendered timeline. The result is
the two-clicks-from-spike story extended from one request (tracing)
to the whole fleet: ``GET /incidents`` answers "what burned, when,
and what else happened around it" without an operator replaying four
dashboards side by side.

Pure functions over plain data (points are ``[[t, v|None], ...]``,
events are the dicts ``GET /events`` serves) — unit-testable without a
fleet, and reusable by the replay harness for per-scenario timelines.
"""

from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "burn_episodes",
    "group_incidents",
    "render_timeline",
]

# budget burning faster than it accrues — the classic multi-window SLO
# alert floor, NOT the page-now fast-burn threshold (14.4): an incident
# record should cover the whole degradation, not only its peak
DEFAULT_BURN_THRESHOLD = 1.0


def burn_episodes(
    points: Sequence[Sequence[Any]],
    threshold: float = DEFAULT_BURN_THRESHOLD,
    min_points: int = 1,
) -> List[Dict[str, Any]]:
    """Maximal runs of ``value >= threshold`` in one series' points.

    A ``None``/missing value ends the current run (absence of evidence
    is not evidence of burning). Runs shorter than ``min_points`` are
    dropped — one hot sample is noise, the same lesson the canary
    window judge applies."""
    episodes: List[Dict[str, Any]] = []
    run: List[Tuple[float, float]] = []

    def flush():
        if len(run) >= min_points:
            episodes.append(
                {
                    "start": run[0][0],
                    "end": run[-1][0],
                    "peak": max(v for _, v in run),
                    "points": len(run),
                }
            )
        run.clear()

    for pt in points:
        t, v = pt[0], pt[1]
        if v is not None and v >= threshold:
            run.append((float(t), float(v)))
        else:
            flush()
    flush()
    return episodes


def group_incidents(
    episodes: List[Dict[str, Any]],
    events: Optional[List[Dict[str, Any]]] = None,
    margin_s: float = 30.0,
) -> List[Dict[str, Any]]:
    """Merge overlapping/adjacent episodes (within ``margin_s``) into
    incident records and attach the events whose wall time falls inside
    each incident's margin-padded window, oldest first.

    Each input episode may carry ``series``/``replica`` tags (added by
    the caller); the incident unions them so the record names every
    objective and replica that burned."""
    if not episodes:
        return []
    ordered = sorted(episodes, key=lambda e: (e["start"], e["end"]))
    groups: List[List[Dict[str, Any]]] = [[ordered[0]]]
    for ep in ordered[1:]:
        cur = groups[-1]
        if ep["start"] <= max(e["end"] for e in cur) + margin_s:
            cur.append(ep)
        else:
            groups.append([ep])
    incidents: List[Dict[str, Any]] = []
    for i, grp in enumerate(groups):
        start = min(e["start"] for e in grp)
        end = max(e["end"] for e in grp)
        attached = [
            ev
            for ev in (events or ())
            if start - margin_s <= float(ev.get("wall", 0)) <= end + margin_s
        ]
        attached.sort(key=lambda ev: (float(ev.get("wall", 0)), ev.get("seq", 0)))
        incidents.append(
            {
                "id": i,
                "start": start,
                "end": end,
                "duration_s": round(end - start, 3),
                "peak_burn": max(e["peak"] for e in grp),
                "episodes": [
                    {k: v for k, v in e.items() if k != "points"} for e in grp
                ],
                "series": sorted(
                    {e["series"] for e in grp if e.get("series")}
                ),
                "replicas": sorted(
                    {e["replica"] for e in grp if e.get("replica") is not None}
                ),
                "events": attached,
                "timeline": render_timeline(start, attached),
            }
        )
    return incidents


def render_timeline(start: float, events: List[Dict[str, Any]]) -> List[str]:
    """Human-readable one-line-per-event rendering, offsets relative to
    the incident's start (negative = led up to it)."""
    lines: List[str] = []
    for ev in events:
        offset = float(ev.get("wall", 0)) - start
        attrs = ev.get("attrs") or {}
        detail = " ".join(f"{k}={attrs[k]}" for k in sorted(attrs))
        who = ev.get("replica") or "fleet"
        lines.append(
            f"{offset:+9.2f}s [{ev.get('severity', 'info'):7s}] "
            f"{who}: {ev.get('type')}"
            + (f" ({detail})" if detail else "")
        )
    return lines
