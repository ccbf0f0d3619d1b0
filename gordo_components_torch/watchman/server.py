"""The watchman's read side: fleet health, the fleet rollups and the routing
table over one or more serving replicas.

Counterpart of ``gordo_components_tpu/watchman/server.py``, on the standard
library where the JAX service rides aiohttp:

- :class:`WatchmanState` keeps the JAX state logic: its coroutines poll the
  replicas over the port's asyncio HTTP/1.1 :class:`~gordo_components_torch.client.http.Session`,
  with the JAX deadlines (10 s a scrape or a probe, 30 s a request whole)
  and the JAX caches on the clock seam (``clock``, default the real one).
  A snapshot of a collection server costs one ``metadata-all`` request
  (plus the best-effort ``/stats``); a foreign server is polled a target at
  a time, at most ``parallelism`` at once.
- :class:`WatchmanApp` runs those coroutines on one asyncio loop of its own,
  on a daemon thread; :class:`WatchmanServer` is a ``ThreadingHTTPServer``
  whose handler threads hand each request to that loop
  (``asyncio.run_coroutine_threadsafe``).

The concurrency contract is the JAX one: ``GET /`` and a cached ``/metrics``
never wait for a replica (``wait=False`` serves the cache and starts a
background refresh), and a failed refresh degrades to the last good
answer with a stale stamp, never a 500. The fault points
``watchman.scrape`` (each ``/metrics`` scrape), ``watchman.snapshot`` (each
health-snapshot refresh) and ``watchman.probe`` (each replica probe of a
routing rebuild) are the JAX sites.

Routes (the JAX ones): ``GET /``, ``/healthcheck``, ``/metrics``,
``/traces`` (``?n=``), ``/slo``, ``/drift`` and ``/costs`` (``?refresh=1``),
``/heat`` (``?top=``, ``?refresh=1``), ``/history`` (``?series=``,
``since``, ``until``, ``step``), ``/events`` (``?type=``, ``since_wall``,
``limit``), ``/incidents`` (``?threshold=``, ``?margin=``) and ``/routing``
(``?refresh=1``; an ``If-None-Match`` equal to its ``ETag`` answers 304).
The write side (JAX ``server.py:937-1535, 2079-2168``): ``POST /rebalance``
fans a rebalance out to every replica's ``/rebalance`` (``?dry_run=1``, body
``{"force": true}``) and reports each verdict; ``POST /migrate`` (body
``{"member": name, "to": replica, "from": replica}``) moves one member
between replicas of the serving mesh (acquire on the destination with the
source as its artifact's source, the routing table pinned to the
destination, then release on the source; serialized, 409 when it did not
move); ``POST /fleet-rebalance`` (``?dry_run=1``, ``{"force": true}``)
plans moves over the replicas' ``/placement`` loads with
``placement/planner.plan_fleet`` and applies them one by one. A move
counts in ``gordo_fleet_migrations_total``, a failed acquire in
``gordo_fleet_migrations_failed_total``.
"""

import asyncio
import json
import logging
import math
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qsl

from gordo_components_torch import __version__
from gordo_components_torch.client.http import ClientError, Session
from gordo_components_torch.client.io import fetch_metadata_all
from gordo_components_torch.observability.cost import merge_cost_snapshots
from gordo_components_torch.observability.events import EventLog
from gordo_components_torch.observability.heat import merge_heat_snapshots
from gordo_components_torch.observability.metrics import parse_prometheus_text, render_samples
from gordo_components_torch.placement.planner import plan_fleet
from gordo_components_torch.observability.slo import merge_slo_snapshots
from gordo_components_torch.replay.clock import SYSTEM_CLOCK
from gordo_components_torch.resilience.deadline import Deadline
from gordo_components_torch.resilience.faults import faultpoint
from gordo_components_torch.server.transport import HTTPError
from gordo_components_torch.utils import env_num
from gordo_components_torch.utils.digest import metadata_digest
from gordo_components_torch.watchman.correlate import DEFAULT_BURN_THRESHOLD, burn_episodes, group_incidents
from gordo_components_torch.workflow.gang_state import read_gang_states

__all__ = [
    "WatchmanApp", "WatchmanServer", "WatchmanState", "aggregate_fleet_metrics", "build_watchman_app",
    "render_fleet_metrics", "run_watchman",
]

logger = logging.getLogger(__name__)

# the JAX sites: a replica /metrics scrape and the health-snapshot refresh
# degrade to last-good with a stale stamp; a fired probe reads as "replica
# unreachable", which is what a partition looks like from here
_FP_SCRAPE = faultpoint("watchman.scrape")
_FP_SNAPSHOT = faultpoint("watchman.snapshot")
_FP_PROBE = faultpoint("watchman.probe")

SCRAPE_DEADLINE_S = 10.0  # one replica fetch or probe
REQUEST_TIMEOUT_S = 30.0  # one request whole (the JAX ClientTimeout(total=30))
METRICS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
MOVE_DEADLINE_S = 240.0  # one acquire, release or rebalance: a bank build and warm-up
MOVE_TIMEOUT_S = 300.0  # its request whole (the JAX ClientTimeout(total=300))
_TRUE = ("1", "true", "yes")


def aggregate_fleet_metrics(
    texts: List[Optional[str]],
    prev_shard_rows: Optional[List[Optional[Dict[str, float]]]] = None,
) -> Dict[str, Any]:
    """Scraped ``/metrics`` bodies of N replicas (``None`` for a failed
    scrape) as one fleet view: each series' sum and max across replicas
    (NaN samples skipped), and the per-shard routing skew, max/mean of a
    replica's ``gordo_bank_shard_routed_rows_total`` shards, fleet max.
    With ``prev_shard_rows`` (the previous scrape's per-replica rows) the
    skew is over the scrape-to-scrape deltas; a replica whose counters fell
    (a restart) counts its totals, one without a baseline its lifetime
    totals. ``skew_window`` says what fed the max: ``delta``, ``lifetime``
    or ``mixed``."""
    types: Dict[str, str] = {}
    sums: Dict[Any, float] = {}
    maxs: Dict[Any, float] = {}
    routed_by_shard: Dict[str, float] = {}
    replica_shard_rows: List[Optional[Dict[str, float]]] = []
    for text in texts:
        if text is None:
            replica_shard_rows.append(None)
            continue
        t, samples = parse_prometheus_text(text)
        types.update(t)
        shard_rows: Dict[str, float] = {}
        for name, labels, value in samples:
            if not math.isfinite(value):
                continue  # one replica's NaN must not poison the fleet's sums
            key = (name, tuple(sorted(labels.items())))
            sums[key] = sums.get(key, 0.0) + value
            maxs[key] = max(maxs.get(key, value), value)
            if name == "gordo_bank_shard_routed_rows_total":
                shard = labels.get("shard", "?")
                shard_rows[shard] = shard_rows.get(shard, 0.0) + value
                routed_by_shard[shard] = routed_by_shard.get(shard, 0.0) + value
        replica_shard_rows.append(shard_rows)

    def ratio(rows: Dict[str, float]) -> Optional[float]:
        if not rows:
            return None
        mean = sum(rows.values()) / len(rows)
        return (max(rows.values()) / mean) if mean > 0 else None

    delta_skews: List[float] = []
    lifetime_skews: List[float] = []
    for idx, rows in enumerate(replica_shard_rows):
        if not rows:
            continue
        base = None
        if prev_shard_rows is not None and idx < len(prev_shard_rows):
            base = prev_shard_rows[idx]
        if base:
            deltas = {s: v - base.get(s, 0.0) for s, v in rows.items()}
            if any(d < 0 for d in deltas.values()):
                # a counter reset: the post-restart totals are the window
                r = ratio(rows)
                if r is not None:
                    delta_skews.append(r)
                continue
            r = ratio(deltas)
            if r is not None:
                delta_skews.append(r)
            continue  # no traffic since the last scrape: no skew signal
        r = ratio(rows)
        if r is not None:
            lifetime_skews.append(r)
    all_skews = delta_skews + lifetime_skews
    if not all_skews:
        skew, window = None, None
    else:
        skew = max(all_skews)
        if delta_skews and lifetime_skews:
            window = "mixed"
        elif delta_skews:
            window = "delta"
        else:
            window = "lifetime"
    return {
        "replicas_scraped": sum(1 for t in texts if t is not None),
        "types": types,
        "sums": sums,
        "maxs": maxs,
        "routed_rows_by_shard": routed_by_shard,
        "replica_shard_rows": replica_shard_rows,
        "shard_skew_ratio": round(skew, 4) if skew is not None else None,
        "skew_window": window,
    }


def render_fleet_metrics(
    agg: Dict[str, Any],
    now_mono: Optional[float] = None,
    extra_gauges: Optional[List[tuple]] = None,
) -> str:
    """The rollup as Prometheus text: the fleet gauges first, then the
    scraped series under their own names. Counters and histogram samples
    sum across replicas; gauges take the replica max. Each replica that
    has answered once gets ``gordo_fleet_scrape_stale_seconds``, aged at
    ``now_mono`` (default the real clock)."""
    samples = [("gordo_fleet_replicas_scraped", {}, float(agg["replicas_scraped"]))]
    types = {"gordo_fleet_replicas_scraped": "gauge"}
    helps = {
        "gordo_fleet_replicas_scraped": "Server replicas whose /metrics answered",
        "gordo_fleet_shard_skew_ratio": (
            "max/mean routed rows across one replica's shards over the "
            "scrape-to-scrape window (lifetime totals on the first "
            "scrape), fleet max; 1.0 = balanced routing"
        ),
        "gordo_fleet_shard_routed_rows_max": "Hottest shard's routed rows",
        "gordo_fleet_shard_routed_rows_mean": "Mean routed rows per shard",
        "gordo_fleet_scrape_stale_seconds": (
            "Seconds since each replica's /metrics last answered; a "
            "missed scrape keeps the replica's last-good numbers in the "
            "rollup (counters stay monotonic) and THIS gauge is how the "
            "substitution stays visible. ~0 = fresh"
        ),
    }
    last_success = agg.get("replica_last_success") or []
    if any(ts is not None for ts in last_success):
        if now_mono is None:
            now_mono = SYSTEM_CLOCK.monotonic()
        types["gordo_fleet_scrape_stale_seconds"] = "gauge"
        for i, ts in enumerate(last_success):
            if ts is None:
                continue
            samples.append(("gordo_fleet_scrape_stale_seconds", {"replica": str(i)},
                            round(max(0.0, now_mono - ts), 3)))
    if agg["shard_skew_ratio"] is not None:
        samples.append(("gordo_fleet_shard_skew_ratio", {}, float(agg["shard_skew_ratio"])))
        types["gordo_fleet_shard_skew_ratio"] = "gauge"
    for name, mtype, help_text, labels, value in extra_gauges or ():
        samples.append((name, labels, float(value)))
        types[name] = mtype
        helps[name] = help_text
    shard_rows = agg["routed_rows_by_shard"]
    if shard_rows:
        vals = list(shard_rows.values())
        samples.append(("gordo_fleet_shard_routed_rows_max", {}, max(vals)))
        samples.append(("gordo_fleet_shard_routed_rows_mean", {}, sum(vals) / len(vals)))
        types["gordo_fleet_shard_routed_rows_max"] = "gauge"
        types["gordo_fleet_shard_routed_rows_mean"] = "gauge"
    scraped_types = agg["types"]
    types.update(scraped_types)
    for (name, labelitems), value in sorted(agg["sums"].items()):
        if scraped_types.get(name) == "gauge":
            value = agg["maxs"][(name, labelitems)]
        samples.append((name, dict(labelitems), value))
    return render_samples(samples, types=types, help_texts=helps)


async def _bounded_get(session: Session, url: str, params=None, what: str = "fetch", text: bool = False):
    """A best-effort GET under the scrape deadline: the 200 body (JSON, or
    text), else None. Broad by contract: a foreign peer can answer 200
    with bytes that do not parse."""

    async def get():
        resp = await session.get(url, params=params)
        if resp.status != 200:
            return None
        return resp.text() if text else resp.json()

    try:
        return await Deadline(SCRAPE_DEADLINE_S).wait_for(get())
    except asyncio.CancelledError:
        raise
    except Exception as exc:
        logger.debug("%s failed for %s: %s", what, url, exc)
        return None


class WatchmanState:
    """The watchman's caches and its coroutines over the replicas (JAX
    ``WatchmanState``). Runs on one event loop."""

    def __init__(
        self,
        project: str,
        base_url: str,
        targets: Optional[List[str]] = None,
        refresh_interval: float = 30.0,
        parallelism: int = 20,
        gang_state_dir: Optional[str] = None,
        gang_stale_after: float = 120.0,
        full_metadata: bool = False,
        metrics_urls: Optional[List[str]] = None,
        clock=None,
    ):
        self.project = project
        self.base_url = base_url.rstrip("/")
        # cache ages and scrape staleness read the clock seam
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        self.targets = targets
        self.refresh_interval = refresh_interval
        self.parallelism = parallelism
        # the replicas' /metrics URLs: the replica set of every fan-out
        # (default the collection server behind base_url)
        self.metrics_urls = metrics_urls
        self._metrics_cache: Optional[Dict[str, Any]] = None
        self._metrics_time = 0.0
        self._metrics_lock = asyncio.Lock()
        self._metrics_prev_rows: Optional[List[Optional[Dict[str, float]]]] = None
        # each replica's last good body and when it answered: a missed
        # scrape keeps its numbers (the summed counters never fall) and
        # the rollup stamps how stale they are
        self._metrics_last_texts: List[Optional[str]] = []
        self._metrics_last_success: List[Optional[float]] = []
        self._metrics_task: Optional[asyncio.Task] = None
        # fleet_slo's half of the same contract
        self._slo_last_bodies: List[Optional[Dict[str, Any]]] = []
        self._slo_last_success: List[Optional[float]] = []
        self.full_metadata = bool(full_metadata)
        # builder gangs' heartbeats (workflow/gang_state.py) beside serving health
        self.gang_state_dir = gang_state_dir
        self.gang_stale_after = gang_stale_after
        self._cache: Optional[Dict[str, Any]] = None
        self._cache_time = 0.0
        self._lock = asyncio.Lock()
        # the drift rollup, on the snapshot's cadence; staleness above this
        # makes the health snapshot degraded
        self.staleness_degraded_s = env_num("GORDO_STALENESS_DEGRADED_S", 600.0, float)
        self._drift_cache: Optional[Dict[str, Any]] = None
        self._drift_time = 0.0
        self._drift_lock = asyncio.Lock()
        self._drift_task: Optional[asyncio.Task] = None
        # the versioned member -> replica table; the version bumps only when
        # its content changes
        self._routing_cache: Optional[Dict[str, Any]] = None
        self._routing_time = 0.0
        self._routing_version = 0
        self._routing_core: Optional[Any] = None
        self._routing_lock = asyncio.Lock()
        self._routing_task: Optional[asyncio.Task] = None
        # each replica's last observed reachability: a True -> False step
        # bumps the version and emits mesh.replica_unreachable
        self._replica_reachable: Dict[int, bool] = {}
        # member -> the replica a move pinned it to, until the migration
        # converges there; each replica's observed member list
        self._routing_overrides: Dict[str, int] = {}
        self._routing_member_lists: Dict[int, List[str]] = {}
        # the write side: one move at a time, its counters rendered beside
        # the routing version, and the fleet planner's load floor
        self._migration_lock = asyncio.Lock()
        self._migrations_total = 0
        self._migrations_failed = 0
        self.mesh_min_rows = int(env_num("GORDO_MESH_MIN_ROWS", 1024.0, float))
        # the watchman's own slice of the fleet timeline
        self.events = EventLog(clock=self.clock, replica="watchman")

    def _url(self, target: str, endpoint: str) -> str:
        return f"{self.base_url}/gordo/v0/{self.project}/{target}/{endpoint}"

    async def _check_target(self, session: Session, sem: asyncio.Semaphore, target: str) -> Dict[str, Any]:
        """One target's ``healthcheck`` and ``metadata`` (digested unless
        ``full_metadata``): the per-target poll of a foreign server."""
        entry: Dict[str, Any] = {"endpoint": f"/gordo/v0/{self.project}/{target}/", "target": target,
                                 "healthy": False}
        async with sem:
            try:
                resp = await session.get(self._url(target, "healthcheck"))
                entry["healthy"] = resp.status == 200
                if entry["healthy"]:
                    resp = await session.get(self._url(target, "metadata"))
                    if resp.status == 200:
                        meta = resp.json().get("endpoint-metadata", {})
                        if self.full_metadata:
                            entry["endpoint-metadata"] = meta
                        else:
                            entry["digest"] = metadata_digest(meta)
            except (ClientError, asyncio.TimeoutError) as exc:
                logger.warning("healthcheck failed for %s: %s", target, exc)
        return entry

    async def _fetch_metadata_all(self, session: Session) -> Optional[Dict[str, Any]]:
        """Every target's health and metadata in one ``metadata-all``
        request; None when the server does not speak it."""
        return await fetch_metadata_all(session, self.base_url, self.project, digest=not self.full_metadata)

    async def _fetch_stats(self, session: Session) -> Optional[Dict[str, Any]]:
        """The collection's ``/stats``: best-effort decoration."""

        async def get():
            resp = await session.get(f"{self.base_url}/gordo/v0/{self.project}/stats")
            if resp.status != 200:
                return None
            return resp.json()

        try:
            body = await Deadline(SCRAPE_DEADLINE_S).wait_for(get())
        except (ClientError, asyncio.TimeoutError, ValueError) as exc:
            logger.debug("stats fetch failed: %s", exc)
            return None
        return body if isinstance(body, dict) else None

    async def fleet_metrics(self, wait: bool = True) -> Optional[Dict[str, Any]]:
        """Every replica's ``/metrics`` scraped and aggregated
        (:func:`aggregate_fleet_metrics`), cached for ``refresh_interval``.
        A failed scrape keeps the replica's last good body; the rollup's
        ``replicas_scraped`` counts the live answers and
        ``replica_last_success`` when each replica last answered.
        ``wait=False`` never waits: it returns the cache (None before the
        first scrape) and starts a background refresh when it is due."""
        if not wait:
            if (self._metrics_cache is None
                    or self.clock.monotonic() - self._metrics_time >= self.refresh_interval) and (
                    self._metrics_task is None or self._metrics_task.done()):
                self._metrics_task = asyncio.get_running_loop().create_task(self.fleet_metrics())
            return self._metrics_cache
        async with self._metrics_lock:
            now = self.clock.monotonic()
            if self._metrics_cache is not None and now - self._metrics_time < self.refresh_interval:
                return self._metrics_cache
            urls = self.metrics_urls or [f"{self.base_url}/gordo/v0/{self.project}/metrics"]
            async with Session(timeout=REQUEST_TIMEOUT_S) as session:

                async def scrape(url):
                    try:
                        _FP_SCRAPE.fire()
                    except Exception as exc:
                        logger.debug("metrics scrape failed for %s: %s", url, exc)
                        return None
                    return await _bounded_get(session, url, what="metrics scrape", text=True)

                texts = list(await asyncio.gather(*(scrape(u) for u in urls)))
            live_count = sum(1 for t in texts if t is not None)
            # freshness before the last-good substitution: a frozen replica is stale
            mono = self.clock.monotonic()
            succ = self._metrics_last_success
            succ.extend([None] * (len(texts) - len(succ)))
            for i, t in enumerate(texts):
                if t is not None:
                    succ[i] = mono
            last = self._metrics_last_texts
            texts = [t if t is not None else (last[i] if i < len(last) else None) for i, t in enumerate(texts)]
            self._metrics_last_texts = texts
            cache = aggregate_fleet_metrics(texts, prev_shard_rows=self._metrics_prev_rows)
            cache["replicas_scraped"] = live_count
            cache["replica_last_success"] = list(succ)
            # the next scrape's delta baseline keeps each replica's last rows
            new_rows = cache["replica_shard_rows"]
            prev = self._metrics_prev_rows or [None] * len(new_rows)
            self._metrics_prev_rows = [n if n is not None else (prev[i] if i < len(prev) else None)
                                       for i, n in enumerate(new_rows)]
            self._metrics_cache = cache
            self._metrics_time = now
            return cache

    def _trace_urls(self) -> List[str]:
        return [u + "/traces/slow" for u in self._replica_prefixes()]

    async def _fetch_replica_json(self, suffix: str, params_per_replica=None) -> List[Optional[Dict[str, Any]]]:
        """``GET <replica>/<suffix>`` across the fleet, best-effort: a body
        or None a replica, in replica order. ``params_per_replica`` maps an
        index to its query; ``False`` skips the replica."""
        prefixes = self._replica_prefixes()
        async with Session(timeout=REQUEST_TIMEOUT_S) as session:

            async def fetch(i, url):
                params = params_per_replica.get(i) if params_per_replica is not None else None
                if params is False:
                    return None
                return await _bounded_get(session, url, params, what=f"{suffix} fetch")

            return list(await asyncio.gather(*(fetch(i, f"{p}/{suffix}") for i, p in enumerate(prefixes))))

    async def fleet_slo(self, refresh: bool = False) -> Dict[str, Any]:
        """Every replica's ``GET /slo`` merged (``merge_slo_snapshots``);
        an unreachable replica keeps its last good body, stamped ``stale``
        with ``stale_seconds``. ``refresh`` forwards ``?refresh=1``."""
        urls = [u + "/slo" for u in self._replica_prefixes()]
        params = {"refresh": "1"} if refresh else None
        async with Session(timeout=REQUEST_TIMEOUT_S) as session:
            bodies = list(await asyncio.gather(*(_bounded_get(session, u, params, "slo scrape") for u in urls)))
        live = [body is not None for body in bodies]
        mono = self.clock.monotonic()
        succ = self._slo_last_success
        succ.extend([None] * (len(bodies) - len(succ)))
        for i, body in enumerate(bodies):
            if body is not None:
                succ[i] = mono
        last = self._slo_last_bodies
        bodies = [b if b is not None else (last[i] if i < len(last) else None) for i, b in enumerate(bodies)]
        self._slo_last_bodies = bodies
        merged = merge_slo_snapshots(bodies)
        merged["replicas"] = [
            {
                "replica": i,
                "scraped": live[i],
                "stale": body is not None and not live[i],
                "stale_seconds": round(mono - succ[i], 3) if not live[i] and succ[i] is not None else None,
                "slo_enabled": bool(body and body.get("enabled")),
                "worst": (body or {}).get("worst"),
            }
            for i, body in enumerate(bodies)
        ]
        merged["replicas_scraped"] = sum(live)
        return merged

    async def fleet_heat(self, top_n: int = 10, refresh: bool = False) -> Dict[str, Any]:
        """Every replica's ``GET /heat`` merged (``merge_heat_snapshots``):
        member rates summed and ranked fleet-wide; ``top_n`` forwards as
        each replica's ``?top=``."""
        q = {"top": str(int(top_n))}
        if refresh:
            q["refresh"] = "1"
        params = {i: q for i in range(len(self._replica_prefixes()))}
        bodies = await self._fetch_replica_json("heat", params)
        merged = merge_heat_snapshots(bodies, top_n=top_n)
        merged["replicas"] = [{"replica": i, "scraped": body is not None,
                               "heat_enabled": bool(body and body.get("enabled"))}
                              for i, body in enumerate(bodies)]
        return merged

    async def fleet_costs(self, refresh: bool = False) -> Dict[str, Any]:
        """Every replica's ``GET /costs`` merged (``merge_cost_snapshots``)."""
        params = None
        if refresh:
            params = {i: {"refresh": "1"} for i in range(len(self._replica_prefixes()))}
        bodies = await self._fetch_replica_json("costs", params)
        merged = merge_cost_snapshots(bodies)
        merged["replicas"] = [{"replica": i, "scraped": body is not None,
                               "cost_enabled": bool(body and body.get("enabled"))}
                              for i, body in enumerate(bodies)]
        return merged

    async def fleet_history(self, series: Optional[List[str]] = None, since: Optional[float] = None,
                            until: Optional[float] = None, step: Optional[float] = None) -> Dict[str, Any]:
        """Every replica's ``GET /history`` body, per replica (summing
        retained gauges across replicas would make up numbers)."""
        params: Dict[str, str] = {}
        if series:
            params["series"] = ",".join(series)
        for key, val in (("since", since), ("until", until), ("step", step)):
            if val is not None:
                params[key] = str(val)
        shared = {i: (params or None) for i in range(len(self._replica_prefixes()))}
        bodies = await self._fetch_replica_json("history", shared)
        return {
            "replicas_scraped": sum(1 for b in bodies if b is not None),
            "replicas": [{"replica": i, "scraped": b is not None, **(b if b is not None else {"enabled": False})}
                         for i, b in enumerate(bodies)],
        }

    async def fleet_events(self, since_wall: Optional[float] = None, types: Optional[List[str]] = None,
                           limit: Optional[int] = None) -> Dict[str, Any]:
        """Every replica's ``GET /events`` and the watchman's own, merged
        on wall time; each replica event gains ``replica_index`` (and
        ``replica-<i>`` where it names no replica)."""
        params: Dict[str, str] = {}
        if since_wall is not None:
            params["since_wall"] = str(since_wall)
        if types:
            params["type"] = ",".join(types)
        shared = {i: (params or None) for i in range(len(self._replica_prefixes()))}
        bodies = await self._fetch_replica_json("events", shared)
        merged: List[Dict[str, Any]] = []
        for i, body in enumerate(bodies):
            for ev in (body or {}).get("events") or ():
                ev = dict(ev, replica_index=i)
                if not ev.get("replica"):
                    ev["replica"] = f"replica-{i}"
                merged.append(ev)
        merged.extend(self.events.events(types=types, since_wall=since_wall))
        merged.sort(key=lambda ev: (float(ev.get("wall", 0)), ev.get("seq", 0)))
        if limit is not None and limit >= 0:
            merged = merged[-limit:]
        return {"replicas_scraped": sum(1 for b in bodies if b is not None), "events": merged}

    async def fleet_incidents(self, threshold: Optional[float] = None, margin_s: Optional[float] = None,
                              min_points: int = 1) -> Dict[str, Any]:
        """SLO-burn episodes in every replica's retained
        ``gordo_slo_burn_rate`` history, grouped fleet-wide into incidents
        with the event timeline that overlaps each (``watchman/correlate.py``).
        Needs ``GORDO_HISTORY=1`` on the replicas."""
        thr = DEFAULT_BURN_THRESHOLD if threshold is None else float(threshold)
        margin = 30.0 if margin_s is None else float(margin_s)
        metas = await self._fetch_replica_json("history")
        wanted: Dict[int, Any] = {}
        for i, meta in enumerate(metas):
            has_burn = any(n.startswith("gordo_slo_burn_rate") for n in ((meta or {}).get("names") or ()))
            wanted[i] = {"series": "gordo_slo_burn_rate"} if has_burn else False
        history_enabled = sum(1 for m in metas if m is not None and m.get("enabled"))
        episodes: List[Dict[str, Any]] = []
        if any(p is not False for p in wanted.values()):
            bodies = await self._fetch_replica_json("history", wanted)
            for i, body in enumerate(bodies):
                for name, rec in ((body or {}).get("series") or {}).items():
                    for ep in burn_episodes(rec.get("points") or (), thr, min_points):
                        ep["series"] = name
                        ep["replica"] = i
                        episodes.append(ep)
        events_body = await self.fleet_events()
        incidents = group_incidents(episodes, events_body["events"], margin)
        return {
            "incidents": incidents,
            "detected": len(incidents),
            "episodes": len(episodes),
            "threshold": thr,
            "margin_s": margin,
            "replicas_with_history": history_enabled,
            "replicas_scraped": events_body["replicas_scraped"],
        }

    async def fleet_drift(self, refresh: bool = False, wait: bool = True) -> Optional[Dict[str, Any]]:
        """Every replica's ``GET /drift`` aggregated: each replica's drifted
        members, worst member and largest staleness; fleet-wide the union of
        drifted members, the worst (replica, member, score) and the largest
        staleness. ``wait=False`` serves the cache and refreshes in the
        background; ``refresh`` forwards ``?refresh=1`` (a fresh sweep)."""
        if not wait:
            if (self._drift_cache is None
                    or self.clock.monotonic() - self._drift_time >= self.refresh_interval) and (
                    self._drift_task is None or self._drift_task.done()):
                self._drift_task = asyncio.get_running_loop().create_task(self.fleet_drift())
            return self._drift_cache
        async with self._drift_lock:
            now = self.clock.monotonic()
            if not refresh and self._drift_cache is not None and now - self._drift_time < self.refresh_interval:
                return self._drift_cache
            urls = [u + "/drift" for u in self._replica_prefixes()]
            params = {"refresh": "1"} if refresh else None
            async with Session(timeout=REQUEST_TIMEOUT_S) as session:
                bodies = list(await asyncio.gather(*(_bounded_get(session, u, params, "drift scrape")
                                                     for u in urls)))
            replicas: List[Dict[str, Any]] = []
            drifted_union: List[str] = []
            worst: Optional[Dict[str, Any]] = None
            max_stale: Optional[float] = None
            for i, body in enumerate(bodies):
                entry: Dict[str, Any] = {"replica": i, "scraped": body is not None,
                                         "stream_enabled": bool(body and body.get("enabled"))}
                if body and body.get("enabled"):
                    drifted = body.get("drifted") or []
                    entry["drifted"] = drifted
                    drifted_union.extend(drifted)
                    r_worst, r_stale = None, None
                    for name, m in (body.get("members") or {}).items():
                        score = m.get("drift_score")
                        if score is not None and (r_worst is None or score > r_worst["drift_score"]):
                            r_worst = {"model": name, "drift_score": score}
                        stale = m.get("staleness_seconds")
                        if stale is not None and (r_stale is None or stale > r_stale):
                            r_stale = stale
                    entry["worst"] = r_worst
                    entry["max_staleness_seconds"] = r_stale
                    if r_worst is not None and (worst is None or r_worst["drift_score"] > worst["drift_score"]):
                        worst = {"replica": i, **r_worst}
                    if r_stale is not None and (max_stale is None or r_stale > max_stale):
                        max_stale = r_stale
                replicas.append(entry)
            rollup = {
                "replicas": replicas,
                "replicas_streaming": sum(1 for r in replicas if r["stream_enabled"]),
                "drifted": sorted(set(drifted_union)),
                "worst": worst,
                "max_staleness_seconds": max_stale,
                "staleness_degraded_s": self.staleness_degraded_s,
                "stale_degraded": bool(max_stale is not None and max_stale > self.staleness_degraded_s),
            }
            self._drift_cache = rollup
            self._drift_time = self.clock.monotonic()
            return rollup

    def _replica_prefixes(self) -> List[str]:
        """Each replica's ``.../gordo/v0/<project>`` prefix, from the
        metrics scrape targets (the replica set)."""
        urls = self.metrics_urls or [f"{self.base_url}/gordo/v0/{self.project}/metrics"]
        out = []
        for u in urls:
            u = u.rstrip("/")
            if u.endswith("/metrics"):
                u = u[: -len("/metrics")]
            out.append(u)
        return out

    def replica_base_urls(self) -> List[str]:
        """The replicas' base URLs (scheme://host:port), deduplicated: the
        snapshot's replica list before a routing table exists."""
        marker = "/gordo/v0/"
        out: List[str] = []
        for u in self._replica_prefixes():
            base = u.split(marker, 1)[0] if marker in u else u
            if base and base not in out:
                out.append(base)
        return out

    @staticmethod
    async def _get_json(session: Session, url: str, deadline: float = SCRAPE_DEADLINE_S):
        """A bounded JSON GET of the routing plane: None on any failure; a
        non-2xx body that parses is returned (a 503 ``/healthz`` carries
        the status)."""

        async def get():
            resp = await session.get(url)
            try:
                return resp.json()
            except Exception:
                return None

        try:
            return await Deadline(deadline).wait_for(get())
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            logger.debug("routing fetch failed for %s: %s", url, exc)
            return None

    async def routing(self, refresh: bool = False, wait: bool = True) -> Optional[Dict[str, Any]]:
        """The versioned routing table: member -> owning replica, from each
        replica's ``/models`` and ``/healthz``, with each replica's health.
        The version bumps when the content (ownership, reachability,
        status, quarantine sets, the overlap) changes, and when a replica
        goes dark. A member several replicas serve resolves to the replica a
        move pinned it to while that replica serves it, else by a hash of
        its name over its owners, and is listed under ``migrating``.
        ``wait=False`` serves the cache and refreshes in the background."""
        if not wait:
            if (self._routing_cache is None
                    or self.clock.monotonic() - self._routing_time >= self.refresh_interval) and (
                    self._routing_task is None or self._routing_task.done()):
                self._routing_task = asyncio.get_running_loop().create_task(self.routing())
            return self._stamped_routing()
        async with self._routing_lock:
            now = self.clock.monotonic()
            if not refresh and self._routing_cache is not None and now - self._routing_time < self.refresh_interval:
                return self._stamped_routing()
            prefixes = self._replica_prefixes()
            # a base a prefix (not the deduplicated list): two targets on one
            # host must keep their own indexes
            marker = "/gordo/v0/"
            bases = [p.split(marker, 1)[0] if marker in p else p for p in prefixes]
            async with Session(timeout=REQUEST_TIMEOUT_S) as session:

                async def probe(i: int, prefix: str):
                    try:
                        _FP_PROBE.fire()
                    except Exception as exc:
                        # an injected partition: this replica is dark this round
                        logger.debug("routing probe fault for %s: %s", prefix, exc)
                        return i, None, None
                    models, health = await asyncio.gather(self._get_json(session, prefix + "/models"),
                                                          self._get_json(session, prefix + "/healthz"))
                    return i, models, health

                results = await asyncio.gather(*(probe(i, p) for i, p in enumerate(prefixes)))
            replicas: List[Dict[str, Any]] = []
            observed: Dict[str, List[int]] = {}
            member_lists: Dict[int, List[str]] = {}
            for i, models_body, health_body in results:
                names: List[str] = []
                reachable = False
                if isinstance(models_body, dict) and isinstance(models_body.get("models"), list):
                    reachable = True
                    names = [str(n) for n in models_body["models"]]
                status = "unreachable"
                quarantined: List[str] = []
                if isinstance(health_body, dict) and health_body.get("status"):
                    status = str(health_body["status"])
                    quarantined = sorted(health_body.get("quarantined") or {})
                elif reachable:
                    status = "ok"  # /models answered, /healthz did not: servable, health unknown
                member_lists[i] = names
                for name in names:
                    observed.setdefault(name, []).append(i)
                replicas.append({"replica": i, "url": bases[i], "reachable": reachable, "status": status,
                                 "models": len(names), "quarantined": quarantined})
            members: Dict[str, int] = {}
            migrating: Dict[str, List[int]] = {}
            for name, owners in observed.items():
                override = self._routing_overrides.get(name)
                if override is not None and override in owners:
                    members[name] = override
                    if len(owners) == 1:  # the migration converged at its destination
                        del self._routing_overrides[name]
                else:
                    if override is not None:  # the destination lost it: observation wins
                        del self._routing_overrides[name]
                    # a member several replicas serve: primaries spread by a
                    # hash of the name, so a replicated fleet does not idle
                    # all but one
                    owners_sorted = sorted(owners)
                    members[name] = owners_sorted[zlib.crc32(name.encode()) % len(owners_sorted)]
                if len(owners) > 1:
                    migrating[name] = sorted(owners)
            for name in list(self._routing_overrides):
                if name not in observed:
                    del self._routing_overrides[name]
            went_dark: List[Dict[str, Any]] = []
            came_back: List[Dict[str, Any]] = []
            for rep in replicas:
                prev = self._replica_reachable.get(rep["replica"])
                if prev is True and not rep["reachable"]:
                    went_dark.append(rep)
                elif prev is False and rep["reachable"]:
                    came_back.append(rep)
                self._replica_reachable[rep["replica"]] = rep["reachable"]
            core = self._routing_content_key(members, replicas, migrating)
            if core != self._routing_core:
                self._routing_version += 1
                self._routing_core = core
            elif went_dark:
                self._routing_version += 1  # a replica gone dark always steps the version
            for rep in went_dark:
                self.events.emit("mesh.replica_unreachable", severity="error", replica_index=rep["replica"],
                                 url=rep["url"], routing_version=self._routing_version)
            for rep in came_back:
                self.events.emit("mesh.replica_recovered", severity="info", replica_index=rep["replica"],
                                 url=rep["url"], routing_version=self._routing_version)
            self._routing_member_lists = member_lists
            self._routing_cache = {
                "project": self.project,
                "version": self._routing_version,
                "members": members,
                "migrating": migrating,
                "replicas": replicas,
                "refresh_interval": self.refresh_interval,
            }
            self._routing_time = self.clock.monotonic()
            return self._stamped_routing()

    @staticmethod
    def _routing_content_key(members, replicas, migrating) -> tuple:
        """What the version follows: it bumps when this changes."""
        return (
            tuple(sorted(members.items())),
            tuple((r["replica"], r["url"], r["reachable"], r["status"], tuple(r["quarantined"])) for r in replicas),
            tuple(sorted((k, tuple(v)) for k, v in migrating.items())),
        )

    def _stamped_routing(self) -> Optional[Dict[str, Any]]:
        """The cached table with its live age (``age_s``; ``stale`` past
        two refresh intervals)."""
        if self._routing_cache is None:
            return None
        age = max(0.0, self.clock.monotonic() - self._routing_time)
        body = dict(self._routing_cache)
        body["age_s"] = round(age, 3)
        body["stale"] = age >= 2 * self.refresh_interval
        return body

    # ----------------------------- the write side ----------------------------- #

    async def _post(self, session: Session, url: str, body: Any, params=None) -> tuple:
        """(status, JSON body) of one write POST under the move deadline; a
        body that is not JSON reads as ``{}``."""

        async def go():
            resp = await session.request("POST", url, json=body, params=params)
            try:
                doc = resp.json()
            except Exception:
                doc = {}
            return resp.status, doc

        return await Deadline(MOVE_DEADLINE_S).wait_for(go())

    async def fleet_rebalance(self, dry_run: bool = False, force: bool = False) -> Dict[str, Any]:
        """POST every replica's ``/rebalance`` (``dry_run`` previews) and
        report each verdict; one replica's failure (its swap rolled back)
        does not stop the others'."""
        urls = [u + "/rebalance" for u in self._replica_prefixes()]
        params = {"dry_run": "1"} if dry_run else None
        payload = {"force": True} if force else {}
        async with Session(timeout=MOVE_TIMEOUT_S) as session:

            async def post(url):
                try:
                    return await self._post(session, url, payload, params=params)
                except asyncio.CancelledError:
                    raise
                except Exception as exc:
                    logger.warning("rebalance failed for %s: %s", url, exc)
                    return None, {"error": f"{type(exc).__name__}: {exc}"}

            results = list(await asyncio.gather(*(post(u) for u in urls)))
        replicas = []
        for i, (status, body) in enumerate(results):
            body = body if isinstance(body, dict) else {}
            replicas.append({
                "replica": i,
                "reached": status is not None,
                "status": status,
                "applied": bool(body.get("applied")),
                "rolled_back": bool(body.get("rolled_back")),
                "generation": (body.get("swap") or {}).get("generation", body.get("generation")),
                "reason": (body.get("plan") or {}).get("reason") or body.get("error"),
            })
        return {"dry_run": dry_run, "force": force, "applied": sum(1 for r in replicas if r["applied"]),
                "replicas": replicas}

    def _bump_routing_owner(self, member: str, dst: int) -> None:
        """Pin ``member`` to ``dst`` in the live table, between a move's
        acquire and release, and step the version: the table routes to the
        destination before the source stops answering. The content key is
        the pinned table's, so a clean move steps the version once."""
        self._routing_overrides[member] = dst
        if self._routing_cache is not None:
            members = dict(self._routing_cache["members"])
            if members.get(member) != dst:
                members[member] = dst
                self._routing_version += 1
                self._routing_core = self._routing_content_key(
                    members, self._routing_cache["replicas"], self._routing_cache["migrating"])
                self._routing_cache = {**self._routing_cache, "members": members, "version": self._routing_version}

    async def _replica_health_for_moves(self) -> Dict[int, str]:
        """Each replica's status as a move destination: the routing table's
        (``unreachable`` when dark), ``burning`` when its SLO rollup shows a
        fast burn."""
        table = await self.routing()
        health: Dict[int, str] = {}
        for rep in (table or {}).get("replicas", []):
            health[rep["replica"]] = rep["status"] if rep["reachable"] else "unreachable"
        try:
            slo = await self.fleet_slo()
        except Exception:
            return health
        for entry in slo.get("replicas", []):
            worst = entry.get("worst") or {}
            if isinstance(worst, dict) and worst.get("fast_burn"):
                health[entry["replica"]] = "burning"
        return health

    async def fleet_loads(self) -> Dict[str, float]:
        """Each member's routed rows over its replicas' decision windows:
        every replica's ``/placement`` ``member_rows``, summed by member."""
        urls = [p + "/placement" for p in self._replica_prefixes()]
        loads: Dict[str, float] = {}
        async with Session(timeout=REQUEST_TIMEOUT_S) as session:
            bodies = await asyncio.gather(*(self._get_json(session, u) for u in urls))
        for body in bodies:
            if not isinstance(body, dict):
                continue
            for name, rows in (body.get("member_rows") or {}).items():
                try:
                    loads[name] = loads.get(name, 0.0) + float(rows)
                except (TypeError, ValueError):
                    continue
        return loads

    async def apply_move(self, member: str, dst: int, src: Optional[int] = None) -> Dict[str, Any]:
        """One migration, with no window in which a routed request can get a
        404: acquire on ``dst`` (shipping the artifact from ``src`` when it
        is reachable), pin the routing to ``dst``, then release on ``src``
        (skipped when unreachable). Serialized with other moves."""
        async with self._migration_lock:
            table = await self.routing(refresh=True)
            if table is None:
                return {"moved": False, "member": member, "error": "no routing table (no replicas observed)"}
            replicas = table["replicas"]
            if not 0 <= dst < len(replicas):
                return {"moved": False, "member": member, "error": f"unknown destination replica {dst}"}
            if src is None:
                src = table["members"].get(member)
            if src == dst:
                return {"moved": False, "member": member, "src": src, "dst": dst,
                        "error": "member already at destination"}
            prefixes = self._replica_prefixes()
            src_rep = replicas[src] if src is not None and 0 <= src < len(replicas) else None
            src_reachable = bool(src_rep and src_rep["reachable"])
            payload: Dict[str, Any] = {"member": member}
            if src_reachable:
                payload["source"] = src_rep["url"]
            verdict: Dict[str, Any] = {"member": member, "src": src, "dst": dst}
            async with Session(timeout=MOVE_TIMEOUT_S) as session:

                def failed(error: str) -> Dict[str, Any]:
                    self._migrations_failed += 1
                    verdict.update(moved=False, error=error)
                    self.events.emit("mesh.migrate_failed", severity="error", member=member, dst=dst, error=error)
                    return verdict

                try:
                    status, body = await self._post(session, prefixes[dst] + "/mesh/acquire", payload)
                except Exception as exc:
                    return failed(f"acquire failed: {type(exc).__name__}: {exc}")
                verdict["acquire"] = {"status": status, "swap": body.get("swap"),
                                      "already_owned": bool(body.get("already_owned"))}
                if status != 200:
                    return failed(f"acquire answered {status}: {body.get('error')}")
                # the destination owns it: the routing flips before the release
                self._bump_routing_owner(member, dst)
                if src is not None and src_reachable:
                    try:
                        status, body = await self._post(session, prefixes[src] + "/mesh/release", {"member": member})
                        verdict["release"] = {"status": status, "swap": body.get("swap")}
                        if status != 200:
                            verdict["warning"] = (f"release answered {status}: {body.get('error')} "
                                                  "(member dual-owned until retried)")
                    except Exception as exc:
                        verdict["warning"] = (f"release failed: {type(exc).__name__}: {exc} "
                                              "(member dual-owned until retried)")
                else:
                    verdict["release"] = {"skipped": "source unreachable"}
            self._migrations_total += 1
            await self.routing(refresh=True)
            verdict.update(moved=True, routing_version=self._routing_version)
            self.events.emit("mesh.migrate", member=member, src=src, dst=dst, dual_owned="warning" in verdict)
            return verdict

    async def fleet_rebalance_cross(self, dry_run: bool = False, force: bool = False) -> Dict[str, Any]:
        """The fleet tier: observe ownership and loads, plan moves with
        ``plan_fleet`` (never onto a degraded, dark or burning replica) and
        apply them one by one through :meth:`apply_move`; a move that fails
        stops the rest. ``force`` overrides the threshold and the min-rows
        floor, never the health gates."""
        await self.routing(refresh=True)
        members_by_replica = dict(self._routing_member_lists)
        loads, health = await asyncio.gather(self.fleet_loads(), self._replica_health_for_moves())
        plan = plan_fleet(members_by_replica, loads, replica_health=health,
                          min_rows=0 if force else self.mesh_min_rows)
        applicable = plan.should_apply or (force and bool(plan.moves))
        if dry_run or not applicable:
            return {"applied": 0, "dry_run": dry_run, "plan": plan.summary(),
                    "routing_version": self._routing_version}
        verdicts = []
        applied = 0
        for move in plan.moves:
            verdict = await self.apply_move(move.member, move.dst, src=move.src)
            verdicts.append(verdict)
            if not verdict.get("moved"):
                break
            applied += 1
        return {"applied": applied, "dry_run": False, "forced": force and not plan.should_apply,
                "plan": plan.summary(), "moves": verdicts, "routing_version": self._routing_version}

    async def fleet_slow_traces(self, per_replica: int = 5) -> Dict[str, Any]:
        """Each replica's slowest recent traces (its ``/traces/slow``) and
        the fleet's ``worst`` list merged across replicas, slowest first."""
        async with Session(timeout=REQUEST_TIMEOUT_S) as session:
            bodies = await asyncio.gather(*(_bounded_get(session, u, {"n": str(per_replica)}, "trace scrape")
                                            for u in self._trace_urls()))
        replicas: List[Dict[str, Any]] = []
        worst: List[Dict[str, Any]] = []
        for i, body in enumerate(bodies):
            entry: Dict[str, Any] = {"replica": i, "scraped": body is not None,
                                     "tracing_enabled": bool(body and body.get("enabled"))}
            if body and body.get("enabled"):
                traces = body.get("traces") or []
                entry["traces"] = traces
                for t in traces:
                    if not isinstance(t, dict):
                        continue
                    worst.append({"replica": i, **{k: t.get(k) for k in (
                        "trace_id", "name", "request_id", "duration_ms", "error")}})
            replicas.append(entry)
        worst.sort(key=lambda t: -(t.get("duration_ms") or 0.0))
        return {"replicas": replicas, "worst": worst[: max(per_replica, 10)]}

    async def snapshot(self) -> Dict[str, Any]:
        """The health snapshot, cached for ``refresh_interval``. A refresh
        that fails serves the last good snapshot stamped ``stale`` (and
        retries on the next request); with none, an empty one naming the
        error."""
        async with self._lock:
            now = self.clock.monotonic()
            if self._cache is not None and now - self._cache_time < self.refresh_interval:
                return self._cache
            try:
                _FP_SNAPSHOT.fire()
                return await self._refresh_snapshot(now)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                if self._cache is not None:
                    age = now - self._cache_time
                    logger.error("watchman snapshot refresh failed (%s); serving last-good snapshot (%.0fs old)",
                                 exc, age)
                    stale = dict(self._cache)
                    stale["stale"] = True
                    stale["stale_seconds"] = round(age, 1)
                    stale["refresh_error"] = f"{type(exc).__name__}: {exc}"
                    return stale
                logger.error("watchman snapshot refresh failed with no last-good snapshot to serve", exc_info=True)
                return {"project_name": self.project, "gordo-watchman-version": __version__, "endpoints": [],
                        "error": f"{type(exc).__name__}: {exc}"}

    async def _refresh_snapshot(self, now: float) -> Dict[str, Any]:
        """One snapshot refresh (under ``self._lock``): ``metadata-all``
        and ``/stats`` together, else ``/models`` and a poll a target."""
        sem = asyncio.Semaphore(self.parallelism)
        async with Session(timeout=REQUEST_TIMEOUT_S) as session:
            batched = await self._fetch_metadata_all(session)
            if batched is not None:
                (endpoints, bank), stats = await asyncio.gather(
                    self._snapshot_from_batched(session, sem, batched), self._fetch_stats(session))
                return await self._finish_snapshot(endpoints, bank, now, stats)

            async def fetch_models(deadline: Optional[float] = None):
                async def get():
                    resp = await session.get(f"{self.base_url}/gordo/v0/{self.project}/models")
                    return resp.json()

                if deadline is None:
                    return await get()
                return await Deadline(deadline).wait_for(get())

            bank = None
            targets = self.targets
            if targets is None:
                try:
                    body = await fetch_models()
                    bank = body.get("bank")
                    targets = body["models"]
                except Exception as exc:
                    logger.warning("target discovery failed: %s", exc)
                    targets = []
                results = await asyncio.gather(*(self._check_target(session, sem, t) for t in targets))
            else:
                # the bank coverage is decoration: under its own deadline,
                # beside the health polls
                results, models_body = await asyncio.gather(
                    asyncio.gather(*(self._check_target(session, sem, t) for t in targets)),
                    fetch_models(deadline=SCRAPE_DEADLINE_S), return_exceptions=True)
                if isinstance(results, BaseException):
                    raise results
                if isinstance(models_body, BaseException):
                    logger.debug("bank coverage fetch failed: %s", models_body)
                else:
                    bank = models_body.get("bank")
        return await self._finish_snapshot(list(results), bank, now)

    async def _snapshot_from_batched(self, session: Session, sem: asyncio.Semaphore, batched: Dict[str, Any]) -> tuple:
        """Endpoint entries from one ``metadata-all`` answer; an explicit
        target the collection does not know is polled on its own."""
        tmap = batched.get("targets", {})
        targets = self.targets if self.targets is not None else sorted(tmap)
        by_target: Dict[str, Dict[str, Any]] = {}
        missing = []
        for t in targets:
            if t in tmap:
                entry = {"endpoint": f"/gordo/v0/{self.project}/{t}/", "target": t,
                         "healthy": bool(tmap[t].get("healthy", False))}
                for key in ("endpoint-metadata", "digest"):
                    if key in tmap[t]:
                        entry[key] = tmap[t][key]
                by_target[t] = entry
            else:
                missing.append(t)
        if missing:
            polled = await asyncio.gather(*(self._check_target(session, sem, t) for t in missing))
            by_target.update({e["target"]: e for e in polled})
        return [by_target[t] for t in targets], batched.get("bank")

    async def _finish_snapshot(self, endpoints: List[Dict[str, Any]], bank, now: float,
                               stats: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """The snapshot's tail (under ``self._lock``): bank coverage on each
        endpoint, the gang heartbeats, the cache commit."""
        if bank is not None:
            banked = set(bank.get("banked", []))
            fallback = bank.get("fallback", {})
            for entry in endpoints:
                t = entry["target"]
                if t in banked:
                    entry["banked"] = True
                elif t in fallback:
                    entry["banked"] = False
                    entry["bank-fallback-reason"] = fallback[t]
                else:
                    entry["banked"] = None  # not known to the collection
        cache = {"project_name": self.project, "gordo-watchman-version": __version__, "endpoints": endpoints}
        if bank is not None:
            cache["bank"] = bank
        if stats is not None:
            cache["server-stats"] = stats
        if self.gang_state_dir:
            cache["gangs"] = await asyncio.get_running_loop().run_in_executor(
                None, read_gang_states, self.gang_state_dir, self.gang_stale_after)
        self._cache = cache
        self._cache_time = now
        return cache


def _flag(query: Dict[str, str], name: str) -> bool:
    return query.get(name, "").lower() in _TRUE


def _force(raw: bytes) -> bool:
    """A write body's ``force``: False unless it is a JSON object saying so."""
    try:
        body = json.loads(raw) if raw else None
    except ValueError:
        return False
    return bool(body.get("force", False)) if isinstance(body, dict) else False


def _q_float(query: Dict[str, str], name: str) -> Optional[float]:
    raw = query.get(name)
    if raw is None or raw == "":
        return None
    try:
        return float(raw)
    except ValueError:
        raise HTTPError(400, f"{name} must be a number") from None


class WatchmanApp:
    """A :class:`WatchmanState` and the event loop that runs it, on a
    daemon thread; :meth:`handle` answers one request from any thread."""

    def __init__(self, state: WatchmanState):
        self.state = state
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever, name="gordo-watchman-loop", daemon=True)
        self._thread.start()
        self._routes = {
            "/": self.root, "/healthcheck": self.healthcheck, "/metrics": self.metrics, "/traces": self.traces,
            "/slo": self.slo, "/drift": self.drift, "/heat": self.heat, "/costs": self.costs,
            "/history": self.history, "/events": self.events, "/incidents": self.incidents,
            "/routing": self.routing_view,
        }
        self._write_routes = {"/rebalance": self.rebalance, "/migrate": self.migrate,
                              "/fleet-rebalance": self.fleet_rebalance_cross}

    def run(self, coro):
        """Run ``coro`` on the app's loop and wait for its result."""
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result()

    def handle(self, method: str, path: str, query: Dict[str, str], headers, body: bytes = b"") -> tuple:
        """(status, body, content type, extra headers) of one request (its
        body, ``body``, read by the handler); the answer's body is bytes
        (None for a 304)."""
        write = self._write_routes.get(path)
        if write is not None:
            if method != "POST":
                return _json_answer(405, {"error": f"{method} not allowed on {path}"})
            try:
                return self.run(write(query, body))
            except HTTPError as exc:
                return _json_answer(exc.status, exc.body)
        route = self._routes.get(path)
        if route is None:
            return _json_answer(404, {"error": f"No route for {path}"})
        if method != "GET":
            return _json_answer(405, {"error": f"{method} not allowed on {path}"})
        try:
            return self.run(route(query, headers))
        except HTTPError as exc:
            return _json_answer(exc.status, exc.body)

    def close(self) -> None:
        """Cancel the loop's pending refreshes and stop it."""
        if self._thread.is_alive():

            async def cancel_pending():
                pending = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
                for task in pending:
                    task.cancel()
                await asyncio.gather(*pending, return_exceptions=True)

            try:
                asyncio.run_coroutine_threadsafe(cancel_pending(), self.loop).result(10)
            except Exception as exc:
                logger.debug("watchman loop did not settle: %s", exc)
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(10)
        if not self._thread.is_alive() and not self.loop.is_closed():
            self.loop.close()

    # ----------------------------- routes ------------------------------ #

    async def root(self, query, headers):
        """The snapshot, with the replicas (and the routing table's version
        and age), a bounded ``fleet-metrics`` summary and the streaming
        drift (``degraded`` with its reason), none of them waited for."""
        state = self.state
        body = dict(await state.snapshot())  # a copy: the cache stays clean
        table = await state.routing(wait=False)
        if table is not None:
            body["replicas"] = [
                {"replica": rep["replica"], "url": rep["url"], "routing_version": table["version"],
                 "routing_age_s": table["age_s"], "status": rep["status"], "reachable": rep["reachable"]}
                for rep in table["replicas"]
            ]
            body["routing"] = {"version": table["version"], "age_s": table["age_s"], "stale": table["stale"],
                               "members": len(table["members"]), "migrating": len(table["migrating"])}
        else:  # no observation yet: the configured targets
            body["replicas"] = [{"replica": i, "url": url} for i, url in enumerate(state.replica_base_urls())]
        agg = await state.fleet_metrics(wait=False)
        last_success = (agg or {}).get("replica_last_success") or []
        if agg is not None and (agg["replicas_scraped"] or any(t is not None for t in last_success)):
            body["fleet-metrics"] = {
                "replicas_scraped": agg["replicas_scraped"],
                "shard_skew_ratio": agg["shard_skew_ratio"],
                "skew_window": agg["skew_window"],
                "routed_rows_by_shard": agg["routed_rows_by_shard"],
                "scrape_stale_seconds": {str(i): round(max(0.0, state.clock.monotonic() - ts), 1)
                                         for i, ts in enumerate(last_success) if ts is not None},
            }
        drift = await state.fleet_drift(wait=False)
        if drift is not None and drift["replicas_streaming"]:
            body["streaming"] = {"drifted": drift["drifted"], "worst": drift["worst"],
                                 "max_staleness_seconds": drift["max_staleness_seconds"],
                                 "stale_degraded": drift["stale_degraded"]}
            if drift["stale_degraded"] or drift["drifted"]:
                body["status"] = "degraded"
                body["degraded_reason"] = (
                    "model staleness above GORDO_STALENESS_DEGRADED_S" if drift["stale_degraded"]
                    else f"{len(drift['drifted'])} member(s) drifted")
        return _json_answer(200, body)

    async def healthcheck(self, query, headers):
        return _json_answer(200, {"gordo-watchman-version": __version__})

    async def metrics(self, query, headers):
        """The fleet rollup as Prometheus text; it waits for a scrape only
        when there is no rollup yet, then serves the cache and refreshes in
        the background."""
        state = self.state
        agg = await state.fleet_metrics(wait=state._metrics_cache is None)
        if agg is None:  # the first scrape's race: an empty rollup
            agg = aggregate_fleet_metrics([])
        extra = []
        if state._routing_cache is not None or state._migrations_total:
            extra = [
                ("gordo_fleet_routing_version", "gauge",
                 "Routing-table version (bumps iff table content changed: ownership, health, or migration overlap)",
                 {}, state._routing_version),
                ("gordo_fleet_migrations_total", "counter",
                 "Cross-replica migrations whose ownership flipped (destination acquired + routing repointed); a "
                 "failed release leaves the member dual-owned — visible in the routing table's `migrating` map, "
                 "not here", {}, state._migrations_total),
                ("gordo_fleet_migrations_failed_total", "counter",
                 "Cross-replica migrations that failed at the acquire step (ownership unchanged)", {},
                 state._migrations_failed),
            ]
        text = render_fleet_metrics(agg, now_mono=state.clock.monotonic(), extra_gauges=extra)
        return 200, text.encode("utf-8"), METRICS_CONTENT_TYPE, {}

    async def traces(self, query, headers):
        try:
            per_replica = int(query.get("n", "5"))
        except ValueError:
            per_replica = -1
        if per_replica < 1:
            raise HTTPError(400, "n must be a positive integer")
        return _json_answer(200, await self.state.fleet_slow_traces(per_replica=per_replica))

    async def slo(self, query, headers):
        return _json_answer(200, await self.state.fleet_slo(refresh=_flag(query, "refresh")))

    async def drift(self, query, headers):
        return _json_answer(200, await self.state.fleet_drift(refresh=_flag(query, "refresh")))

    async def heat(self, query, headers):
        top = _q_float(query, "top")
        return _json_answer(200, await self.state.fleet_heat(top_n=10 if top is None else int(top),
                                                             refresh=_flag(query, "refresh")))

    async def costs(self, query, headers):
        return _json_answer(200, await self.state.fleet_costs(refresh=_flag(query, "refresh")))

    async def history(self, query, headers):
        raw = query.get("series")
        series = [s for s in raw.split(",") if s] if raw else None
        return _json_answer(200, await self.state.fleet_history(
            series=series, since=_q_float(query, "since"), until=_q_float(query, "until"),
            step=_q_float(query, "step")))

    async def events(self, query, headers):
        raw_types = query.get("type")
        types = [t for t in raw_types.split(",") if t] if raw_types else None
        raw_limit = query.get("limit")
        try:
            limit = int(raw_limit) if raw_limit else None
        except ValueError:
            raise HTTPError(400, "limit must be an integer") from None
        return _json_answer(200, await self.state.fleet_events(
            since_wall=_q_float(query, "since_wall"), types=types, limit=limit))

    async def incidents(self, query, headers):
        return _json_answer(200, await self.state.fleet_incidents(
            threshold=_q_float(query, "threshold"), margin_s=_q_float(query, "margin")))

    async def rebalance(self, query, raw: bytes):
        """Fan ``POST /rebalance`` out to every replica (``?dry_run=1``,
        body ``{"force": true}``) and report each verdict."""
        return _json_answer(200, await self.state.fleet_rebalance(dry_run=_flag(query, "dry_run"),
                                                                  force=_force(raw)))

    async def migrate(self, query, raw: bytes):
        """One member's move: body ``{"member": name, "to": replica}`` (and
        ``"from"``); 200 when it moved, 409 when it did not."""
        try:
            body = json.loads(raw) if raw else None
        except ValueError:
            body = None
        if not isinstance(body, dict) or not isinstance(body.get("member"), str) or not isinstance(body.get("to"), int):
            raise HTTPError(400, 'expected {"member": "<name>", "to": <replica index>}')
        src = body.get("from")
        if src is not None and not isinstance(src, int):
            raise HTTPError(400, "from must be a replica index")
        verdict = await self.state.apply_move(body["member"], body["to"], src=src)
        return _json_answer(200 if verdict.get("moved") else 409, verdict)

    async def fleet_rebalance_cross(self, query, raw: bytes):
        """Plan cross-replica moves from the replicas' loads (``?dry_run=1``
        previews, ``{"force": true}`` overrides the threshold and min-rows
        gates, never the health ones) and apply them."""
        return _json_answer(200, await self.state.fleet_rebalance_cross(dry_run=_flag(query, "dry_run"),
                                                                        force=_force(raw)))

    async def routing_view(self, query, headers):
        """The routing table under its ``ETag``; ``If-None-Match`` equal to
        it answers 304 without a body. No replica observed yet is an empty
        version-0 table, not an error."""
        state = self.state
        table = await state.routing(refresh=_flag(query, "refresh"))
        if table is None:
            table = {"project": state.project, "version": 0, "members": {}, "migrating": {}, "replicas": [],
                     "age_s": None, "stale": True, "refresh_interval": state.refresh_interval}
        etag = f'"routing-v{table["version"]}"'
        if headers.get("If-None-Match") == etag:
            return 304, None, None, {"ETag": etag}
        status, body, ctype, _ = _json_answer(200, table)
        return status, body, ctype, {"ETag": etag}


def _json_answer(status: int, body: Any) -> tuple:
    return status, json.dumps(body).encode(), "application/json", {}


class _WatchmanHandler(BaseHTTPRequestHandler):
    server_version = f"gordo-watchman-torch/{__version__}"

    def log_message(self, fmt, *args):
        logger.debug("%s " + fmt, self.client_address[0], *args)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def _dispatch(self, method: str) -> None:
        path, _, raw_query = self.path.partition("?")
        query: Dict[str, str] = {}
        for key, value in parse_qsl(raw_query, keep_blank_values=True):
            query.setdefault(key, value)  # a repeated key reads its first value, as aiohttp's query
        length = int(self.headers.get("Content-Length") or 0)
        # read whole: an unread body would turn the close into a reset
        raw = self.rfile.read(length) if length > 0 else b""
        try:
            status, body, ctype, extra = self.server.app.handle(method, path, query, self.headers, raw)
        except Exception:
            logger.exception("unhandled error serving %s %s", method, path)
            status, body, ctype, extra = _json_answer(500, {"error": "internal server error"})
        self.send_response(status)
        if body is not None:
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
        for k, v in extra.items():
            self.send_header(k, v)
        self.end_headers()
        if body is not None:
            self.wfile.write(body)


class WatchmanServer(ThreadingHTTPServer):
    """A :class:`WatchmanApp` behind a threading HTTP server."""

    daemon_threads = True

    def __init__(self, app: WatchmanApp, host: str, port: int):
        self.app = app
        self._thread: Optional[threading.Thread] = None
        super().__init__((host, port), _WatchmanHandler)

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"

    @property
    def state(self) -> WatchmanState:
        return self.app.state

    def start(self) -> "WatchmanServer":
        """Serve on a background thread; :meth:`close` stops it."""
        self._thread = threading.Thread(target=self.serve_forever, kwargs={"poll_interval": 0.05},
                                        name="gordo-watchman-http", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop serving, close the socket and stop the app's loop."""
        if self._thread is not None:
            self.shutdown()
            self._thread.join()
            self._thread = None
        self.server_close()
        self.app.close()


def build_watchman_app(
    project: str,
    base_url: str,
    targets: Optional[List[str]] = None,
    refresh_interval: float = 30.0,
    gang_state_dir: Optional[str] = None,
    full_metadata: bool = False,
    metrics_urls: Optional[List[str]] = None,
    clock=None,
) -> WatchmanApp:
    """The watchman's state on a running loop of its own (JAX
    ``build_watchman_app``'s arguments)."""
    state = WatchmanState(project, base_url, targets, refresh_interval, gang_state_dir=gang_state_dir,
                          full_metadata=full_metadata, metrics_urls=metrics_urls, clock=clock)
    return WatchmanApp(state)


def run_watchman(
    project: str,
    base_url: str,
    targets: Optional[List[str]] = None,
    host: str = "0.0.0.0",
    port: int = 5556,
    refresh_interval: float = 30.0,
    gang_state_dir: Optional[str] = None,
    full_metadata: bool = False,
    metrics_urls: Optional[List[str]] = None,
    clock=None,
    background: bool = False,
):
    """Serve the watchman on ``host:port`` (``port=0`` picks a free one).
    Blocks until interrupted, or with ``background=True`` returns the
    running :class:`WatchmanServer` (its ``url``, its ``state``; its
    ``close()`` stops it). ``metrics_urls`` lists the replicas' ``/metrics``
    (default the one server at ``base_url``)."""
    app = build_watchman_app(project, base_url, targets, refresh_interval, gang_state_dir=gang_state_dir,
                             full_metadata=full_metadata, metrics_urls=metrics_urls, clock=clock)
    try:
        server = WatchmanServer(app, host, port)
    except BaseException:
        app.close()
        raise
    if background:
        return server.start()
    try:
        server.serve_forever()
    finally:
        server.close()
    return None
