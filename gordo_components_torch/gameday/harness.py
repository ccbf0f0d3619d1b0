"""The game-day harness: a real multi-process mesh, broken on purpose.

:class:`GamedayMesh` boots N serving replicas as REAL subprocesses
(``gameday/replica.py`` child entry) plus a live in-process watchman on a
real TCP port, then the scenario runners in this module inject the
catalog's failures and collect the evidence ``scenarios.py`` judges:

- process-level faults: SIGKILL + respawn (crash/restart, herd);
- transport-level faults: the blackhole/refuse/reset kinds
  (``resilience/faults.py``), armed in-process for the watchman side
  (``watchman.probe``) and over the subprocess boundary via
  ``GORDO_FAULTS`` for the replica side (``server.connection``,
  ``engine.queue`` latency);
- data-level faults: correlated mean-shift drift through the streaming
  ingest plane.

Everything is judged through public surfaces only — the watchman
routing table, ``/slo`` rollup, fleet ``/events``, the replica drift
views and the bulk client's own counters — because that is what a real
operator (and the incident correlator) would see.

Counterpart of ``gordo_components_tpu/gameday/harness.py``: the same
shapes, drills, evidence and run document. The replicas serve on
``device`` (the card unless the caller asks for the CPU, which the child
is then told with ``--device cpu``); the harness's HTTP rides the port's
``client/http.Session`` where the JAX harness rides aiohttp, and the
watchman is ``run_watchman(background=True)`` (a threading HTTP server
with its own event loop) where the JAX harness runs an aiohttp app on
the caller's loop. :func:`run_gameday` stays a coroutine.
"""

import asyncio
import json
import logging
import os
import random
import signal
import socket
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from gordo_components_torch.client.http import Session
from gordo_components_torch.gameday.scenarios import SCENARIOS

logger = logging.getLogger(__name__)

__all__ = [
    "GamedayMesh",
    "RUNNERS",
    "build_fleet_artifacts",
    "render_verdict_table",
    "run_gameday",
]

N_FEATURES = 8
GAMEDAY_SCHEMA = "gordo.gameday-run/v1"
# the mesh shapes in boot order: every scenario declares which one it
# needs, and run_gameday boots each shape at most once per run
SHAPE_ORDER = ("partitioned", "replicated", "qos", "push", "streaming")
REPLICA_MODULE = "gordo_components_torch.gameday.replica"
# the bulk drills' time range: 80 minutes at the fallback dataset's 1 min
SPAN = ("2020-01-01T00:00:00Z", "2020-01-01T01:20:00Z")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_fleet_artifacts(
    root: str, n_members: int = 4, n_features: int = N_FEATURES, device="cuda"
) -> List[str]:
    """Train a small anomaly fleet into ``root`` (one artifact dir per
    member) — the shared-volume deploy shape every replica boots from."""
    import numpy as np

    from gordo_components_torch import serializer
    from gordo_components_torch.models import AutoEncoder, DiffBasedAnomalyDetector

    rng = np.random.RandomState(0)
    X = rng.rand(256, n_features).astype("float32")
    names = []
    for i in range(n_members):
        det = DiffBasedAnomalyDetector(
            base_estimator=AutoEncoder(epochs=1, batch_size=128, device=device)
        )
        det.fit(X + 0.01 * i)
        name = f"gd-{i}"
        serializer.dump(det, os.path.join(root, name), metadata={"name": name})
        names.append(name)
    return names


def scoring_body(n_features: int = N_FEATURES, rows: int = 16, seed: int = 1):
    import numpy as np

    from gordo_components_torch.utils.wire import pack_frames

    X = np.random.RandomState(seed).rand(rows, n_features).astype("float32")
    return pack_frames([("X", X)])


class GamedayMesh:
    """N server subprocesses over one artifact dir + a live watchman.

    ``replica_env`` maps replica index -> extra environment for THAT
    subprocess (per-replica fault injection: ``GORDO_FAULTS`` rides
    here); ``common_env`` applies to every replica. ``partitioned``
    boots the deterministic member partition (each replica owns a
    slice); off, every replica loads the full collection (the
    replicated shape hedging needs). ``device`` is where the replicas
    serve (``"cuda"``, the default, or ``"cpu"``)."""

    def __init__(
        self,
        root: str,
        members: List[str],
        project: str = "gameday",
        n_replicas: int = 2,
        partitioned: bool = True,
        refresh_interval: float = 0.5,
        common_env: Optional[Dict[str, str]] = None,
        replica_env: Optional[Dict[int, Dict[str, str]]] = None,
        device="cuda",
    ):
        self.root = root
        self.members = list(members)
        self.project = project
        self.n_replicas = int(n_replicas)
        self.partitioned = bool(partitioned)
        self.refresh_interval = float(refresh_interval)
        self.common_env = dict(common_env or {})
        self.replica_env = {
            int(k): dict(v) for k, v in (replica_env or {}).items()
        }
        self.device = str(device)
        self.ports: List[int] = []
        self.procs: List[Optional[subprocess.Popen]] = []
        self.base_urls: List[str] = []
        self.wm_url: Optional[str] = None
        self._wm = None
        self.session: Optional[Session] = None  # shared session (control plane)

    # ------------------------------ lifecycle ----------------------- #

    def _child_env(self, index: int) -> Dict[str, str]:
        env = dict(os.environ)
        env.setdefault("GORDO_SERVER_WARMUP", "0")
        for key in ("GORDO_MESH_REPLICA_ID", "GORDO_MESH_REPLICAS",
                    "GORDO_FAULTS"):
            env.pop(key, None)
        if self.partitioned and self.n_replicas > 1:
            env["GORDO_MESH_REPLICA_ID"] = str(index)
            env["GORDO_MESH_REPLICAS"] = str(self.n_replicas)
        env.update(self.common_env)
        env.update(self.replica_env.get(index, {}))
        return env

    def _spawn(self, index: int) -> subprocess.Popen:
        return subprocess.Popen(
            [
                sys.executable, "-m", REPLICA_MODULE,
                "--root", self.root, "--port", str(self.ports[index]),
                "--device", self.device,
            ],
            env=self._child_env(index),
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )

    async def wait_ready(self, index: int, timeout: float = 240.0) -> None:
        url = (
            f"{self.base_urls[index]}/gordo/v0/{self.project}/ready"
        )
        deadline = time.monotonic() + timeout
        async with Session(timeout=3) as session:
            while time.monotonic() < deadline:
                try:
                    resp = await session.get(url)
                    if resp.status == 200:
                        return
                except asyncio.CancelledError:
                    raise
                except Exception:
                    pass
                await asyncio.sleep(0.25)
        raise RuntimeError(
            f"replica {index} (port {self.ports[index]}) never became ready"
        )

    async def start(self) -> "GamedayMesh":
        from gordo_components_torch.watchman import run_watchman

        self.ports = [free_port() for _ in range(self.n_replicas)]
        self.base_urls = [f"http://127.0.0.1:{p}" for p in self.ports]
        self.procs = [self._spawn(i) for i in range(self.n_replicas)]
        await asyncio.gather(
            *(self.wait_ready(i) for i in range(self.n_replicas))
        )
        self._wm = run_watchman(
            self.project,
            self.base_urls[0],
            host="127.0.0.1",
            port=0,
            refresh_interval=self.refresh_interval,
            metrics_urls=[
                b + f"/gordo/v0/{self.project}/metrics"
                for b in self.base_urls
            ],
            background=True,
        )
        self.wm_url = self._wm.url
        self.session = Session(timeout=30)
        # prime the routing table so every scenario starts from an
        # observed, versioned fleet
        await self.routing(refresh=True)
        return self

    async def stop(self) -> None:
        if self.session is not None:
            await self.session.close()
            self.session = None
        if self._wm is not None:
            self._wm.close()
            self._wm = None
        for proc in self.procs:
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in self.procs:
            if proc is None:
                continue
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()

    async def __aenter__(self) -> "GamedayMesh":
        try:
            return await self.start()
        except BaseException:
            await self.stop()
            raise

    async def __aexit__(self, *exc_info) -> None:
        await self.stop()

    # ------------------------- process faults ----------------------- #

    def kill_replica(self, index: int, sig: int = signal.SIGKILL) -> None:
        proc = self.procs[index]
        if proc is not None and proc.poll() is None:
            proc.send_signal(sig)
            proc.wait(timeout=20)

    async def respawn_replica(self, index: int) -> None:
        self.procs[index] = self._spawn(index)
        await self.wait_ready(index)

    # ------------------------ observability taps -------------------- #

    async def wm_json(self, path: str, params=None) -> Any:
        resp = await self.session.get(self.wm_url + path, params=params)
        return resp.json()

    async def routing(self, refresh: bool = False) -> Dict[str, Any]:
        return await self.wm_json(
            "/routing", params={"refresh": "1"} if refresh else None
        )

    async def events_since(self, wall: float) -> List[Dict[str, Any]]:
        body = await self.wm_json("/events", params={"limit": "500"})
        return [
            e for e in body.get("events", [])
            if isinstance(e, dict) and float(e.get("wall") or 0) >= wall
        ]

    async def wait_until(
        self,
        predicate: Callable[[Dict[str, Any]], bool],
        timeout: float = 30.0,
        interval: float = 0.4,
        refresh: bool = True,
    ) -> Optional[float]:
        """Poll the routing table until ``predicate(table)``; returns
        elapsed seconds, or None on timeout (the caller's 'detected'
        flag — a drill that times out fails its bound, not the run)."""
        t0 = time.monotonic()
        deadline = t0 + timeout
        while time.monotonic() < deadline:
            try:
                table = await self.routing(refresh=refresh)
                if table and predicate(table):
                    return time.monotonic() - t0
            except asyncio.CancelledError:
                raise
            except Exception:
                pass
            await asyncio.sleep(interval)
        return None

    def score_url(self, base: str, member: str) -> str:
        return (
            f"{base}/gordo/v0/{self.project}/{member}/anomaly/prediction"
        )

    async def ingest(
        self, base: str, member: str, rows, timestamps
    ) -> int:
        url = f"{base}/gordo/v0/{self.project}/{member}/ingest"
        resp = await self.session.post(
            url, json={"rows": rows, "timestamps": timestamps}
        )
        return resp.status


def _replica_entry(table: Dict[str, Any], index: int) -> Dict[str, Any]:
    for rep in table.get("replicas", []):
        if rep.get("replica") == index:
            return rep
    return {}


class LoadLoop:
    """Sustained scoring load against the mesh, the way a
    partition-aware client behaves: every round consults the (live or
    frozen) routing table, posts each member's tensor body to its
    owner, and SKIPS members whose owner the table marks unreachable —
    that skip IS the containment the crash scenario judges.

    ``excused_replica`` marks one replica index whose failures are the
    scenario's declared blast radius (the replica being killed);
    failures anywhere else count against the verdict's ``non_200``."""

    def __init__(
        self,
        mesh: GamedayMesh,
        members: List[str],
        interval_s: float = 0.08,
        follow_routing: bool = True,
        rows: int = 16,
    ):
        self.mesh = mesh
        self.members = list(members)
        self.interval_s = float(interval_s)
        self.follow_routing = bool(follow_routing)
        self.body = scoring_body(rows=rows)
        self.statuses: Dict[str, int] = {}
        self.non_200 = 0
        self.excused = 0
        self.skipped = 0
        self.requests = 0
        self.excused_replica: Optional[int] = None
        self._stop = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._frozen: Optional[Dict[str, Any]] = None

    async def _round(self, session: Session, table: Dict[str, Any]) -> None:
        from gordo_components_torch.utils.wire import TENSOR_CONTENT_TYPE

        members_map = table.get("members", {})
        replicas = {
            r.get("replica"): r for r in table.get("replicas", [])
        }
        for member in self.members:
            owner_idx = members_map.get(member)
            owner = replicas.get(owner_idx)
            if owner is None or not owner.get("reachable"):
                self.skipped += 1
                continue
            status = 599  # transport failure pseudo-status
            try:
                resp = await session.post(
                    self.mesh.score_url(owner["url"], member),
                    data=self.body,
                    headers={"Content-Type": TENSOR_CONTENT_TYPE},
                )
                status = resp.status
            except asyncio.CancelledError:
                raise
            except Exception:
                pass
            self.requests += 1
            key = str(status)
            self.statuses[key] = self.statuses.get(key, 0) + 1
            if status != 200:
                if owner_idx == self.excused_replica:
                    self.excused += 1
                else:
                    self.non_200 += 1

    async def _run(self) -> None:
        async with Session(timeout=15) as session:
            if not self.follow_routing:
                self._frozen = await self.mesh.routing()
            while not self._stop.is_set():
                table = (
                    self._frozen
                    if self._frozen is not None
                    else await self.mesh.routing()
                )
                await self._round(session, table)
                await asyncio.sleep(self.interval_s)

    def start(self) -> "LoadLoop":
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def stop(self) -> None:
        self._stop.set()
        if self._task is not None:
            await self._task


def _fallback_dataset() -> Dict[str, Any]:
    return {
        "type": "RandomDataset",
        "tag_list": [f"t-{j}" for j in range(N_FEATURES)],
        "resolution": "1min",
    }


# --------------------------------------------------------------------- #
# scenario runners: inject -> detect -> contain -> recover -> evidence
# --------------------------------------------------------------------- #


async def _run_replica_crash(mesh: GamedayMesh) -> Dict[str, Any]:
    victim = mesh.n_replicas - 1
    table0 = await mesh.routing(refresh=True)
    v0 = table0["version"]
    loop = LoadLoop(mesh, mesh.members).start()
    await asyncio.sleep(1.0)  # healthy-baseline rounds
    wall_kill = time.time()
    loop.excused_replica = victim
    mesh.kill_replica(victim, signal.SIGKILL)
    detection = await mesh.wait_until(
        lambda t: not _replica_entry(t, victim).get("reachable", True),
        timeout=45.0,
    )
    # a few contained rounds: the table now marks the corpse, so the
    # loop must be skipping its members and everything else stays 200
    await asyncio.sleep(1.0)
    t_respawn = time.monotonic()
    await mesh.respawn_replica(victim)
    healed = await mesh.wait_until(
        lambda t: (
            _replica_entry(t, victim).get("reachable")
            and set(t.get("members", {})) == set(mesh.members)
        ),
        timeout=60.0,
    )
    recovery_s = (
        time.monotonic() - t_respawn if healed is not None else None
    )
    loop.excused_replica = None
    await asyncio.sleep(0.8)  # post-recovery rounds, all replicas live
    await loop.stop()
    table1 = await mesh.routing(refresh=True)
    events = await mesh.events_since(wall_kill - 1.0)
    return {
        "injected": f"SIGKILL replica {victim} under load",
        "detected": detection is not None,
        "detection_latency_s": detection,
        "detection_signal": "routing table reachable=false + version step",
        "non_200": loop.non_200,
        "excused_non200": loop.excused,
        "skipped_while_dark": loop.skipped,
        "requests": loop.requests,
        "statuses": loop.statuses,
        "recovered": healed is not None,
        "recovery_s": recovery_s,
        "routing_version_steps": table1["version"] - v0,
        "events": events,
    }


async def _run_watchman_partition(mesh: GamedayMesh) -> Dict[str, Any]:
    from gordo_components_torch import resilience

    table0 = await mesh.routing(refresh=True)
    v0 = table0["version"]
    # frozen table: the data plane keeps posting to the last-good
    # owners for the whole partition — watchman being dark to the fleet
    # must not take down scoring
    loop = LoadLoop(mesh, mesh.members, follow_routing=False).start()
    await asyncio.sleep(0.8)
    wall_cut = time.time()
    # the transport-level fault kind: every watchman->replica probe is
    # refused, exactly what a network partition looks like from here
    resilience.configure_from_env("watchman.probe=refuse")
    try:
        detection = await mesh.wait_until(
            lambda t: all(
                not r.get("reachable") for r in t.get("replicas", [])
            ),
            timeout=30.0,
        )
    finally:
        resilience.disarm("watchman.probe")
    t_heal = time.monotonic()
    healed = await mesh.wait_until(
        lambda t: all(
            r.get("reachable") for r in t.get("replicas", [])
        )
        and set(t.get("members", {})) == set(mesh.members),
        timeout=30.0,
    )
    recovery_s = time.monotonic() - t_heal if healed is not None else None
    await asyncio.sleep(0.5)
    await loop.stop()
    table1 = await mesh.routing(refresh=True)
    events = await mesh.events_since(wall_cut - 1.0)
    return {
        "injected": "watchman.probe=refuse (watchman<->fleet partition)",
        "detected": detection is not None,
        "detection_latency_s": detection,
        "detection_signal": "all replicas unreachable in the table",
        "non_200": loop.non_200,
        "requests": loop.requests,
        "statuses": loop.statuses,
        "recovered": healed is not None,
        "recovery_s": recovery_s,
        "routing_version_steps": table1["version"] - v0,
        "events": events,
    }


async def _run_migration_storm(mesh: GamedayMesh) -> Dict[str, Any]:
    from gordo_components_torch.client import Client

    table0 = await mesh.routing(refresh=True)
    v0 = table0["version"]
    client = Client(
        mesh.project,
        base_url=mesh.base_urls[0],
        routing_url=mesh.wm_url,
        metadata_fallback_dataset=_fallback_dataset(),
        batch_size=40,
        parallelism=4,
        # shorter than the inter-round gap below: each round's stale-404
        # is ENTITLED to one forced refresh; a window longer than the
        # storm cadence would throttle recovery itself
        routing_refresh_window_s=1.0,
    )
    start, end = SPAN
    errors: List[str] = []
    moves = 0
    # the storm: the same member migrates back and forth, DIRECTLY on
    # the replicas (acquire/release) — watchman's cached table (pinned
    # by the long refresh interval) goes stale each round, so every
    # round the client must detect it via a routed 404, force ONE
    # refresh, and re-post the failed chunks
    victim = sorted(mesh.members)[0]
    for _ in range(3):
        table = await mesh.routing(refresh=True)
        src = table["members"][victim]
        dst = (src + 1) % mesh.n_replicas
        resp = await mesh.session.post(
            f"{mesh.base_urls[dst]}/gordo/v0/{mesh.project}/mesh/acquire",
            json={"member": victim, "source": mesh.base_urls[src]},
        )
        assert resp.status == 200, resp.text()
        resp = await mesh.session.post(
            f"{mesh.base_urls[src]}/gordo/v0/{mesh.project}/mesh/release",
            json={"member": victim},
        )
        assert resp.status == 200, resp.text()
        moves += 1
        results = await client.predict_async(start, end)
        for res in results:
            if not res.ok:
                errors.extend(res.error_messages)
        # let the per-member forced-refresh window lapse before the next
        # round moves the member again
        await asyncio.sleep(1.2)
    table1 = await mesh.routing(refresh=True)
    stats = dict(client._fanout_stats)
    return {
        "injected": f"{moves} direct migrations of {victim!r} behind a "
        "stale watchman cache",
        "detected": stats["reroutes"] > 0,
        "detection_signal": "routed 404 -> forced refresh -> re-post",
        "non_200": len(errors),
        "statuses": {"errors": errors[:5]},
        "reroutes": stats["reroutes"],
        "routing_refreshes": stats["routing_refreshes"],
        "refreshes_throttled": stats["refreshes_throttled"],
        "routed_chunks": stats["routed_chunks"],
        "routing_version_steps": table1["version"] - v0,
        "recovered": True,
        "recovery_s": 0.0,
        "moves": moves,
    }


def _fast_window_burn(slo_body: Dict[str, Any]) -> float:
    """Worst burn over the FAST window ("30s" in the gray-failure mesh)
    across objectives — the decay signal recovery waits on (the slow
    window keeps remembering bad samples for minutes by design)."""
    worst = 0.0
    for obj in slo_body.get("objectives") or []:
        win = (obj.get("windows") or {}).get("30s")
        if win and win.get("burn_rate") is not None:
            worst = max(worst, float(win["burn_rate"]))
    return worst


async def _run_gray_failure(mesh: GamedayMesh) -> Dict[str, Any]:
    from gordo_components_torch.client import Client

    sick = mesh.n_replicas - 1
    client = Client(
        mesh.project,
        base_url=mesh.base_urls[0],
        routing_url=mesh.wm_url,
        metadata_fallback_dataset=_fallback_dataset(),
        batch_size=40,
        parallelism=4,
        hedge=True,
        replica_urls=list(mesh.base_urls),
        hedge_delay_init_s=0.1,
    )
    start, end = SPAN
    errors: List[str] = []
    burn_peak = 0.0
    detection = None
    gray_status = None
    t0 = time.monotonic()
    # containment phase: the hedged client races the sick replica while
    # the fault is live — its wins are the proof traffic routed around
    # the slowness (hedged-away requests get cancelled, so this phase
    # alone cannot be trusted to land latency samples on the replica)
    for _ in range(4):
        results = await client.predict_async(start, end)
        for res in results:
            if not res.ok:
                errors.extend(res.error_messages)
        if client._hedge_stats["hedge_wins"] >= 3:
            break
    # detection phase: a DIRECT (unhedged) load loop — callers that
    # don't hedge ride out the full injected latency, their completions
    # land in the sick replica's latency histogram, and the watchman
    # /slo rollup must attribute the burn to it. The gray replica's own
    # health stays "ok" throughout — that is what makes it gray.
    loop = LoadLoop(
        mesh, mesh.members, follow_routing=False, interval_s=0.15
    ).start()
    deadline = time.monotonic() + 40.0
    while time.monotonic() < deadline:
        slo = await mesh.wm_json("/slo", params={"refresh": "1"})
        worst = slo.get("worst_burn") or {}
        if worst.get("burn_rate") is not None:
            burn_peak = max(burn_peak, float(worst["burn_rate"]))
        if (
            worst.get("replica") == sick
            and float(worst.get("burn_rate") or 0.0) >= 1.0
        ):
            detection = time.monotonic() - t0
            table = await mesh.routing(refresh=True)
            gray_status = _replica_entry(table, sick).get("status")
            break
        await asyncio.sleep(0.5)
    await loop.stop()
    if loop.non_200:
        errors.append(f"direct load saw {loop.non_200} non-200s")
    # recovery phase: the injected fault has a finite budget
    # (GORDO_FAULTS times=N rides the sick replica's env) — keep light
    # healthy load flowing until it is exhausted and the fast-window
    # burn decays below alerting
    recovered = False
    recovery_s = None
    t_rec = time.monotonic()
    for _ in range(60):
        results = await client.predict_async(start, end)
        for res in results:
            if not res.ok:
                errors.extend(res.error_messages)
        slo = await mesh.wm_json("/slo", params={"refresh": "1"})
        worst = slo.get("worst_burn") or {}
        burn_peak = max(burn_peak, float(worst.get("burn_rate") or 0.0))
        if _fast_window_burn(slo) < 1.0:
            recovered = True
            recovery_s = time.monotonic() - t_rec
            break
        await asyncio.sleep(1.5)
    hedge_stats = dict(client._hedge_stats)
    return {
        "injected": f"engine.queue latency fault on replica {sick} "
        "(alive, healthz ok, slow)",
        "detected": detection is not None,
        "detection_latency_s": detection,
        "detection_signal": "watchman /slo worst_burn attributed to the "
        "sick replica",
        "gray_replica_status": gray_status,
        "non_200": len(errors),
        "statuses": {"errors": errors[:5]},
        "hedges": hedge_stats.get("hedges", 0),
        "hedge_wins": hedge_stats.get("hedge_wins", 0),
        "burn_peak": burn_peak,
        "recovered": recovered,
        "recovery_s": recovery_s,
    }


async def _run_tenant_noisy_neighbor(mesh: GamedayMesh) -> Dict[str, Any]:
    """best_effort flood vs steady interactive probes on the qos mesh.

    Phases: (1) unloaded interactive baseline -> p99; (2) flood: N
    concurrent best_effort workers per replica (tenant ``flood``, rate-
    limited by GORDO_QOS_TENANTS and depth-limited by the per-class
    shed fractions) while the SAME interactive probe keeps scoring and
    the watchman per-class rollup is polled for the flood class's burn;
    (3) evidence: per-replica GET /qos sheds -> precision, probe
    latencies -> p99 ratio, probe statuses -> non_200."""
    from gordo_components_torch.utils.wire import TENSOR_CONTENT_TYPE

    member = mesh.members[0]
    body = scoring_body(rows=16)
    flood_body = scoring_body(rows=32, seed=2)
    flood_headers = {
        "Content-Type": TENSOR_CONTENT_TYPE,
        "X-Gordo-Tenant": "flood",
        "X-Gordo-Priority": "best_effort",
    }
    probe_headers = {"Content-Type": TENSOR_CONTENT_TYPE}

    async def probe_once(session, base) -> Tuple[int, float]:
        t0 = time.monotonic()
        try:
            resp = await session.post(
                mesh.score_url(base, member), data=body,
                headers=probe_headers,
            )
            return resp.status, time.monotonic() - t0
        except asyncio.CancelledError:
            raise
        except Exception:
            return 599, time.monotonic() - t0

    def p99(samples: List[float]) -> Optional[float]:
        if not samples:
            return None
        s = sorted(samples)
        return s[min(len(s) - 1, int(0.99 * len(s)))]

    flood_statuses: Dict[str, int] = {}
    stop = asyncio.Event()

    async def flood_worker(session, base) -> None:
        while not stop.is_set():
            try:
                resp = await session.post(
                    mesh.score_url(base, member), data=flood_body,
                    headers=flood_headers,
                )
                key = str(resp.status)
            except asyncio.CancelledError:
                raise
            except Exception:
                key = "599"
            flood_statuses[key] = flood_statuses.get(key, 0) + 1

    async with Session(timeout=30) as session:
        # -------- baseline: unloaded interactive p99 ------------------ #
        base_lat: List[float] = []
        errors: List[str] = []
        for i in range(40):
            status, dt = await probe_once(
                session, mesh.base_urls[i % mesh.n_replicas]
            )
            if status == 200:
                base_lat.append(dt)
            else:
                errors.append(f"baseline probe {status}")
        # -------- flood phase ----------------------------------------- #
        workers = [
            asyncio.get_running_loop().create_task(
                flood_worker(session, base)
            )
            for base in mesh.base_urls
            for _ in range(12)
        ]
        flood_lat: List[float] = []
        probe_statuses: Dict[str, int] = {}
        non_200 = 0
        class_burn_peak = None
        deadline = time.monotonic() + 15.0
        i = 0
        try:
            while time.monotonic() < deadline:
                status, dt = await probe_once(
                    session, mesh.base_urls[i % mesh.n_replicas]
                )
                i += 1
                probe_statuses[str(status)] = (
                    probe_statuses.get(str(status), 0) + 1
                )
                if status == 200:
                    flood_lat.append(dt)
                else:
                    non_200 += 1
                if i % 4 == 0:
                    slo = await mesh.wm_json(
                        "/slo", params={"refresh": "1"}
                    )
                    entry = (slo.get("classes") or {}).get(
                        "flood|best_effort"
                    )
                    for w in (entry or {}).get("windows", {}).values():
                        burn = w.get("burn_rate")
                        if burn is not None and (
                            class_burn_peak is None
                            or burn > class_burn_peak
                        ):
                            class_burn_peak = burn
        finally:
            stop.set()
            await asyncio.gather(*workers, return_exceptions=True)
        # -------- evidence: admission sheds per replica --------------- #
        shed_total = 0
        shed_flood_class = 0
        for base in mesh.base_urls:
            url = f"{base}/gordo/v0/{mesh.project}/qos"
            qos_doc = (await session.get(url)).json()
            for key, n in (
                (qos_doc.get("admission") or {}).get("shed") or {}
            ).items():
                shed_total += n
                # key is "tenant|class|reason"
                if key.split("|")[1:2] == ["best_effort"]:
                    shed_flood_class += n
    p99_base = p99(base_lat)
    p99_flood = p99(flood_lat)
    ratio = (
        round(p99_flood / p99_base, 3)
        if p99_base and p99_flood
        else None
    )
    precision = (
        round(shed_flood_class / shed_total, 4) if shed_total else None
    )
    return {
        "injected": (
            f"best_effort flood (tenant=flood, {12 * mesh.n_replicas} "
            "workers) against a steady interactive probe"
        ),
        "detected": shed_total > 0,
        "detection_signal": "admission sheds on GET /qos + per-class "
        "burn on the watchman /slo rollup",
        "non_200": non_200 + len(errors),
        "statuses": {
            "interactive": probe_statuses,
            "flood": flood_statuses,
            "errors": errors[:5],
        },
        "interactive_p99_baseline_s": p99_base,
        "interactive_p99_flood_s": p99_flood,
        "interactive_p99_ratio": ratio,
        "interactive_requests": len(base_lat) + sum(
            probe_statuses.values()
        ),
        "flood_requests": sum(flood_statuses.values()),
        "shed_total": shed_total,
        "shed_on_flood_class": shed_flood_class,
        "shed_precision": precision,
        "class_burn_peak": class_burn_peak,
        # the flood is the declared blast radius; nothing to heal
        "recovered": True,
        "recovery_s": 0.0,
    }


async def _run_thundering_herd(mesh: GamedayMesh) -> Dict[str, Any]:
    from gordo_components_torch.client.subscribe import PushSubscriber

    target = mesh.members[0]
    base = mesh.base_urls[0]
    n_subs = 6
    subs = [
        PushSubscriber(
            base,
            mesh.project,
            target,
            subscriber=f"herd-{i}",
            poll_timeout_s=2.0,
            reconnect_base_s=0.05,
            reconnect_cap_s=1.5,
            rng=random.Random(1000 + i),
        )
        for i in range(n_subs)
    ]
    stop = asyncio.Event()
    ingest_stop = asyncio.Event()

    async def feed() -> None:
        # steady ingest so polls have windows to deliver; tolerant of
        # the replica's injected connection resets and the restart
        t = 1_600_000_000.0
        rng = random.Random(7)
        while not ingest_stop.is_set():
            rows = [
                [rng.random() for _ in range(N_FEATURES)]
                for _ in range(16)
            ]
            ts = [t + i for i in range(16)]
            t += 16.0
            try:
                await mesh.ingest(base, target, rows, ts)
            except asyncio.CancelledError:
                raise
            except Exception:
                pass
            await asyncio.sleep(0.3)

    async with Session(timeout=10) as session:
        feeder = asyncio.get_running_loop().create_task(feed())
        tasks = [
            asyncio.get_running_loop().create_task(
                sub.run(session, stop=stop)
            )
            for sub in subs
        ]
        try:
            # all subscribers attached and polling through the flaky
            # transport (server.connection=reset rides GORDO_FAULTS)
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline and not all(
                s.stats["polls"] >= 1 for s in subs
            ):
                await asyncio.sleep(0.2)
            polls_at_kill = [s.stats["polls"] for s in subs]
            table0 = await mesh.routing(refresh=True)
            v0 = table0["version"]
            wall_kill = time.time()
            mesh.kill_replica(0, signal.SIGKILL)
            detection = await mesh.wait_until(
                lambda t: not _replica_entry(t, 0).get("reachable", True),
                timeout=45.0,
            )
            t_respawn = time.monotonic()
            await mesh.respawn_replica(0)
            await mesh.wait_until(
                lambda t: _replica_entry(t, 0).get("reachable"),
                timeout=60.0,
            )
            # recovery: every subscriber must long-poll SUCCESSFULLY
            # again (new ingests keep flowing from the feeder)
            deadline = time.monotonic() + 90.0
            while time.monotonic() < deadline and not all(
                s.stats["polls"] > p0
                for s, p0 in zip(subs, polls_at_kill)
            ):
                await asyncio.sleep(0.3)
            recovery_s = time.monotonic() - t_respawn
            lost = [
                s.subscriber
                for s, p0 in zip(subs, polls_at_kill)
                if s.stats["polls"] <= p0
            ]
        finally:
            stop.set()
            ingest_stop.set()
            for task in tasks:
                task.cancel()
            feeder.cancel()
            await asyncio.gather(*tasks, feeder, return_exceptions=True)
    table1 = await mesh.routing(refresh=True)
    events = await mesh.events_since(wall_kill - 1.0)
    delays = [d for s in subs for d in s.reconnect_delays]
    return {
        "injected": "SIGKILL the push replica under 6 long-poll "
        "subscribers + server.connection=reset transport flakiness",
        "detected": detection is not None,
        "detection_latency_s": detection,
        "detection_signal": "routing table reachable=false + "
        "mesh.replica_unreachable",
        "non_200": 0,
        "subscribers": n_subs,
        "subscribers_lost": lost,
        "reconnects": sum(s.stats["reconnects"] for s in subs),
        "poll_failures": sum(s.stats["failures"] for s in subs),
        "distinct_reconnect_delays": len(
            {round(d, 4) for d in delays}
        ),
        "reconnect_delay_span_s": (
            round(max(delays) - min(delays), 4) if delays else 0.0
        ),
        "recovered": not lost,
        "recovery_s": recovery_s,
        "routing_version_steps": table1["version"] - v0,
        "events": events,
    }


async def _run_correlated_drift(mesh: GamedayMesh) -> Dict[str, Any]:
    import numpy as np

    table = await mesh.routing(refresh=True)
    owners = table["members"]
    rep_urls = {r["replica"]: r["url"] for r in table["replicas"]}
    # one victim member per replica: the SAME upstream shift hits the
    # whole fleet at once — that correlation is what the rollup must see
    victims: Dict[int, str] = {}
    for member in sorted(mesh.members):
        idx = owners.get(member)
        if idx is not None and idx not in victims:
            victims[idx] = member
    assert len(victims) >= 2, f"need members on 2+ replicas: {owners}"
    rng = np.random.RandomState(3)
    t_base = 1_600_000_000.0

    async def ingest_rows(idx: int, member: str, shift: float, t0: float,
                          n: int) -> None:
        rows = (rng.rand(n, N_FEATURES) + shift).tolist()
        ts = [t0 + i for i in range(n)]
        status = await mesh.ingest(rep_urls[idx], member, rows, ts)
        assert status == 200, (member, status)

    # healthy windows everywhere -> nothing drifts
    for idx, member in victims.items():
        await ingest_rows(idx, member, 0.0, t_base, 96)

    async def drift_view(idx: int) -> Dict[str, Any]:
        url = (
            f"{rep_urls[idx]}/gordo/v0/{mesh.project}/drift"
        )
        return (await mesh.session.get(url, params={"refresh": "1"})).json()

    for idx in victims:
        body = await drift_view(idx)
        assert body.get("drifted") == [], body.get("drifted")

    loop = LoadLoop(
        mesh, list(victims.values()), follow_routing=False
    ).start()
    wall_shift = time.time()
    t0 = time.monotonic()
    for idx, member in victims.items():
        await ingest_rows(idx, member, 3.0, t_base + 200.0, 192)
    # detection: every replica's own detector must flag its member
    drifted_replicas: List[int] = []
    detection = None
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline and len(drifted_replicas) < len(
        victims
    ):
        for idx, member in victims.items():
            if idx in drifted_replicas:
                continue
            body = await drift_view(idx)
            if member in (body.get("drifted") or []):
                drifted_replicas.append(idx)
        if len(drifted_replicas) == len(victims):
            detection = time.monotonic() - t0
        else:
            await asyncio.sleep(0.5)
    # the fleet rollup unions the attribution
    rollup = await mesh.wm_json("/drift", params={"refresh": "1"})
    rollup_drifted = sorted(rollup.get("drifted") or [])
    # recovery: recalibrate the flagged members on each replica and
    # wait for the flags to clear
    t_rec = time.monotonic()
    for idx, member in victims.items():
        url = f"{rep_urls[idx]}/gordo/v0/{mesh.project}/adapt"
        resp = await mesh.session.post(
            url, json={"mode": "recalibrate", "targets": [member]}
        )
        body = resp.json()
        assert resp.status == 200 and body.get("applied"), body
    recovered = False
    recovery_s = None
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        still = []
        for idx, member in victims.items():
            body = await drift_view(idx)
            if member in (body.get("drifted") or []):
                still.append(member)
        if not still:
            recovered = True
            recovery_s = time.monotonic() - t_rec
            break
        await asyncio.sleep(0.5)
    await loop.stop()
    events = await mesh.events_since(wall_shift - 1.0)
    return {
        "injected": f"mean-shift drift on {sorted(victims.values())} "
        "(one member per replica, same instant)",
        "detected": detection is not None,
        "detection_latency_s": detection,
        "detection_signal": "per-replica drift sweeps + fleet /drift "
        "rollup union",
        "non_200": loop.non_200,
        "requests": loop.requests,
        "statuses": loop.statuses,
        "drifted_replicas": sorted(drifted_replicas),
        "rollup_drifted": rollup_drifted,
        "recovered": recovered,
        "recovery_s": recovery_s,
        "events": events,
    }


RUNNERS: Dict[str, Callable[[GamedayMesh], Any]] = {
    "replica_crash_restart": _run_replica_crash,
    "watchman_partition": _run_watchman_partition,
    "migration_storm": _run_migration_storm,
    "gray_failure_slow_replica": _run_gray_failure,
    "tenant_noisy_neighbor": _run_tenant_noisy_neighbor,
    "thundering_herd": _run_thundering_herd,
    "correlated_drift": _run_correlated_drift,
}


# --------------------------------------------------------------------- #
# the run loop: one mesh boot per shape, scenarios in catalog order
# --------------------------------------------------------------------- #


def _mesh_for(shape: str, root: str, members: List[str], device="cuda") -> GamedayMesh:
    if shape == "partitioned":
        # the LONG refresh interval is deliberate: the migration-storm
        # drill needs watchman's cached table to go genuinely stale;
        # detection polls force rebuilds explicitly
        return GamedayMesh(
            root, members, n_replicas=2, partitioned=True,
            refresh_interval=300.0, device=device,
        )
    if shape == "replicated":
        return GamedayMesh(
            root, members, n_replicas=2, partitioned=False,
            refresh_interval=0.5,
            common_env={
                "GORDO_SLO_SAMPLE_S": "0.2",
                "GORDO_SLO_WINDOWS": "30s,5m",
                "GORDO_SLO_OBJECTIVES": json.dumps([
                    {"name": "availability", "target": 0.999},
                    {"name": "p95_latency_ms", "target": 120.0},
                ]),
            },
            replica_env={
                1: {"GORDO_FAULTS": "engine.queue=latency:0.25,times=60"},
            },
            device=device,
        )
    if shape == "qos":
        # the noisy-neighbor drill: clean replicas (no armed faults — a
        # latency fault would pollute the p99 baseline), a tight engine
        # queue so a flood reaches the per-class shed thresholds within
        # seconds, fast per-class SLO windows, and a named flood tenant
        # so its metric label survives the cardinality bound
        return GamedayMesh(
            root, members, n_replicas=2, partitioned=False,
            refresh_interval=0.5,
            common_env={
                "GORDO_SLO_SAMPLE_S": "0.2",
                "GORDO_SLO_WINDOWS": "30s,5m",
                "GORDO_SLO_OBJECTIVES": json.dumps([
                    {"name": "availability", "target": 0.999},
                ]),
                "GORDO_BANK_MAX_QUEUE": "32",
                "GORDO_QOS_TENANTS": json.dumps(
                    {"flood": {"rate": 60.0, "burst": 90.0}}
                ),
            },
            device=device,
        )
    if shape == "push":
        return GamedayMesh(
            root, members, n_replicas=1, partitioned=False,
            refresh_interval=0.5,
            common_env={
                "GORDO_STREAM": "1",
                "GORDO_PUSH": "1",
                "GORDO_STREAM_MIN_ROWS": "8",
                "GORDO_FAULTS": "server.connection=reset,p=0.15,seed=11",
            },
            device=device,
        )
    if shape == "streaming":
        return GamedayMesh(
            root, members, n_replicas=2, partitioned=True,
            refresh_interval=0.5,
            common_env={
                "GORDO_STREAM": "1",
                "GORDO_STREAM_WINDOW": "128",
                "GORDO_STREAM_MIN_ROWS": "32",
                # manual adapt only: the drill drives recalibration
                # itself so recovery time is the drill's to measure
                "GORDO_STREAM_INTERVAL_S": "3600",
            },
            device=device,
        )
    raise ValueError(f"unknown mesh shape {shape!r}")


async def run_gameday(
    root: str,
    scenario_names: Optional[List[str]] = None,
    n_members: int = 4,
    progress: Optional[Callable[[str], None]] = None,
    device="cuda",
) -> Dict[str, Any]:
    """Run the named scenarios (default: the full catalog), one mesh
    boot per required shape, and return the judged run document. The
    fleet trains and the replicas serve on ``device`` (``"cuda"``, the
    default, or ``"cpu"``)."""
    names = list(scenario_names or SCENARIOS)
    unknown = sorted(set(names) - set(SCENARIOS))
    if unknown:
        raise ValueError(
            f"unknown scenario(s) {unknown}; known: {sorted(SCENARIOS)}"
        )
    members = build_fleet_artifacts(root, n_members, device=device)
    single_core = (os.cpu_count() or 1) < 2
    say = progress or (lambda msg: None)
    doc: Dict[str, Any] = {
        "schema": GAMEDAY_SCHEMA,
        "cpu_count": os.cpu_count(),
        "single_core": single_core,
        "scenarios": {},
    }
    for shape in SHAPE_ORDER:
        todo = [n for n in names if SCENARIOS[n].mesh == shape]
        if not todo:
            continue
        say(f"booting {shape} mesh for {todo}")
        async with _mesh_for(shape, root, members, device) as mesh:
            for name in todo:
                scenario = SCENARIOS[name]
                say(f"scenario {name}: {scenario.description[:60]}...")
                t0 = time.monotonic()
                try:
                    evidence = await RUNNERS[name](mesh)
                except asyncio.CancelledError:
                    raise
                except Exception as exc:
                    logger.exception("scenario %s crashed", name)
                    evidence = {
                        "error": f"{type(exc).__name__}: {exc}",
                        "detected": False,
                        "non_200": 0,
                    }
                    verdict = scenario.finalize(evidence, single_core)
                    verdict["failures"].insert(
                        0, f"scenario crashed: {evidence['error']}"
                    )
                    verdict["passed"] = False
                    verdict["wall_seconds"] = round(
                        time.monotonic() - t0, 3
                    )
                    doc["scenarios"][name] = verdict
                    continue
                verdict = scenario.finalize(evidence, single_core)
                verdict["wall_seconds"] = round(time.monotonic() - t0, 3)
                # the judged timeline is evidence, but the full event
                # dicts bloat the doc — keep the causal skeleton
                if "events" in verdict:
                    verdict["events"] = [
                        {
                            "type": e.get("type"),
                            "replica": e.get("replica"),
                            "wall": e.get("wall"),
                            "severity": e.get("severity"),
                        }
                        for e in verdict["events"]
                    ]
                doc["scenarios"][name] = verdict
                say(
                    f"scenario {name}: "
                    f"{'PASS' if verdict['passed'] else 'FAIL'}"
                )
    doc["passed"] = all(
        v.get("passed") for v in doc["scenarios"].values()
    ) and bool(doc["scenarios"])
    return doc


def render_verdict_table(doc: Dict[str, Any]) -> str:
    """The per-scenario verdict table the demo prints (and the docs'
    triage runbook references)."""
    rows = [
        (
            "scenario", "verdict", "detect(s)", "non200", "recover(s)",
            "notes",
        )
    ]
    for name, v in doc.get("scenarios", {}).items():
        det = v.get("detection_latency_s")
        rec = v.get("recovery_s")
        rows.append(
            (
                name,
                "PASS" if v.get("passed") else "FAIL",
                f"{det:.1f}" if isinstance(det, (int, float)) else "-",
                str(v.get("non_200", "-")),
                f"{rec:.1f}" if isinstance(rec, (int, float)) else "-",
                "; ".join(v.get("failures", []))[:60] or "ok",
            )
        )
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines = []
    for i, row in enumerate(rows):
        lines.append(
            "  ".join(cell.ljust(w) for cell, w in zip(row, widths))
        )
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)
