"""Bulk prediction client.

Counterpart of ``gordo_components_tpu/client/client.py``, on the standard
library, numpy and :mod:`.http` (no aiohttp, no pandas): find the
project's targets (the server's ``/models``, or a routing table), rebuild
each target's dataset from its metadata, cut the time range into chunks
of ``batch_size`` rows, POST them ``parallelism`` at a time, join each
target's answers in order and hand them to a forwarder.

Each chunk climbs down two ladders, the JAX client's own:

- transport: the shared-memory ring, then the Unix socket, then TCP
  (``transport="auto"``: the rungs ``/models`` advertises that prove
  themselves here; a Unix socket that dies mid-run sends the rest of the
  run over TCP once);
- encoding: the framed tensor body, then parquet, then JSON (``"auto"``:
  what ``/models`` accepts; a body an ``"auto"`` run finds refused where
  the next encoding succeeds downgrades the rest of the run; a forced
  encoding never downgrades).

Every downgrade is logged. The ladders choose how bytes travel, never
where the scoring runs.

Retries (408, 429, 5xx) sleep on decorrelated jitter through one shared
:class:`~gordo_components_torch.resilience.retry_budget.RetryBudget`
(per-class ratios: batch 0.05, best_effort 0.02, else 0.1); ``deadline_ms``
bounds each chunk and rides on each attempt as ``X-Gordo-Deadline-Ms``;
``hedge`` re-issues a chunk slower than the observed p95 to one other
replica (never for ``best_effort``); a routing table sends each target's
chunks to its owning replica and re-posts a target's failed chunks once
after a 404 shows the table stale.

Results are :class:`~gordo_components_torch.dataset.base.ResultFrame`
objects where the JAX client returns DataFrames: the same values (float64),
the same column labels in the same order and the same index, in ns.
"""

import asyncio
import contextlib
import functools
import hashlib
import itertools
import json
import logging
import os
import random
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from gordo_components_torch.client.http import ClientConnectionError, Session
from gordo_components_torch.client.io import fetch_json, fetch_json_hedged, fetch_metadata_all
from gordo_components_torch.dataset import get_dataset
from gordo_components_torch.dataset.base import ResultFrame, TagFrame
from gordo_components_torch.dataset.data_provider._parquet import write_parquet_bytes
from gordo_components_torch.dataset.times import parse_times, timestamp_text, timestamp_texts, to_ns
from gordo_components_torch.observability.metrics import get_registry
from gordo_components_torch.observability.tracing import format_traceparent
from gordo_components_torch.qos.classify import normalize_class, normalize_tenant
from gordo_components_torch.resilience.deadline import Deadline, DeadlineExceeded
from gordo_components_torch.resilience.retry_budget import RetryBudget, decorrelated_jitter
from gordo_components_torch.utils.wire import (
    ANOMALY_FRAME_NAMES,
    TENSOR_CONTENT_TYPE,
    pack_frames,
    unpack_frames,
)

__all__ = ["Client", "PredictionResult"]

logger = logging.getLogger(__name__)

# below this many targets, per-target /metadata GETs beat downloading the
# whole fleet's metadata in one metadata-all answer
_PREFETCH_MIN_TARGETS = 8

# latency samples needed before the hedge delay switches from the
# configured initial value to the observed p95
_HEDGE_MIN_SAMPLES = 16


class _LatencyTracker:
    """The last chunk latencies; their p95 is the hedge delay, so only the
    slowest ~5% of chunks send a duplicate."""

    def __init__(self, maxlen: int = 256):
        self._samples: "deque[float]" = deque(maxlen=maxlen)

    def record(self, seconds: float) -> None:
        self._samples.append(seconds)

    def __len__(self) -> int:
        return len(self._samples)

    def p95(self) -> Optional[float]:
        if not self._samples:
            return None
        ordered = sorted(self._samples)
        return ordered[min(len(ordered) - 1, int(0.95 * len(ordered)))]


@dataclass
class PredictionResult:
    """One target's outcome of a bulk run."""

    name: str
    predictions: Optional[ResultFrame]
    error_messages: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.predictions is not None and not self.error_messages


def _chunk(frame: TagFrame, start: int, stop: int) -> TagFrame:
    return TagFrame(frame.values[start:stop], frame.index[start:stop], frame.columns)


def _parse_index(index) -> np.ndarray:
    """A JSON answer's index as ``pd.to_datetime(index, utc=True)`` reads
    it, in ns; as given when it does not read as timestamps."""
    try:
        return parse_times(index).view("datetime64[ns]")
    except (ValueError, TypeError):
        return np.asarray(index, dtype=object)


def _dict_frame(body: Dict[str, Any]) -> ResultFrame:
    """A JSON answer whose ``data`` maps groups to tag dicts (or lists),
    as the JAX ``server.utils.dict_to_frame`` reads it."""
    data = body["data"]
    multi = any(isinstance(v, dict) for v in data.values())
    columns, cols = [], []
    for top, v in data.items():
        if isinstance(v, dict):
            for sub, values in v.items():
                columns.append((top, sub))
                cols.append(values)
        else:
            columns.append((top, "") if multi else top)
            cols.append(v)
    values = np.column_stack([np.asarray(c, np.float64) for c in cols]) if cols else np.zeros((0, 0))
    index = body.get("index")
    index = _parse_index(index) if index is not None else np.arange(len(values))
    return ResultFrame(values, index, columns)


def _list_frame(body: Dict[str, Any]) -> ResultFrame:
    """A JSON answer whose ``data`` is rows (the ``/prediction`` body)."""
    values = np.asarray(body["data"], np.float64)
    if values.ndim == 1:
        values = values[:, None]
    index = body.get("index")
    index = _parse_index(index) if index and len(index) == len(values) else np.arange(len(values))
    return ResultFrame(values, index, list(range(values.shape[1])))


class Client:
    """Score time ranges against every model of a project."""

    def __init__(
        self,
        project: str,
        host: str = "localhost",
        port: int = 5555,
        scheme: str = "http",
        *,
        base_url: Optional[str] = None,
        batch_size: int = 1000,
        parallelism: int = 10,
        forwarder=None,
        use_anomaly: bool = True,
        metadata_fallback_dataset: Optional[Dict[str, Any]] = None,
        use_parquet="auto",
        use_tensor="auto",
        transport: str = "auto",
        uds_path: Optional[str] = None,
        shm_ring: Optional[str] = None,
        retries: int = 3,
        backoff: float = 0.5,
        retry_budget: Optional[RetryBudget] = None,
        retry_budget_ratio: Optional[float] = None,
        deadline_ms: Optional[float] = None,
        tenant: Optional[str] = None,
        priority: Optional[str] = None,
        hedge: bool = False,
        replica_urls: Optional[List[str]] = None,
        hedge_delay_init_s: float = 1.0,
        routing_url: Optional[str] = None,
        routing: Optional[Dict[str, Any]] = None,
        routing_refresh_window_s: float = 5.0,
    ):
        self.project = project
        # no trailing slash: the hedge's exclusion compares it with replica_urls
        self.base_url = (base_url or f"{scheme}://{host}:{port}").rstrip("/")
        self.batch_size = int(batch_size)
        self.parallelism = int(parallelism)
        self.forwarder = forwarder
        self.use_anomaly = use_anomaly
        self.metadata_fallback_dataset = metadata_fallback_dataset
        # the QoS identity, on every scoring POST's headers and in the
        # tensor body's __meta__ frame (the ring has no headers); the class
        # also sets the client's own overload posture below
        self.tenant = normalize_tenant(tenant) if tenant else None
        self.qos_class = normalize_class(priority) if priority else "interactive"
        self.retries = int(retries)
        self.backoff = float(backoff)
        if retry_budget_ratio is None:
            # lower classes are shed first, so their retries are the
            # likeliest to be overload fuel: they re-offer less
            retry_budget_ratio = {"batch": 0.05, "best_effort": 0.02}.get(self.qos_class, 0.1)
        self.retry_budget = retry_budget if retry_budget is not None else RetryBudget(ratio=retry_budget_ratio)
        self.deadline_ms = None if deadline_ms is None else float(deadline_ms)
        # best_effort never hedges: a hedge is a second copy of the load
        # the fleet is most willing to shed
        self.hedge = bool(hedge) and self.qos_class != "best_effort"
        self.replica_urls = [u.rstrip("/") for u in (replica_urls or []) if u.rstrip("/")]
        self.hedge_delay_init_s = float(hedge_delay_init_s)
        self._latency = _LatencyTracker()
        self._hedge_stats: Dict[str, int] = {"hedges": 0, "hedge_wins": 0}
        self._hedge_rng = random.Random()
        # partition-aware fan-out: with a routing table (fetched from
        # routing_url's GET /routing, or given) each target's chunks go to
        # the replica that owns it; neither set: one base URL
        self.routing_url = (routing_url or "").rstrip("/") or None
        self._routing: Optional[Dict[str, Any]] = None
        self._routing_etag: Optional[str] = None
        if routing is not None:
            self._install_routing(routing)
        self._fanout_stats: Dict[str, int] = {
            "routed_chunks": 0, "routing_refreshes": 0, "reroutes": 0, "refreshes_throttled": 0,
        }
        # one forced /routing refetch a member a window: a stale table must
        # not turn into a refresh stampede against the watchman
        self.routing_refresh_window_s = float(routing_refresh_window_s)
        self._forced_refresh_at: Dict[str, float] = {}
        if use_parquet not in (True, False, "auto"):
            raise ValueError(f"use_parquet must be True, False or 'auto', got {use_parquet!r}")
        self.use_parquet = use_parquet
        self._parquet_active = False
        if use_tensor not in (True, False, "auto"):
            raise ValueError(f"use_tensor must be True, False or 'auto', got {use_tensor!r}")
        self.use_tensor = use_tensor
        self._tensor_active = False
        if transport not in ("auto", "tcp", "uds", "shm"):
            raise ValueError(f"transport must be auto|tcp|uds|shm, got {transport!r}")
        self.transport = transport
        self.uds_path = uds_path
        self.shm_ring = shm_ring
        # which rung carried the scoring chunks of the last run
        self.transport_used = "tcp"
        self._shm_client = None
        self._data_session: Optional[Session] = None  # the Unix-socket session for scoring POSTs
        # sessions retired mid-run by _drop_uds, closed at the run's end:
        # sibling chunks may still have requests on them
        self._dead_sessions: List[Session] = []
        # body bytes out and rows by encoding, for every scoring POST that got a 2xx
        self._wire_stats: Dict[str, Dict[str, int]] = {}
        self._metadata_all: Dict[str, Any] = {}
        # every scoring POST carries a unique X-Gordo-Request-Id
        self._rid_prefix = uuid.uuid4().hex[:12]
        self._rid_seq = itertools.count(1)
        self._ingest_stats: Dict[str, int] = {"rows": 0, "chunks": 0}
        self._register_metrics()

    def _next_request_id(self) -> str:
        return f"{self._rid_prefix}-{next(self._rid_seq):x}"

    def _register_metrics(self) -> None:
        """The client's counters in the process registry, read at render
        time through a weak reference (a discarded client yields nothing),
        labelled and keyed by the request-id prefix so two clients in one
        process keep their own series."""
        import weakref

        ref = weakref.ref(self)
        labels = {"client": self._rid_prefix}

        def collect():
            c = ref()
            if c is None:
                return
            b = c.retry_budget.snapshot()
            yield ("gordo_client_retries_total", "counter", "Retries the shared budget admitted", labels,
                   b["retries_allowed"])
            yield ("gordo_client_retries_denied_total", "counter",
                   "Retries refused because the budget was exhausted (failed fast instead of re-offering load)",
                   labels, b["retries_denied"])
            yield ("gordo_client_retry_budget_tokens", "gauge", "Retry tokens currently banked", labels,
                   b["tokens"])
            yield ("gordo_client_hedges_total", "counter",
                   "Hedge requests issued (primary slower than the hedge delay)", labels,
                   c._hedge_stats["hedges"])
            yield ("gordo_client_hedge_wins_total", "counter",
                   "Hedged requests answered by the hedge replica first", labels, c._hedge_stats["hedge_wins"])
            yield ("gordo_client_ingest_rows_total", "counter",
                   "Stream rows the ingestion forwarder posted and the server accepted", labels,
                   c._ingest_stats["rows"])
            yield ("gordo_client_routed_chunks_total", "counter",
                   "Scoring chunks routed to their member's owning replica via the mesh routing table", labels,
                   c._fanout_stats["routed_chunks"])
            yield ("gordo_client_routing_refreshes_total", "counter",
                   "Routing-table fetches that installed a new table (200s; 304 not-modified polls excluded)",
                   labels, c._fanout_stats["routing_refreshes"])
            yield ("gordo_client_reroutes_total", "counter",
                   "Chunks re-posted after a stale-table 404 forced a routing refresh", labels,
                   c._fanout_stats["reroutes"])
            yield ("gordo_client_routing_refreshes_throttled_total", "counter",
                   "Forced stale-table refreshes suppressed by the per-member rate limit (refresh-stampede guard)",
                   labels, c._fanout_stats["refreshes_throttled"])
            for enc, st in list(c._wire_stats.items()):
                yield ("gordo_client_request_bytes_total", "counter",
                       "Scoring request body bytes posted, by wire encoding", {**labels, "encoding": enc},
                       st["bytes_out"])

        get_registry().collector(collect, key=f"bulk_client:{self._rid_prefix}")

    def _note_wire(self, encoding: str, bytes_out: int, rows: int) -> None:
        """Count a scoring chunk that succeeded against its encoding (the
        event loop's thread only)."""
        st = self._wire_stats.setdefault(encoding, {"posts": 0, "bytes_out": 0, "rows": 0})
        st["posts"] += 1
        st["bytes_out"] += int(bytes_out)
        st["rows"] += int(rows)

    @property
    def wire_stats(self) -> Dict[str, Dict[str, int]]:
        """POSTs, body bytes out and rows by encoding, for every scoring
        chunk that succeeded."""
        return {enc: dict(st) for enc, st in self._wire_stats.items()}

    @staticmethod
    def replicas_from_watchman(snapshot: Dict[str, Any]) -> List[str]:
        """Replica base URLs from a watchman ``GET /`` body's ``replicas``:
        bare URL strings or ``{"url": ...}`` entries."""
        out: List[str] = []
        for entry in snapshot.get("replicas") or []:
            if isinstance(entry, dict):
                entry = entry.get("url")
            if isinstance(entry, str) and entry.rstrip("/"):
                out.append(entry.rstrip("/"))
        return out

    # ------------------------------------------------------------------ #
    # partition-aware fan-out (the routing table)
    # ------------------------------------------------------------------ #

    def _install_routing(self, table: Dict[str, Any]) -> None:
        """Check and index a routing table (a watchman ``GET /routing``
        body): member -> owner index, index -> replica entry."""
        if not isinstance(table, dict) or not isinstance(table.get("members"), dict):
            raise ValueError("routing table must be a dict with a 'members' map (watchman GET /routing body)")
        replicas = {
            int(r["replica"]): {**r, "url": str(r["url"]).rstrip("/")}
            for r in table.get("replicas") or []
            if isinstance(r, dict) and "replica" in r and r.get("url")
        }
        self._routing = {
            "version": int(table.get("version", 0)),
            "members": dict(table["members"]),
            # member -> every replica serving it now (a migration's
            # overlap, or a replicated fleet): the hedge's candidates
            "owners": {
                str(k): [int(i) for i in v]
                for k, v in (table.get("migrating") or {}).items()
                if isinstance(v, (list, tuple))
            },
            "replicas": replicas,
        }

    @property
    def routing_version(self) -> Optional[int]:
        return self._routing["version"] if self._routing else None

    async def _fetch_routing(self, session: Session, force: bool = False, member: Optional[str] = None) -> bool:
        """Fetch the routing table, conditional on its ETag (an unchanged
        table costs a 304). True when the table changed. A failure keeps
        the previous table (or the single base URL). ``member`` applies
        the forced-refresh limit: one a member a window, the others
        counted and refused without a request."""
        if self.routing_url is None:
            return False
        if force and member is not None:
            now = time.monotonic()
            last = self._forced_refresh_at.get(member)
            if last is not None and now - last < self.routing_refresh_window_s:
                self._fanout_stats["refreshes_throttled"] += 1
                return False
            # stamped before the attempt: a watchman that is down must
            # not be hammered by failed refreshes
            self._forced_refresh_at[member] = now
        headers = {}
        if self._routing_etag and not force:
            headers["If-None-Match"] = self._routing_etag
        try:
            resp = await session.get(f"{self.routing_url}/routing", params={"refresh": "1"} if force else None,
                                     headers=headers)
            if resp.status == 304:
                return False
            if resp.status != 200:
                logger.warning("routing fetch answered %d; keeping %s", resp.status,
                               "previous table" if self._routing else "single-URL mode")
                return False
            body = resp.json()
            etag = resp.headers.get("ETag")
        except Exception as exc:
            logger.warning("routing fetch from %s failed (%s); %s", self.routing_url, exc,
                           "keeping previous table" if self._routing else "single-URL mode")
            return False
        before = self._routing["version"] if self._routing else None
        try:
            # a 200 of another shape downgrades like a failed fetch, and
            # its ETag is not kept (a 304 would pin the client table-less)
            self._install_routing(body)
        except ValueError as exc:
            logger.warning("routing body from %s unusable (%s); %s", self.routing_url, exc,
                           "keeping previous table" if self._routing else "single-URL mode")
            return False
        self._routing_etag = etag
        self._fanout_stats["routing_refreshes"] += 1
        return self._routing["version"] != before

    def _member_base_url(self, target: str) -> Optional[str]:
        """The owning replica's base URL, or None (no table, an unknown
        member or owner): the caller falls back to ``base_url``."""
        if self._routing is None:
            return None
        idx = self._routing["members"].get(target)
        if idx is None:
            return None
        rep = self._routing["replicas"].get(int(idx))
        return rep["url"] if rep else None

    def _replica_healthy_for(self, rep: Dict[str, Any], target: str) -> bool:
        """A replica the table marks unreachable, not ``ok``, or
        quarantining ``target`` never receives a hedge."""
        if not rep.get("reachable", True):
            return False
        if rep.get("status", "ok") not in ("ok",):
            return False
        return target not in (rep.get("quarantined") or ())

    def _connector_limit(self) -> int:
        """The scoring session's pool: a hedged chunk holds two sockets,
        so ``parallelism * (1 + hedge)`` lanes and a little control-plane
        headroom."""
        lanes = self.parallelism * (2 if self.hedge else 1)
        return max(lanes + 4, 8)

    def _hedge_delay_s(self) -> float:
        """The observed p95 once there are enough samples, else the
        configured initial delay."""
        if len(self._latency) >= _HEDGE_MIN_SAMPLES:
            p95 = self._latency.p95()
            if p95 is not None:
                return max(p95, 1e-3)
        return self.hedge_delay_init_s

    def _chunk_urls(self, target: str, endpoint: str) -> List[str]:
        """The primary URL and, when hedging, one other replica's URL for
        the same path: with a routing table the owner, and a healthy
        replica that also serves the member; a Unix-socket session has
        one URL and no hedge."""
        if self._data_session is not None:
            return [f"http://localhost/gordo/v0/{self.project}/{target}/{endpoint}"]
        path = f"gordo/v0/{self.project}/{target}/{endpoint}"
        if self._routing is not None:
            primary = self._member_base_url(target) or self.base_url
            urls = [f"{primary}/{path}"]
            if self.hedge:
                candidates = [
                    rep["url"]
                    for idx in self._routing["owners"].get(target, ())
                    if (rep := self._routing["replicas"].get(idx)) is not None
                    and rep["url"] != primary
                    and self._replica_healthy_for(rep, target)
                ]
                if candidates:
                    urls.append(f"{self._hedge_rng.choice(candidates)}/{path}")
            return urls
        urls = [self._url(target, endpoint)]
        if self.hedge:
            others = [u for u in self.replica_urls if u != self.base_url]
            if others:
                urls.append(f"{self._hedge_rng.choice(others)}/{path}")
        return urls

    def _trace_headers(self, rid: str) -> Dict[str, str]:
        """The request id, a sampled W3C ``traceparent`` whose trace id is
        the id's md5 (so either recovers the other), and the QoS
        identity."""
        trace_id = hashlib.md5(rid.encode()).hexdigest()
        headers = {"X-Gordo-Request-Id": rid, "traceparent": format_traceparent(trace_id, trace_id[:16])}
        if self.tenant:
            headers["X-Gordo-Tenant"] = self.tenant
        if self.qos_class != "interactive":
            headers["X-Gordo-Priority"] = self.qos_class
        return headers

    # ------------------------------------------------------------------ #
    # local transports: negotiation and the ring's scoring path
    # ------------------------------------------------------------------ #

    async def _resolve_transport(self, models_body) -> None:
        """Pick this run's transport: shm, then uds, then tcp, from the
        local hints (``shm_ring``, ``uds_path``) and ``/models``'
        ``transports``. A rung carries chunks only once it proved itself
        here (the ring attaches, the socket path exists); each failure
        drops one rung and says why."""
        self.transport_used = "tcp"
        self._shm_client = None
        self._data_session = None
        if self.transport == "tcp":
            return
        adv = (models_body or {}).get("transports") or {}
        if self.transport in ("auto", "shm"):
            name = self.shm_ring or adv.get("shm")
            if name:
                try:
                    from gordo_components_torch.utils.shm_ring import ShmRingClient

                    self._shm_client = ShmRingClient(name)
                    self.transport_used = "shm"
                    logger.info("scoring over shm ring %r", name)
                    return
                except Exception as exc:
                    logger.warning("shm ring %r not attachable (%s); trying the next transport", name, exc)
            elif self.transport == "shm":
                logger.warning("transport='shm' but no ring name (pass shm_ring= or serve with GORDO_SHM_RING); "
                               "falling back to tcp")
        if self.transport in ("auto", "uds"):
            path = self.uds_path or adv.get("uds")
            if path and os.path.exists(path):
                self._data_session = Session(limit=self._connector_limit(), timeout=600, unix_path=path)
                self.transport_used = "uds"
                logger.info("scoring over unix socket %s", path)
                return
            if self.transport == "uds":
                logger.warning("transport='uds' but socket path %r does not exist; falling back to tcp", path)

    async def _drop_uds(self, exc) -> None:
        """Retire a dead Unix-socket session mid-run, once for all chunks
        (the first caller wins, the rest see tcp); it closes at the run's
        end."""
        s, self._data_session = self._data_session, None
        self.transport_used = "tcp"
        if s is not None:
            logger.warning("unix-socket transport failed mid-run (%s); remaining chunks go over tcp", exc)
            self._dead_sessions.append(s)

    async def _post_shm(self, target: str, endpoint: str, chunk: TagFrame, chunk_y: Optional[TagFrame],
                        deadline: Optional[Deadline] = None) -> ResultFrame:
        """One chunk over the shared-memory ring: the tensor body and
        answer of the HTTP path, no socket; the ring's wait runs on an
        executor thread. 408, 429 and 5xx retry on decorrelated jitter
        (a 429's ``retry_after_s`` a lower bound) through the shared
        budget; other errors raise ``ValueError`` with the server's
        document. ``deadline`` bounds the exchange on this side (the
        ring's envelope carries none)."""
        loop = asyncio.get_running_loop()
        body = await loop.run_in_executor(None, self._encode_tensor, chunk, chunk_y)
        kind = "anomaly" if endpoint.startswith("anomaly") else "prediction"
        self.retry_budget.note_request()
        retries = max(1, self.retries)
        prev_delay = self.backoff
        for attempt in range(retries):
            if deadline is not None and deadline.expired():
                raise DeadlineExceeded(f"deadline expired before shm attempt {attempt + 1}")
            ring_timeout = 60.0
            if deadline is not None:
                ring_timeout = max(1e-3, min(ring_timeout, deadline.remaining_s()))
            status, resp = await loop.run_in_executor(
                None, functools.partial(self._shm_client.request, target, body, kind, timeout=ring_timeout))
            if status < 400:
                self._note_wire("tensor", len(body), len(chunk))
                return self._decode_tensor_scoring_body(resp, chunk, anomaly=kind == "anomaly")
            if status not in (408, 429) and status < 500:
                break  # a request error: a retry cannot help
            if attempt + 1 >= retries or not self.retry_budget.try_spend():
                break
            delay = prev_delay = decorrelated_jitter(self.backoff, prev_delay)
            if status == 429:
                try:  # the shed answer's queue-drain estimate
                    hinted = float(json.loads(resp).get("retry_after_s", 0))
                    delay = max(delay, min(hinted, 60.0))
                except (ValueError, AttributeError):
                    pass
            if deadline is not None:
                delay = min(delay, deadline.remaining_s())
            await asyncio.sleep(delay)
        raise ValueError(f"shm status {status}: {resp[:500].decode('utf-8', 'replace')}")

    # ------------------------------------------------------------------ #

    def _url(self, target: str, endpoint: str) -> str:
        # lookups follow the routing table too: only the owner answers a
        # member's /metadata in a partitioned mesh
        base = self._member_base_url(target) or self.base_url
        return f"{base}/gordo/v0/{self.project}/{target}/{endpoint}"

    async def _get_metadata(self, session: Session, target: str) -> Dict[str, Any]:
        meta = self._metadata_all.get(target)
        if meta is not None:
            return meta

        async def fetch():
            body = await fetch_json(session, self._url(target, "metadata"), retries=self.retries,
                                    backoff=self.backoff, retry_budget=self.retry_budget)
            return body.get("endpoint-metadata", {})

        try:
            return await fetch()
        except ValueError as exc:
            # a routed 404: the member may have moved; one forced refetch
            # of the table, one retry against the new owner
            if self._routing is None or "404" not in str(exc):
                raise
            if not await self._fetch_routing(session, force=True, member=target):
                raise
            logger.warning("routing table was stale (now v%s); refetching metadata for %s",
                           self.routing_version, target)
            self._fanout_stats["reroutes"] += 1
            return await fetch()

    async def _prefetch_metadata(self, session: Session) -> None:
        """Every target's metadata in one ``metadata-all`` request (one a
        replica with a routing table), best-effort: what it misses is
        fetched a target at a time."""
        bases = [self.base_url]
        if self._routing is not None:
            routed = [rep["url"] for rep in self._routing["replicas"].values() if rep.get("reachable", True)]
            bases = routed or bases
        bodies = await asyncio.gather(*(fetch_metadata_all(session, b, self.project) for b in bases))
        merged: Dict[str, Any] = {}
        for body in bodies:
            if body is None:
                continue
            merged.update({
                name: entry["endpoint-metadata"]
                for name, entry in body["targets"].items()
                if isinstance(entry, dict) and "endpoint-metadata" in entry
            })
        self._metadata_all = merged

    def _dataset_config_from_metadata(self, meta, start, end) -> Dict[str, Any]:
        ds_meta = meta.get("dataset", {})
        config = self.metadata_fallback_dataset or {"type": "RandomDataset"}
        if ds_meta:
            # tag dicts pass through whole (providers lay data out by
            # asset); row_filter and aggregation must match training
            config = {
                "type": ds_meta.get("type", "TimeSeriesDataset"),
                "tag_list": ds_meta.get("tag_list", []),
                "resolution": ds_meta.get("resolution", "10min"),
                "aggregation_method": ds_meta.get("aggregation_method", "mean"),
                "row_filter": ds_meta.get("row_filter", ""),
                "data_provider": ds_meta.get("data_provider"),
            }
            if ds_meta.get("target_tag_list"):
                config["target_tag_list"] = ds_meta["target_tag_list"]
            if not isinstance(config["data_provider"], dict):
                config.pop("data_provider", None)  # only a provider dict can be rebuilt
        return {**config, "train_start_date": timestamp_text(to_ns(start)),
                "train_end_date": timestamp_text(to_ns(end))}

    # ------------------------------------------------------------------ #

    def predict(self, start, end, targets: Optional[List[str]] = None) -> List[PredictionResult]:
        """Score ``start`` to ``end`` (ISO 8601 strings, datetimes or
        ``datetime64`` values; naive reads as UTC) for ``targets``, every
        target of the project when None."""
        return asyncio.run(self.predict_async(start, end, targets))

    async def predict_async(self, start, end, targets: Optional[List[str]] = None) -> List[PredictionResult]:
        sem = asyncio.Semaphore(self.parallelism)
        async with Session(limit=self._connector_limit(), timeout=600) as session:
            # the routing table first: in a mesh, base_url's /models lists
            # one partition, the table the whole fleet
            if self.routing_url is not None:
                await self._fetch_routing(session)
            models_body = None
            if (targets is None or self.use_parquet == "auto" or self.use_tensor == "auto"
                    or self.transport in ("auto", "uds", "shm")):
                try:
                    models_body = await fetch_json(session, f"{self.base_url}/gordo/v0/{self.project}/models",
                                                   retries=self.retries, backoff=self.backoff,
                                                   retry_budget=self.retry_budget)
                except Exception:
                    if targets is None and not (self._routing and self._routing["members"]):
                        raise  # discovery is mandatory without a table
                    models_body = None  # the encoding probe is best-effort
            if targets is None:
                if self._routing is not None and self._routing["members"]:
                    targets = sorted(self._routing["members"])
                else:
                    targets = models_body["models"]
            # fresh each run: cached metadata must not outlive a /reload
            self._metadata_all = {}
            if len(targets) >= _PREFETCH_MIN_TARGETS:
                await self._prefetch_metadata(session)
            accepts = (models_body or {}).get("accepts", [])
            if self.use_tensor == "auto":
                # an exact match: a foreign "x-gordo-tensor-v9" must not negotiate
                self._tensor_active = any(a == TENSOR_CONTENT_TYPE for a in accepts)
            else:
                self._tensor_active = bool(self.use_tensor)
            if self.use_parquet == "auto":
                # the port writes parquet itself: its engine is always present
                self._parquet_active = any("parquet" in a for a in accepts)
            else:
                self._parquet_active = bool(self.use_parquet)
            if self._routing is not None and len(self._routing["replicas"]) > 1:
                # fan-out across replicas rides TCP: the local rungs
                # address one co-located server
                self.transport_used = "tcp"
                self._shm_client = None
                self._data_session = None
            else:
                await self._resolve_transport(models_body)
            try:
                results = await asyncio.gather(*(self._predict_single(session, sem, t, start, end) for t in targets))
            finally:
                if self._data_session is not None:
                    await self._data_session.close()
                    self._data_session = None
                for dead in self._dead_sessions:
                    with contextlib.suppress(Exception):
                        await dead.close()
                self._dead_sessions = []
                if self._shm_client is not None:
                    self._shm_client.close()
                    self._shm_client = None
        if self.forwarder is not None:
            for result in results:
                if result.ok:
                    self.forwarder.forward(result)
        return list(results)

    @staticmethod
    def _encode_parquet(chunk: TagFrame, chunk_y: Optional[TagFrame]) -> bytes:
        """One chunk as a parquet body, the target's columns under a
        ``__y__`` prefix (the server splits them back out)."""
        names = list(chunk.columns)
        columns = {n: chunk.values[:, i] for i, n in enumerate(names)}
        if chunk_y is not None:
            for i, n in enumerate(chunk_y.columns):
                columns[f"__y__{n}"] = chunk_y.values[:, i]
                names.append(f"__y__{n}")
        return write_parquet_bytes(chunk.index, names, columns)

    async def _post_parquet(self, session: Session, target: str, endpoint: str, chunk: TagFrame,
                            chunk_y: Optional[TagFrame] = None, request_id: Optional[str] = None,
                            deadline: Optional[Deadline] = None):
        """POST one chunk as a parquet body (its index inside the file)."""
        body = await asyncio.get_running_loop().run_in_executor(None, self._encode_parquet, chunk, chunk_y)
        headers = {"Content-Type": "application/x-parquet"}
        if request_id:
            headers.update(self._trace_headers(request_id))
        resp = await fetch_json_hedged(
            session, self._chunk_urls(target, endpoint), hedge_delay_s=self._hedge_delay_s(),
            hedge_stats=self._hedge_stats, method="POST", data=body, headers=headers, retries=self.retries,
            backoff=self.backoff, retry_budget=self.retry_budget, deadline=deadline,
        )
        self._note_wire("parquet", len(body), len(chunk))
        return resp

    def _encode_tensor(self, chunk: TagFrame, chunk_y: Optional[TagFrame]) -> bytes:
        """One chunk as a framed tensor body: the float32 rows in C order,
        and the QoS identity in a ``__meta__`` frame when one is set."""
        frames = [("X", np.ascontiguousarray(chunk.values, dtype=np.float32))]
        if chunk_y is not None:
            frames.append(("y", np.ascontiguousarray(chunk_y.values, dtype=np.float32)))
        meta: Dict[str, str] = {}
        if self.tenant:
            meta["tenant"] = self.tenant
        if self.qos_class != "interactive":
            meta["priority"] = self.qos_class
        if meta:
            frames.append(("__meta__", np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)))
        return pack_frames(frames)

    def _decode_tensor_scoring_body(self, body: bytes, chunk: TagFrame, anomaly: bool) -> ResultFrame:
        """A tensor answer as the frame the JSON path builds (float32 to
        float64 is exact, so the two are bitwise alike); the index is the
        chunk's own, from the server's ``offset``."""
        frames = unpack_frames(body)
        meta = json.loads(bytes(frames.pop("__meta__")))
        offset = int(meta.get("offset", 0))
        if anomaly:
            tags = meta["tags"]
            columns = [(top, tag) for top in ANOMALY_FRAME_NAMES[:4] for tag in tags]
            columns += [(top, "") for top in ANOMALY_FRAME_NAMES[4:]]
            values = np.column_stack([frames[top].astype(np.float64) for top in ANOMALY_FRAME_NAMES])
        else:
            values = frames["data"].astype(np.float64)
            if values.ndim == 1:
                values = values[:, None]
            columns = list(range(values.shape[1]))
        return ResultFrame(values, chunk.index[offset:offset + len(values)], columns)

    async def _post_tensor(self, session: Session, target: str, endpoint: str, chunk: TagFrame,
                           chunk_y: Optional[TagFrame] = None, request_id: Optional[str] = None,
                           deadline: Optional[Deadline] = None) -> ResultFrame:
        """POST one chunk as a tensor body and decode the tensor answer."""
        body = await asyncio.get_running_loop().run_in_executor(None, self._encode_tensor, chunk, chunk_y)
        headers = {"Content-Type": TENSOR_CONTENT_TYPE}
        if request_id:
            headers.update(self._trace_headers(request_id))
        resp = await fetch_json_hedged(
            session, self._chunk_urls(target, endpoint), hedge_delay_s=self._hedge_delay_s(),
            hedge_stats=self._hedge_stats, method="POST", data=body, headers=headers, retries=self.retries,
            backoff=self.backoff, retry_budget=self.retry_budget, deadline=deadline,
        )
        if not isinstance(resp, (bytes, bytearray)):
            # a JSON 200 to a tensor POST: a foreign server that ignored
            # the content type; a rejection, so "auto" downgrades
            raise ValueError(f"server answered a tensor POST with {type(resp).__name__}, not a tensor body")
        self._note_wire("tensor", len(body), len(chunk))
        return self._decode_tensor_scoring_body(resp, chunk, anomaly=endpoint.startswith("anomaly"))

    async def _predict_single(self, session: Session, sem: asyncio.Semaphore, target: str, start,
                              end) -> PredictionResult:
        loop = asyncio.get_running_loop()
        try:
            meta = await self._get_metadata(session, target)
            config = self._dataset_config_from_metadata(meta, start, end)
            dataset = get_dataset(config)
        except Exception as exc:
            logger.exception("Failed to resolve dataset config for %s", target)
            return PredictionResult(target, None, [f"dataset: {exc}"])
        try:
            fetch = loop.run_in_executor(None, dataset.get_data)
            if self.deadline_ms is not None:
                # a hung provider must not hold a slot forever (the thread
                # runs on; the slot moves on and reports)
                try:
                    X, y = await asyncio.wait_for(fetch, timeout=self.deadline_ms / 1e3)
                except asyncio.TimeoutError:
                    logger.error("Dataset build for %s exceeded the %.0fms deadline", target, self.deadline_ms)
                    return PredictionResult(target, None,
                                            [f"dataset: build exceeded {self.deadline_ms:.0f}ms deadline"])
            else:
                X, y = await fetch
        except Exception as exc:
            logger.exception("Failed to build dataset for %s", target)
            return PredictionResult(target, None, [f"dataset: {exc}"])

        endpoint = "anomaly/prediction" if self.use_anomaly else "prediction"
        errors: List[str] = []

        async def post_chunk(chunk: TagFrame, chunk_y: Optional[TagFrame]):
            async with sem:
                # counted once a chunk attempt, not once an encoding rung
                if self._routing is not None and self._member_base_url(target) is not None:
                    self._fanout_stats["routed_chunks"] += 1
                # one id and one deadline a chunk across its downgrade re-posts
                rid = self._next_request_id()
                deadline = Deadline.after_ms(self.deadline_ms) if self.deadline_ms is not None else None
                where = f"chunk {timestamp_texts(chunk.index[:1])[0]} (rid={rid})"
                t0 = loop.time()
                tensor_exc = parquet_exc = None
                # read once: when the socket dies mid-run every sibling in
                # flight must know it was on the retired session
                data_sess = self._data_session
                if self._shm_client is not None and self._tensor_active:
                    # a ring failure sends the run down to HTTP; a 4xx is a
                    # request error (the ring only faces a gordo server)
                    try:
                        frame = await self._post_shm(target, endpoint, chunk, chunk_y, deadline=deadline)
                        self._latency.record(loop.time() - t0)
                        return frame
                    except DeadlineExceeded as exc:
                        errors.append(f"{where}: deadline: {exc}")
                        return None
                    except ValueError as exc:
                        errors.append(f"{where}: {exc}")
                        return None
                    except Exception as exc:
                        logger.warning("shm transport failed (%s); falling back to HTTP for the rest of the run", exc)
                        shm, self._shm_client = self._shm_client, None
                        self.transport_used = "uds" if self._data_session is not None else "tcp"
                        with contextlib.suppress(Exception):
                            shm.close()
                if self._tensor_active:
                    try:
                        frame = await self._post_tensor(data_sess or session, target, endpoint, chunk, chunk_y,
                                                        request_id=rid, deadline=deadline)
                        self._latency.record(loop.time() - t0)
                        return frame
                    except ClientConnectionError as exc:
                        if data_sess is None:
                            errors.append(f"{where}: {exc}")
                            return None
                        # the socket died mid-run: the run goes on over tcp
                        # and this chunk with it (a transport failure is no
                        # verdict on the encoding)
                        await self._drop_uds(exc)
                        try:
                            frame = await self._post_tensor(session, target, endpoint, chunk, chunk_y,
                                                            request_id=rid, deadline=deadline)
                            self._latency.record(loop.time() - t0)
                            return frame
                        except Exception as exc2:
                            errors.append(f"{where}: {exc2}")
                            return None
                    except ValueError as exc:
                        # a 4xx: a foreign server, or a model error any
                        # encoding would get; the posts below tell which
                        if self.use_tensor is True:
                            errors.append(f"{where}: {exc}")
                            return None
                        tensor_exc = exc
                    except Exception as exc:
                        errors.append(f"{where}: {exc}")
                        return None
                if self._parquet_active:
                    try:
                        body = await self._post_parquet(data_sess or session, target, endpoint, chunk, chunk_y,
                                                        request_id=rid, deadline=deadline)
                        self._latency.record(loop.time() - t0)
                        if tensor_exc is not None:
                            logger.warning("tensor body rejected (%s) but parquet succeeded; downgrading run",
                                           tensor_exc)
                            self._tensor_active = False
                        return body
                    except ClientConnectionError as exc:
                        if data_sess is None:
                            errors.append(f"{where}: {exc}")
                            return None
                        await self._drop_uds(exc)
                        data_sess = None
                    except ValueError as exc:
                        if self.use_parquet is True:
                            errors.append(f"{where}: {exc}")
                            return None
                        parquet_exc = exc
                    except Exception as exc:
                        errors.append(f"{where}: {exc}")
                        return None
                payload = {"X": chunk.values.tolist(), "index": timestamp_texts(chunk.index)}
                if chunk_y is not None:
                    payload["y"] = chunk_y.values.tolist()
                json_body = await loop.run_in_executor(None, functools.partial(json.dumps, payload,
                                                                               ensure_ascii=False))
                json_body = json_body.encode("utf-8")

                async def _post_json(sess):
                    return await fetch_json_hedged(
                        sess, self._chunk_urls(target, endpoint), hedge_delay_s=self._hedge_delay_s(),
                        hedge_stats=self._hedge_stats, method="POST", data=json_body,
                        headers={"Content-Type": "application/json", **self._trace_headers(rid)},
                        retries=self.retries, backoff=self.backoff, retry_budget=self.retry_budget,
                        deadline=deadline,
                    )

                try:
                    body = await _post_json(data_sess or session)
                    self._latency.record(loop.time() - t0)
                    self._note_wire("json", len(json_body), len(chunk))
                except ClientConnectionError as exc:
                    if data_sess is None:
                        errors.append(f"{where}: {exc}")
                        return None
                    await self._drop_uds(exc)
                    try:
                        body = await _post_json(session)
                        self._latency.record(loop.time() - t0)
                        self._note_wire("json", len(json_body), len(chunk))
                    except Exception as exc2:
                        errors.append(f"{where}: {exc2}")
                        return None
                except DeadlineExceeded as exc:
                    errors.append(f"{where}: deadline: {exc}")
                    return None
                except Exception as exc:
                    errors.append(f"{where}: {exc}")
                    return None
                if tensor_exc is not None:
                    logger.warning("tensor body rejected (%s) but JSON succeeded; downgrading run", tensor_exc)
                    self._tensor_active = False
                if parquet_exc is not None:
                    # JSON took what parquet was refused: the encoding,
                    # not the model (a model error fails both)
                    logger.warning("parquet body rejected (%s) but JSON succeeded; downgrading run to JSON",
                                   parquet_exc)
                    self._parquet_active = False
                return body

        # y rides along for supervised machines: the diff is against the
        # trained target
        chunks = [(_chunk(X, i, i + self.batch_size), None if y is None else _chunk(y, i, i + self.batch_size))
                  for i in range(0, len(X), self.batch_size)]
        bodies = await asyncio.gather(*(post_chunk(cx, cy) for cx, cy in chunks))
        if (self._routing is not None and any(b is None for b in bodies)
                and any("No such model" in e for e in errors)):
            # a routed chunk's 404: the member moved since the table. One
            # refetch; a changed table re-posts the failed chunks once
            if await self._fetch_routing(session, force=True, member=target):
                retry = [i for i, b in enumerate(bodies) if b is None]
                self._fanout_stats["reroutes"] += len(retry)
                logger.warning("routing table was stale (now v%s); re-posting %d chunk(s) for %s",
                               self.routing_version, len(retry), target)
                errors.clear()
                fresh = await asyncio.gather(*(post_chunk(*chunks[i]) for i in retry))
                for i, body in zip(retry, fresh):
                    bodies[i] = body
        frames: List[ResultFrame] = []
        for body in bodies:
            if body is None:
                continue
            if isinstance(body, ResultFrame):
                frames.append(body)  # the tensor path decodes to the frame itself
            elif "data" in body and isinstance(body["data"], dict):
                frames.append(_dict_frame(body))
            elif "data" in body:
                frames.append(_list_frame(body))
        predictions = ResultFrame.concat(frames) if frames else None
        return PredictionResult(target, predictions, errors)

    # ------------------------------------------------------------------ #
    # streaming forwarder
    # ------------------------------------------------------------------ #

    def ingest(self, target: str, X, timestamps=None, tensor: bool = False) -> Dict[str, int]:
        """Synchronous wrapper over :meth:`ingest_async`."""
        return asyncio.run(self.ingest_async(target, X, timestamps, tensor=tensor))

    async def ingest_async(self, target: str, X, timestamps=None, tensor: bool = False) -> Dict[str, int]:
        """Streaming forwarder: POST fresh rows to the server's
        ``.../{target}/ingest`` window buffer in ``batch_size``-row chunks,
        on the scoring path's terms: each chunk's deadline rides as
        ``X-Gordo-Deadline-Ms`` and every retry spends the shared
        :class:`RetryBudget`. NaN cells (sensor dropout) travel as JSON
        ``null``.

        ``X``: a frame (``TagFrame``/``ResultFrame``: its ``datetime64``
        index gives the event times unless ``timestamps`` does) or a (rows,
        features) array. Returns the summed accounting (``accepted``,
        ``late``, ``dropped`` rows and ``chunks`` posted) and feeds
        ``gordo_client_ingest_rows_total``.

        ``tensor=True`` posts each chunk as a framed tensor body: float32
        ``rows`` (NaN cells are the dropout) and float64 epoch-seconds
        ``timestamps``; opt-in, as the ingest path negotiates nothing.

        Delivery is at least once: a chunk whose answer was lost is
        retried and its rows ingested twice (the server's duplicate
        accounting catches exact re-sends)."""
        if hasattr(X, "values") and hasattr(X, "columns"):
            values = np.asarray(X.values)
            index = getattr(X, "index", None)
            if timestamps is None and index is not None and np.asarray(index).dtype.kind == "M":
                # only a datetime index carries event times; without one the
                # server stamps the arrival
                timestamps = timestamp_texts(index)
        else:
            values = np.asarray(X)
        epoch_ts = None
        if tensor and timestamps is not None:
            ts_list = list(timestamps)
            if ts_list and isinstance(ts_list[0], (int, float, np.integer, np.floating)):
                epoch_ts = np.asarray(ts_list, np.float64)
            else:  # ISO strings, datetimes: to ns, then seconds, as the server reads them
                epoch_ts = np.array([to_ns(t) for t in ts_list], np.int64) / 1e9
        totals = {"accepted": 0, "late": 0, "dropped": 0, "chunks": 0}
        url = self._url(target, "ingest")
        async with Session(limit=self._connector_limit(), timeout=600) as session:
            for i in range(0, len(values), self.batch_size):
                chunk = values[i: i + self.batch_size]
                rid = self._next_request_id()
                deadline = Deadline.after_ms(self.deadline_ms) if self.deadline_ms is not None else None
                if tensor:
                    frames = [("rows", np.ascontiguousarray(chunk, dtype=np.float32))]
                    if epoch_ts is not None:
                        frames.append(("timestamps", epoch_ts[i: i + self.batch_size]))
                    data = pack_frames(frames)
                    content_type, wire = TENSOR_CONTENT_TYPE, "ingest-tensor"
                else:
                    payload: Dict[str, Any] = {
                        "rows": [[None if v != v else float(v) for v in row] for row in chunk.tolist()]}
                    if timestamps is not None:
                        payload["timestamps"] = [t if isinstance(t, (int, float, str)) else str(t)
                                                 for t in list(timestamps[i: i + self.batch_size])]
                    data = json.dumps(payload).encode("utf-8")
                    content_type, wire = "application/json", "ingest-json"
                body = await fetch_json(
                    session, url, method="POST", data=data,
                    headers={"Content-Type": content_type, **self._trace_headers(rid)},
                    retries=self.retries, backoff=self.backoff, retry_budget=self.retry_budget,
                    deadline=deadline,
                )
                # its own cell: ingest bytes never mix into the scoring ones
                self._note_wire(wire, len(data), len(chunk))
                totals["chunks"] += 1
                for key in ("accepted", "late", "dropped"):
                    totals[key] += int(body.get(key, 0))
                self._ingest_stats["rows"] += int(body.get("accepted", 0))
                self._ingest_stats["chunks"] += 1
        return totals
