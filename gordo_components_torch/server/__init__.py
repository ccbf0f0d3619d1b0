"""The port's model server.

Counterpart of ``build_app``/``run_server`` in
``gordo_components_tpu/server/__init__.py``: every artifact under a model
directory is loaded into a :class:`ModelCollection` on the app's device
(the card unless ``"cpu"`` is asked for), every model the bank can hold is
stacked into one :class:`ModelBank` and scored through a
:class:`BatchingEngine`, and the others (a bare ``Pipeline`` or estimator)
are scored through their own ``predict``/``anomaly``: the per-model path.
``GORDO_SERVER_BANK=0`` (or ``use_bank=False``) serves every model on the
per-model path. The gordo HTTP routes (``views.py``) are served by the
standard library's ``ThreadingHTTPServer``. ``POST .../reload`` rescans
the directory and swaps in a rebuilt bank without a pause in serving
(``swap.py``).

Each app keeps its request counters and latency histograms (``stats``,
mutated under ``stats_lock``: the server answers each connection on its
own thread), a metrics registry (``metrics``: the bank's, the engine's
and the server's series, rendered by ``GET .../metrics``), the
quarantine breaker (``quarantine``, ``GORDO_QUARANTINE_THRESHOLD``) and
the default request deadline (``GORDO_DEFAULT_DEADLINE_MS``). As the JAX
app does, it also keeps a request tracer (``tracer``,
``GORDO_TRACE_SAMPLE``; ``GET .../traces``), the goodput ledger
(``ledger``) and the SLO tracker (``slo``) unless ``GORDO_SLO=0``, and the
per-bucket cost model (``cost``) unless ``GORDO_COST=0``, the QoS
admission controller (``admission``, always; ``GORDO_QOS_*``), the access
heat accountant (``heat``) unless ``GORDO_HEAT=0``, the event log
(``events``, always) and the metric history (``history``) when
``GORDO_HISTORY=1``. Everything that measures the age of data or events
reads the app's clock seam (``clock``, ``replay/clock.py``). The SLO
tracker and the history store sample on threads of their own and the
bank warms up on another (``GORDO_SERVER_WARMUP``); :meth:`App.close`
stops them.

``run_server`` serves one ``GordoServer`` unless a local transport or
more workers are asked for (``workers``/``GORDO_SERVER_WORKERS``,
``uds_path``/``GORDO_UDS``, ``shm_ring``/``GORDO_SHM_RING``): then a
``ServerPool`` (``workers.py``) serves the one app through N accept
loops, a Unix-socket listener and the shared-memory ring
(``transport.py``), and ``app.transports`` names the local ones.

The bank stores its weights in ``bank_dtype`` (``GORDO_BANK_DTYPE``:
``float32``, ``bfloat16`` or ``int8``; ``server/bank.py``), kept in the
app's ``bank_config`` so a ``/reload`` rebuilds at the same storage.
With ``GORDO_STREAM=1`` the app builds the streaming plane (``stream``,
``streaming/``: ``/ingest``, ``/drift``, ``/adapt`` and, with
``GORDO_PUSH=1``, ``/results/stream``), whose loops run on threads of
their own until :meth:`App.close`; with the default ``GORDO_STREAM=0``
``stream`` is None and nothing of it is built.

``build_app`` arms the fault points that ``GORDO_FAULTS`` names
(``resilience/faults.py``; the server's sites are ``model_io.load``,
``bank.finalize``, ``bank.score``, ``engine.queue``, ``bank.swap`` and
``server.connection``) and installs the process's fire listener before
the collection loads, so every fire from then on lands in the app's event
log as ``fault.fired``; :meth:`App.close` removes the listener if it is
still the app's.

The bank may be sharded over a mesh (``devices``/``GORDO_SERVER_DEVICES``:
0 or -1 every card, a count above the cards present clamps with a
warning; ``parallel/mesh.py``), and with the bank on the app keeps its
placement controller (``placement``, ``placement/controller.py``: ``GET
.../placement``, ``POST .../rebalance``, ``GORDO_REBALANCE=auto``). With
``GORDO_MESH_REPLICA_ID`` and ``GORDO_MESH_REPLICAS`` the app is one
replica of the serving mesh (``mesh``, ``parallel/distributed.py``): its
collection owns its partition of the members under the model directory,
and the mesh routes (``.../mesh``, ``.../mesh/acquire``,
``.../mesh/release``, ``.../mesh/member/<t>/artifact``) move members
between replicas.
"""

import logging

import os
import threading
import time
from typing import Optional

import torch

from gordo_components_torch.observability.cost import cost_from_env
from gordo_components_torch.parallel.distributed import MeshIdentity, bootstrap_serving_mesh
from gordo_components_torch.parallel import mesh as mesh_module
from gordo_components_torch.observability.events import EventLog
from gordo_components_torch.observability.goodput import GoodputLedger
from gordo_components_torch.observability.heat import HeatAccountant, heat_from_env
from gordo_components_torch.observability.metrics import MetricsRegistry
from gordo_components_torch.observability.slo import SLOTracker
from gordo_components_torch.observability.timeseries import history_from_env
from gordo_components_torch.observability.tracing import Tracer
from gordo_components_torch.qos.admission import AdmissionController
from gordo_components_torch.replay.clock import SYSTEM_CLOCK, Clock
from gordo_components_torch.resilience import faults
from gordo_components_torch.resilience.deadline import default_deadline_ms
from gordo_components_torch.resilience.quarantine import DEFAULT_THRESHOLD, QuarantineSet
from gordo_components_torch.server.bank import ModelBank, ScoreResult
from gordo_components_torch.server.engine import BatchingEngine, EngineOverloaded
from gordo_components_torch.server.model_io import ModelCollection, scan_artifacts
from gordo_components_torch.server.swap import warmup_enabled
from gordo_components_torch.server.views import GordoServer
from gordo_components_torch.server.workers import ServerPool, resolve_workers
from gordo_components_torch.streaming.adapt import StreamingPlane, stream_enabled
from gordo_components_torch.utils.profiling import device_memory_stats

logger = logging.getLogger(__name__)


class App:
    """What a server serves: the collection, its bank and the bank's
    engine (``bank`` and ``engine`` are None when the bank is off; the
    engine is None while the bank holds no model), and what it observes.
    ``reload_lock`` serializes reloads, each of which may swap the bank;
    ``stats_lock`` guards ``stats``. ``ledger`` (and with it ``slo``) is
    None when ``GORDO_SLO=0``, ``cost`` when ``GORDO_COST=0``, ``heat``
    when ``GORDO_HEAT=0`` and ``history`` unless ``GORDO_HISTORY=1``.
    ``placement`` is the placement controller (None with the bank off),
    ``mesh`` the serving mesh identity (None outside mesh mode)."""

    def __init__(self, collection: ModelCollection, bank: Optional[ModelBank],
                 bank_config: dict, engine_config: dict, metrics: MetricsRegistry,
                 quarantine: QuarantineSet, default_deadline_ms: Optional[float],
                 tracer: Optional[Tracer] = None, ledger: Optional[GoodputLedger] = None,
                 clock: Clock = SYSTEM_CLOCK, heat: Optional[HeatAccountant] = None,
                 events: Optional[EventLog] = None, fault_listener=None,
                 mesh: Optional[MeshIdentity] = None):
        self.collection = collection
        self.bank = bank
        self.mesh = mesh
        self.bank_config = bank_config
        self.engine_config = engine_config
        self.engine: Optional[BatchingEngine] = None
        self.reload_lock = threading.Lock()
        self.stats_lock = threading.Lock()
        self.stats = {
            "started_at": time.time(),
            "requests": {},  # kind -> count
            "errors": 0,
            "latency": {},  # kind -> LatencyHistogram
            "wire": {"requests": {}, "bytes": {}},  # scoring POSTs by encoding
            "workers": {},  # requests a worker of a pool (workers.py)
            # kind -> latency bucket edge -> the last retained trace there
            "exemplars": {},
        }
        # the armed local transports, by kind ("uds", "shm"): /models and
        # /stats advertise them
        self.transports: dict = {}
        self.metrics = metrics
        self.quarantine = quarantine
        self.default_deadline_ms = default_deadline_ms
        self.device = torch.device(collection.device)
        self.metrics.collector(_server_collector(self), key="server")
        self.metrics.collector(_hbm_collector(self.device), key="hbm")
        self.tracer = tracer
        self.ledger = ledger
        self.clock = clock
        # window ages read the seam: a replayed "5m" window spans 5
        # replayed minutes
        self.slo = SLOTracker(ledger, registry=metrics, clock=clock.monotonic) if ledger is not None else None
        self.cost = cost_from_env(ledger, lambda: self.bank, registry=metrics, device=self.device, clock=clock)
        # always built: with no tenants it costs one depth comparison a request
        self.admission = AdmissionController.from_env()
        self.admission.install_collector(metrics)
        if self.slo is not None:
            self.admission.burn_for = self.slo.class_burn
        # the app's, fed by every bank generation (bank_config carries it)
        self.heat = heat
        self.events = events if events is not None else EventLog(clock=clock)
        self.events.attach_registry(metrics)
        # the process's fault listener, installed by build_app for this app
        self._fault_listener = fault_listener
        # the placement controller's series exist before the history's
        # baseline sample, as in the JAX app
        self.placement = None
        if bank is not None:
            # imported here: the placement package imports the server's swap
            from gordo_components_torch.placement.controller import PlacementController

            self.placement = PlacementController(self)
        self.history = history_from_env(metrics, clock=clock)
        self._history_stop = threading.Event()
        self._history_thread: Optional[threading.Thread] = None
        self._warmup: Optional[threading.Thread] = None
        if self.slo is not None:
            self.slo.start()
        if self.history is not None:
            self._start_history()
        if bank is not None and len(bank):
            self.engine = BatchingEngine(bank, **engine_config)
            self.engine.start()
            if warmup_enabled():
                # off the request path: the port answers while it runs
                self._warmup = threading.Thread(target=bank.warmup, name="gordo-bank-warmup", daemon=True)
                self._warmup.start()
        if self.placement is not None:
            self.placement.start()
        # the streaming plane (GORDO_STREAM=1): none of it otherwise
        self.stream: Optional[StreamingPlane] = StreamingPlane(self) if stream_enabled() else None
        if self.stream is not None:
            self.stream.start()

    def _start_history(self) -> None:
        """A baseline sample (rates start on the second), then a daemon
        thread sampling every ``interval_s`` of the seam's seconds."""
        store = self.history
        store.sample()
        real_sleep = store.interval_s / max(1.0, self.clock.timescale)

        def tick():
            while not self._history_stop.wait(real_sleep):
                store.sample()

        self._history_thread = threading.Thread(target=tick, name="gordo-history-sampler", daemon=True)
        self._history_thread.start()

    def generation(self) -> Optional[int]:
        """The serving bank's generation; None with the bank off."""
        bank = self.bank
        return bank.generation if bank is not None else None

    def close(self) -> None:
        _remove_fault_listener(self._fault_listener)
        if self.placement is not None:
            self.placement.stop()
        if self.stream is not None:
            self.stream.stop()
        if self.engine is not None:
            self.engine.stop()
        if self.slo is not None:
            self.slo.stop()
        if self._history_thread is not None:
            self._history_stop.set()
            self._history_thread.join(10.0)
            self._history_thread = None
        if self._warmup is not None:
            self._warmup.join()


def _remove_fault_listener(listener) -> None:
    """Clear the process's fire listener if it is still ``listener`` (a
    later app may own it by now)."""
    if listener is not None and faults._FIRE_LISTENER is listener:
        faults.set_fire_listener(None)


def _server_collector(app: App):
    """The app's counters as series, read at render time from the same
    cells ``/stats`` reports (JAX ``_server_collector``). The worker series
    have samples in a pool alone, the ring's only once it is armed."""

    def collect():
        with app.stats_lock:
            stats = app.stats
            started = stats["started_at"]
            requests = dict(stats["requests"])
            errors = stats["errors"]
            wire_requests = dict(stats["wire"]["requests"])
            wire_bytes = dict(stats["wire"]["bytes"])
            latency = dict(stats["latency"])
            workers = dict(stats["workers"])
            shm = dict(stats["shm"]) if "shm" in stats else None
        yield ("gordo_server_uptime_seconds", "gauge", "Seconds since server start", {},
               time.time() - started)
        for kind, n in requests.items():
            yield ("gordo_server_requests_total", "counter", "HTTP requests by endpoint kind",
                   {"kind": kind}, n)
        yield ("gordo_server_errors_total", "counter", "HTTP responses with status >= 400", {}, errors)
        # a scoring POST counts under {kind} and under {encoding}: sum by one
        # label, never over the whole family
        for enc, n in wire_requests.items():
            yield ("gordo_server_requests_total", "counter",
                   "Scoring/ingest POSTs by wire encoding (second label dimension of requests_total)",
                   {"encoding": enc}, n)
        for enc, n in wire_bytes.items():
            yield ("gordo_server_request_bytes_total", "counter",
                   "Scoring/ingest request body bytes by wire encoding", {"encoding": enc}, n)
        for worker, n in sorted(workers.items()):
            yield ("gordo_server_worker_requests_total", "counter", "HTTP requests parsed per worker event loop",
                   {"worker": worker}, n)
        if shm is not None:
            yield ("gordo_shm_requests_total", "counter", "Scoring requests served over the shared-memory ring",
                   {}, shm["requests"])
            yield ("gordo_shm_errors_total", "counter",
                   "Shared-memory ring requests answered with an error status", {}, shm["errors"])
        for kind, hist in latency.items():
            yield ("gordo_server_request_seconds", "histogram", "Service time by endpoint kind",
                   {"kind": kind}, hist)
        collection = app.collection
        yield ("gordo_server_models", "gauge", "Models loaded in the collection", {},
               len(collection.models))
        yield ("gordo_models_load_failed_total", "counter",
               "Artifact load attempts that failed (corrupt/mid-write)", {}, collection.load_failed_total)
        yield ("gordo_models_load_failed", "gauge", "Artifacts failing to load as of the latest scan", {},
               len(collection.load_failures))
        yield ("gordo_quarantined_models", "gauge",
               "Models evicted from routing by the scoring-failure breaker (410 until cleared)", {},
               len(app.quarantine))

    return collect


def _hbm_collector(device):
    """The card's memory as gauges, read at each scrape: the numbers
    ``utils/profiling.device_memory_stats`` records into build metadata
    (``torch.cuda.memory_allocated``, the total of ``mem_get_info`` and
    ``max_memory_allocated`` of the app's device). An app on the CPU gives
    no samples, as the JAX package's CPU devices report none."""

    def collect():
        for dev, stats in device_memory_stats(device).items():
            for key in ("bytes_in_use", "bytes_limit", "peak_bytes_in_use"):
                yield (f"gordo_device_hbm_{key}", "gauge", "Per-device HBM memory (bytes)", {"device": dev},
                       stats[key])

    return collect


def build_app(
    model_dir: str,
    target_name: Optional[str] = None,
    bank_flush_ms: float = 2.0,
    bank_max_batch: int = 64,
    bank_max_queue: Optional[int] = None,
    max_rows_per_call: int = 8192,
    use_bank: Optional[bool] = None,
    device="cuda",
    quarantine_threshold: Optional[int] = None,
    bank_inflight: Optional[int] = None,
    arena_max_mb: Optional[float] = None,
    clock: Optional[Clock] = None,
    bank_dtype: Optional[str] = None,
    devices: Optional[int] = None,
) -> App:
    """Load every artifact under ``model_dir`` on ``device`` (default the
    card; raises without CUDA unless ``"cpu"``), stack the models the bank
    can hold and start its batching engine. ``use_bank`` defaults to the
    environment's ``GORDO_SERVER_BANK`` != ``"0"``, ``quarantine_threshold``
    to ``GORDO_QUARANTINE_THRESHOLD`` (3; 0 or less disables the breaker),
    and the requests' default deadline is ``GORDO_DEFAULT_DEADLINE_MS``.
    ``bank_inflight`` (``GORDO_BANK_INFLIGHT``) and ``arena_max_mb``
    (``GORDO_ARENA_MAX_MB``) configure the bank's pipeline, ``bank_dtype``
    (``GORDO_BANK_DTYPE``, default ``"float32"``) its weights' storage.
    ``clock`` is the app's clock seam (default the real one,
    ``SYSTEM_CLOCK``). ``devices`` (``GORDO_SERVER_DEVICES``; 0 or -1 every
    device ``parallel/mesh.available_devices`` lists, the default) shards
    the bank over that many devices of ``device``'s kind; a count above
    those present clamps with a warning, and one device is no mesh.
    ``GORDO_MESH_REPLICA_ID``/``GORDO_MESH_REPLICAS`` make the app one
    replica of the serving mesh, owning its partition of the members."""
    from gordo_components_torch.device import resolve_device

    device = resolve_device(device)
    if use_bank is None:
        use_bank = os.environ.get("GORDO_SERVER_BANK", "1") != "0"
    if devices is None:
        raw = os.environ.get("GORDO_SERVER_DEVICES", "0") or "0"
        try:
            devices = int(raw)
        except ValueError:
            raise ValueError(f"GORDO_SERVER_DEVICES must be an integer, got {raw!r} "
                             "(0/unset = all available devices)") from None
    mesh = None
    if use_bank and devices != 1:
        avail = len(mesh_module.available_devices(device.type))
        want = avail if devices in (0, -1) else min(devices, avail)
        if devices > avail:
            logger.warning("GORDO_SERVER_DEVICES=%d but only %d device(s) present; sharding the bank over %d",
                           devices, avail, want)
        if want > 1:
            mesh = mesh_module.fleet_mesh(want, kind=device.type)
    mesh_identity = bootstrap_serving_mesh()
    owned = None
    if mesh_identity is not None:
        roster = sorted(scan_artifacts(model_dir, target_name))
        owned = mesh_identity.partition(roster)
        logger.info("mesh replica %d/%d owns %d of %d member(s)", mesh_identity.replica_id,
                    mesh_identity.replica_count, len(owned), len(roster))
    if quarantine_threshold is None:
        raw = os.environ.get("GORDO_QUARANTINE_THRESHOLD", str(DEFAULT_THRESHOLD))
        try:
            quarantine_threshold = int(raw)
        except ValueError:
            raise ValueError(f"GORDO_QUARANTINE_THRESHOLD must be an integer, got {raw!r} "
                             "(consecutive scoring failures before eviction; <=0 disables)") from None
    deadline_ms = default_deadline_ms()
    if clock is None:
        clock = SYSTEM_CLOCK
    faults.configure_from_env()  # GORDO_FAULTS
    events = EventLog(clock=clock, replica=None if mesh_identity is None else f"replica-{mesh_identity.replica_id}")
    owner: dict = {}  # the app, once built: its bank generation rides on each event

    def on_fault_fire(site: str, spec) -> None:
        app = owner.get("app")
        events.emit("fault.fired", severity="warning", generation=app.generation() if app else None,
                    site=site, fired=spec.fired)

    # the most recent app owns the process-wide seam
    faults.set_fire_listener(on_fault_fire)
    try:
        collection = ModelCollection(model_dir, target_name, device=device, owned=owned)
        registry = MetricsRegistry()
        tracer = Tracer()
        ledger = GoodputLedger.from_env(registry)
        heat = heat_from_env(registry, clock=clock)
        # the registry, the ledger and heat ride in the bank's settings, so a
        # /reload's bank records into the same series and cells
        bank_config = {"max_rows_per_call": max_rows_per_call, "device": device, "registry": registry,
                       "inflight": bank_inflight, "arena_max_mb": arena_max_mb, "ledger": ledger, "heat": heat,
                       "bank_dtype": bank_dtype, "mesh": mesh}
        bank = ModelBank.from_models(collection.models, **bank_config) if use_bank else None
        if bank is not None:
            # the bank owns the env default: a /reload rebuilds at its storage
            bank_config["bank_dtype"] = bank.bank_dtype
        engine_config = {"max_batch": bank_max_batch, "flush_ms": bank_flush_ms, "max_queue": bank_max_queue}
        app = App(collection, bank, bank_config, engine_config, registry, QuarantineSet(quarantine_threshold),
                  deadline_ms, tracer=tracer, ledger=ledger, clock=clock, heat=heat, events=events,
                  fault_listener=on_fault_fire, mesh=mesh_identity)
    except BaseException:
        _remove_fault_listener(on_fault_fire)
        raise
    owner["app"] = app
    return app


def run_server(
    model_dir: str,
    host: str = "0.0.0.0",
    port: int = 5555,
    target_name: Optional[str] = None,
    device="cuda",
    background: bool = False,
    use_bank: Optional[bool] = None,
    workers: Optional[int] = None,
    uds_path: Optional[str] = None,
    shm_ring: Optional[str] = None,
    **app_kwargs,
):
    """Serve ``model_dir`` on ``host:port`` (``port=0`` picks a free one).

    ``workers`` (``GORDO_SERVER_WORKERS``, default 1) accept loops,
    ``uds_path`` (``GORDO_UDS``) a Unix-socket listener and ``shm_ring``
    (``GORDO_SHM_RING``, with ``GORDO_SHM_SLOTS`` and
    ``GORDO_SHM_SLOT_MB``) the shared-memory ring: with none of them the
    server is one :class:`GordoServer`, else a
    :class:`~.workers.ServerPool`. Blocks until interrupted, or with
    ``background=True`` returns the running server (its ``url`` says where
    it listens, its ``app`` what it serves; its ``close()`` stops it).
    ``use_bank`` and ``app_kwargs`` go to :func:`build_app`."""
    workers = resolve_workers(workers)
    if uds_path is None:
        uds_path = os.environ.get("GORDO_UDS") or None
    if shm_ring is None:
        shm_ring = os.environ.get("GORDO_SHM_RING") or None
    app = build_app(model_dir, target_name=target_name, device=device, use_bank=use_bank,
                    **app_kwargs)
    try:
        if workers == 1 and not uds_path and not shm_ring:
            server = GordoServer(app, host, port)
        else:
            server = ServerPool(app, host, port, workers=workers, uds_path=uds_path, shm_ring=shm_ring)
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


__all__ = [
    "App", "BatchingEngine", "EngineOverloaded", "GordoServer", "ModelBank",
    "ModelCollection", "ScoreResult", "ServerPool", "build_app", "run_server", "scan_artifacts",
]
