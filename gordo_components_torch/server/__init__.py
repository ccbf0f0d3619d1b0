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

Not in this slice: the tensor wire format, QoS, deadlines, quarantine,
tracing, metrics, the placement planner and the shared-memory transports.
"""

import os
import threading
from typing import Optional

from gordo_components_torch.server.bank import ModelBank, ScoreResult
from gordo_components_torch.server.engine import BatchingEngine, EngineOverloaded
from gordo_components_torch.server.model_io import ModelCollection, scan_artifacts
from gordo_components_torch.server.views import GordoServer


class App:
    """What a server serves: the collection, its bank and the bank's
    engine (``bank`` and ``engine`` are None when the bank is off; the
    engine is None while the bank holds no model). ``reload_lock``
    serializes reloads, each of which may swap the bank."""

    def __init__(self, collection: ModelCollection, bank: Optional[ModelBank],
                 bank_config: dict, engine_config: dict):
        self.collection = collection
        self.bank = bank
        self.bank_config = bank_config
        self.engine_config = engine_config
        self.engine: Optional[BatchingEngine] = None
        self.reload_lock = threading.Lock()
        if bank is not None and len(bank):
            self.engine = BatchingEngine(bank, **engine_config)
            self.engine.start()

    def close(self) -> None:
        if self.engine is not None:
            self.engine.stop()


def build_app(
    model_dir: str,
    target_name: Optional[str] = None,
    bank_flush_ms: float = 2.0,
    bank_max_batch: int = 64,
    bank_max_queue: Optional[int] = None,
    max_rows_per_call: int = 8192,
    use_bank: Optional[bool] = None,
    device="cuda",
) -> App:
    """Load every artifact under ``model_dir`` on ``device`` (default the
    card; raises without CUDA unless ``"cpu"``), stack the models the bank
    can hold and start its batching engine. ``use_bank`` defaults to the
    environment's ``GORDO_SERVER_BANK`` != ``"0"``."""
    from gordo_components_torch.device import resolve_device

    device = resolve_device(device)
    if use_bank is None:
        use_bank = os.environ.get("GORDO_SERVER_BANK", "1") != "0"
    collection = ModelCollection(model_dir, target_name, device=device)
    bank_config = {"max_rows_per_call": max_rows_per_call, "device": device}
    bank = ModelBank.from_models(collection.models, **bank_config) if use_bank else None
    engine_config = {"max_batch": bank_max_batch, "flush_ms": bank_flush_ms, "max_queue": bank_max_queue}
    return App(collection, bank, bank_config, engine_config)


def run_server(
    model_dir: str,
    host: str = "0.0.0.0",
    port: int = 5555,
    target_name: Optional[str] = None,
    device="cuda",
    background: bool = False,
    use_bank: Optional[bool] = None,
    **app_kwargs,
) -> Optional[GordoServer]:
    """Serve ``model_dir`` on ``host:port`` (``port=0`` picks a free one).

    Blocks until interrupted, or with ``background=True`` returns the
    running :class:`GordoServer` (its ``url`` says where it listens; its
    ``close()`` stops it). ``use_bank`` and ``app_kwargs`` go to
    :func:`build_app`."""
    app = build_app(model_dir, target_name=target_name, device=device, use_bank=use_bank,
                    **app_kwargs)
    try:
        server = GordoServer(app, host, port)
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
    "ModelCollection", "ScoreResult", "build_app", "run_server", "scan_artifacts",
]
