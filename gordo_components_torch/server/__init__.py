"""The port's model server.

Counterpart of ``build_app``/``run_server`` in
``gordo_components_tpu/server/__init__.py``: the artifacts under a model
directory are stacked into one :class:`ModelBank` on the card and scored
through a :class:`BatchingEngine` behind the gordo HTTP routes
(``views.py``), served by the standard library's ``ThreadingHTTPServer``.

Not in this slice: the tensor wire format, QoS, deadlines, tracing, the
shared-memory transports and the per-model route for models the bank
cannot hold.
"""

from typing import Optional

from gordo_components_torch.server.bank import ModelBank, ScoreResult
from gordo_components_torch.server.engine import BatchingEngine, EngineOverloaded
from gordo_components_torch.server.model_io import ModelCollection, scan_artifacts
from gordo_components_torch.server.views import GordoServer


class App:
    """What a server serves: the collection, its bank and the engine."""

    def __init__(self, collection: ModelCollection, bank: ModelBank, engine: BatchingEngine):
        self.collection = collection
        self.bank = bank
        self.engine = engine

    def close(self) -> None:
        self.engine.stop()


def build_app(
    model_dir: str,
    target_name: Optional[str] = None,
    bank_flush_ms: float = 2.0,
    bank_max_batch: int = 64,
    bank_max_queue: Optional[int] = None,
    max_rows_per_call: int = 8192,
    device="cuda",
) -> App:
    """Load every artifact under ``model_dir`` into a bank on ``device``
    (default the card; raises without CUDA unless ``"cpu"``) and start its
    batching engine."""
    collection = ModelCollection(model_dir, target_name)
    bank = ModelBank.from_entries(
        list(collection.entries.values()), max_rows_per_call=max_rows_per_call, device=device
    )
    engine = BatchingEngine(bank, max_batch=bank_max_batch, flush_ms=bank_flush_ms,
                            max_queue=bank_max_queue)
    engine.start()
    return App(collection, bank, engine)


def run_server(
    model_dir: str,
    host: str = "0.0.0.0",
    port: int = 5555,
    target_name: Optional[str] = None,
    device="cuda",
    background: bool = False,
    **app_kwargs,
) -> Optional[GordoServer]:
    """Serve ``model_dir`` on ``host:port`` (``port=0`` picks a free one).

    Blocks until interrupted, or with ``background=True`` returns the
    running :class:`GordoServer` (its ``url`` says where it listens; its
    ``close()`` stops it)."""
    app = build_app(model_dir, target_name=target_name, device=device, **app_kwargs)
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
