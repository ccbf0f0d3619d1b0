"""Zero-downtime bank swap.

Counterpart of ``build_bank`` and ``swap_bank`` in
``gordo_components_tpu/placement/swap.py``, for the port's one-device
bank. ``POST .../reload`` builds the new bank to the side with
:func:`build_bank` (``ModelBank.from_models`` over the collection's current
models, with the app's bank settings, then its warm-up unless
``GORDO_SERVER_WARMUP=0``) while the old bank keeps serving, then
:func:`swap_bank` flips ``app.bank`` and ``engine.bank`` to it, one
generation above the old one. The warm-up runs the new bank's buckets at
the warm shapes before the flip, so its arena holds their page-locked
buffers before its first request (on the card the first groups after a
flip would otherwise pay those allocations on the request path). The engine reads its bank once a batch, so a
batch in flight drains on the old bank and the next one scores on the new;
no request sees a torn state. If the build fails, nothing is flipped and
the old bank keeps serving. The old bank is freed when its last batch lets
go of it.

The new bank is built with the app's metrics registry, so its bucket
counters go on from the old bank's and its gauges read the new bank; the
engine, which keeps its collector, is the same across the swap. Building
a bank replaces the registry's bank collectors (the pipeline's and the
capacity's): :func:`snapshot_collectors` takes them before a build and
:func:`restore_collectors` puts them back, so a build or flip that fails
leaves the old generation's series as they were (the streaming plane's
rollback, JAX ``placement/swap.py:77-100``).

Not in this slice: the placement planner's member order and per-model row
counts (heat, ``observability/heat.py``, is the load signal that survives
a swap) and the multi-worker engines.
"""

import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

from gordo_components_torch.resilience.faults import faultpoint
from gordo_components_torch.server.bank import ModelBank
from gordo_components_torch.server.engine import BatchingEngine

logger = logging.getLogger(__name__)

# a flip that fails leaves the old generation serving
_FP_SWAP = faultpoint("bank.swap")

# the registry collectors a bank generation owns (JAX _BANK_COLLECTOR_KEYS)
BANK_COLLECTOR_KEYS = ("bank_pipeline", "bank_capacity", "bank_heat", "bank_cost")


@dataclass
class SwapResult:
    generation: int
    pause_s: float  # the flip's wall time
    bank_models: int
    build_s: float = 0.0  # the new bank's build, before the flip
    warmup_s: float = 0.0  # its warm-up, before the flip


def warmup_enabled() -> bool:
    """``GORDO_SERVER_WARMUP`` != ``"0"``: the server's start and every
    reload warm their bank."""
    return os.environ.get("GORDO_SERVER_WARMUP", "1") != "0"


def snapshot_collectors(registry) -> Optional[Dict[str, Any]]:
    """The bank-owned collectors of ``registry``, taken before a new bank's
    build overwrites them."""
    if registry is None:
        return None
    return {key: registry.get_collector(key) for key in BANK_COLLECTOR_KEYS}


def restore_collectors(registry, prev: Optional[Dict[str, Any]]) -> None:
    """Put back the collectors :func:`snapshot_collectors` took."""
    if registry is None or not prev:
        return
    for key, fn in prev.items():
        if fn is not None:
            registry.collector(fn, key=key)


def build_bank(app) -> ModelBank:
    """The bank of the collection's current models with the app's bank
    settings, warmed unless ``GORDO_SERVER_WARMUP=0``; the old bank serves
    meanwhile. ``build_s`` and ``warmup_s`` are recorded on it. A warm-up
    that raises fails the build."""
    t0 = time.monotonic()
    bank = ModelBank.from_models(app.collection.models, **app.bank_config)
    bank.build_s = time.monotonic() - t0
    t1 = time.monotonic()
    if warmup_enabled() and len(bank):
        bank.warmup()
    bank.warmup_s = time.monotonic() - t1
    return bank


def swap_bank(app, new_bank: ModelBank, prev_collectors: Optional[Dict[str, Any]] = None) -> SwapResult:
    """Flip the app to ``new_bank``, its generation one above the old
    bank's; the caller holds ``app.reload_lock``. The engine starts here
    when the first bank with members arrives; if that fails, the old bank
    and engine stay, ``prev_collectors`` (from :func:`snapshot_collectors`)
    are put back, and the app's event log gets ``bank.swap_failed``.
    Every flip emits one ``bank.swap``."""
    old_bank = app.bank
    events = getattr(app, "events", None)
    t0 = time.monotonic()
    generation = old_bank.generation + 1
    new_bank.generation = generation
    try:
        _FP_SWAP.fire()
        # the engine first: until app.bank flips, a request routes by the
        # old bank, so a target it holds is in both banks and a new one
        # goes to the per-model path
        if app.engine is not None:
            app.engine.bank = new_bank  # batches in flight keep the old one
        elif len(new_bank):
            engine = BatchingEngine(new_bank, **app.engine_config)
            engine.start()
            app.engine = engine
        app.bank = new_bank
    except BaseException:
        restore_collectors(getattr(app, "metrics", None), prev_collectors)
        logger.error("bank swap to generation %d failed; generation %d keeps serving", generation,
                     old_bank.generation, exc_info=True)
        if events is not None:
            events.emit("bank.swap_failed", severity="error", generation=old_bank.generation, attempted=generation)
        raise
    pause_s = time.monotonic() - t0
    logger.info("bank swapped to generation %d (%d model(s), flip pause %.3f ms)",
                generation, len(new_bank), pause_s * 1e3)
    if events is not None:
        events.emit("bank.swap", generation=generation, models=len(new_bank), pause_ms=round(pause_s * 1e3, 3))
    return SwapResult(new_bank.generation, pause_s, len(new_bank), new_bank.build_s, new_bank.warmup_s)
