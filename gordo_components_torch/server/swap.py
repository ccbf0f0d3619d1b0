"""Zero-downtime bank swap.

Counterpart of ``gordo_components_tpu/placement/swap.py`` (the one copy of
the swap in the port; ``placement`` re-exports it). ``POST .../reload``, a
rebalance, a mesh acquire or release and the streaming plane's adaptations
all build the new bank to the side with :func:`build_bank`
(``ModelBank.from_models`` over the collection's current models, in a
planned member order when given, with the app's bank settings and mesh,
then its warm-up unless ``GORDO_SERVER_WARMUP=0``) while the old bank keeps
serving, then :func:`swap_bank` flips ``engine.bank`` and ``app.bank`` to
it, one generation above the old one. The warm-up runs the new bank's
buckets at the warm shapes before the flip, so its arena holds their
page-locked buffers before its first request (on the card the first groups
after a flip would otherwise pay those allocations on the request path).
The engine reads its bank once a batch, so a batch in flight drains on the
old bank and the next one scores on the new; no request sees a torn state.
:func:`wait_drained` waits, bounded, for the old bank's groups in flight to
reach zero. The old bank is freed when its last batch lets go of it.

Bucket membership follows each model's architecture; the order of the
members within a bucket (their stack index, hence their shard) follows
insertion, so :func:`ordered_models` realises a plan's member order by
putting the planned members first; the others keep their order. The new
bank takes over the old bank's per-member routed rows (``model_rows``),
the planner's load signal.

The new bank is built with the app's metrics registry, so its bucket
counters go on from the old bank's and its gauges read the new bank; the
engine, which keeps its collector, is the same across the swap. Building
a bank replaces the registry's bank collectors (the pipeline's and the
capacity's) and points its gauges (``gordo_bank_models``,
``gordo_bank_buckets``) at itself: :func:`snapshot_collectors` takes both
before a build and :func:`restore_collectors` puts them back, so a build or
flip that fails leaves the old generation's series as they were (JAX
``placement/swap.py:77-100``, whose gauges a failed build leaves on the
stillborn bank). The ``bank.swap`` fault point fires between
the engine's flip and the app's, the worst instant: a failure there rolls
both pointers (and a just-started engine) back to the old generation.
"""

import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional

from gordo_components_torch.resilience.faults import faultpoint
from gordo_components_torch.server.bank import ModelBank
from gordo_components_torch.server.engine import BatchingEngine

logger = logging.getLogger(__name__)

# a flip that fails leaves the old generation serving
_FP_SWAP = faultpoint("bank.swap")

# the registry collectors a bank generation owns (JAX _BANK_COLLECTOR_KEYS),
# and its read-through gauges, which a new bank's build points at itself
BANK_COLLECTOR_KEYS = ("bank_pipeline", "bank_capacity", "bank_heat", "bank_cost")
BANK_GAUGES = ("gordo_bank_models", "gordo_bank_buckets")


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
    """The bank-owned collectors of ``registry`` and the functions of its
    bank gauges (under ``gauge:<name>``), taken before a new bank's build
    overwrites them."""
    if registry is None:
        return None
    prev = {key: registry.get_collector(key) for key in BANK_COLLECTOR_KEYS}
    for name in BANK_GAUGES:
        family = registry.get_family(name)
        if family is not None:
            prev["gauge:" + name] = family.labels()._fn
    return prev


def restore_collectors(registry, prev: Optional[Dict[str, Any]]) -> None:
    """Put back what :func:`snapshot_collectors` took."""
    if registry is None or not prev:
        return
    for key, fn in prev.items():
        if fn is None:
            continue
        if key.startswith("gauge:"):
            registry.gauge(key[len("gauge:"):]).labels().set_function(fn)
        else:
            registry.collector(fn, key=key)


def ordered_models(models: Mapping[str, Any], member_order: Optional[Mapping[str, List[str]]]) -> Dict[str, Any]:
    """``models`` in a plan's stacking order: the planned members of every
    bucket first, in their order, then the others in theirs; a planned
    name no longer present is skipped."""
    if not member_order:
        return dict(models)
    planned: List[str] = []
    seen = set()
    for names in member_order.values():
        for name in names:
            if name in models and name not in seen:
                planned.append(name)
                seen.add(name)
    out = {name: models[name] for name in planned}
    for name, model in models.items():
        if name not in seen:
            out[name] = model
    return out


def build_bank(app, models: Optional[Mapping[str, Any]] = None,
               member_order: Optional[Mapping[str, List[str]]] = None,
               warmup: Optional[bool] = None) -> ModelBank:
    """The bank of ``models`` (default the collection's current models), in
    ``member_order`` when given, with the app's bank settings and mesh,
    warmed unless ``warmup`` is False (default: ``GORDO_SERVER_WARMUP`` !=
    ``"0"``); the old bank serves meanwhile and its per-member routed rows
    carry over. ``build_s`` and ``warmup_s`` are recorded on it. A warm-up
    that raises fails the build."""
    t0 = time.monotonic()
    if models is None:
        models = app.collection.models
    bank = ModelBank.from_models(ordered_models(models, member_order), **app.bank_config)
    bank.build_s = time.monotonic() - t0
    old = app.bank
    if old is not None and old.model_rows and bank.model_rows is not None:
        # one copy: scoring threads insert into the old bank's live dict
        for name, rows in old.model_rows.copy().items():
            if name in bank:
                bank.model_rows[name] = rows
    if warmup is None:
        warmup = warmup_enabled()
    t1 = time.monotonic()
    if warmup and len(bank):
        bank.warmup()
    bank.warmup_s = time.monotonic() - t1
    return bank


def swap_bank(app, new_bank: ModelBank, prev_collectors: Optional[Dict[str, Any]] = None) -> SwapResult:
    """Flip the app to ``new_bank``, its generation one above the old
    bank's; the caller holds ``app.reload_lock``. The engine starts here
    when the first bank with members arrives. If the flip fails, the app's
    and the engine's bank pointers go back to the old bank (a just-started
    engine stops), ``prev_collectors`` (from :func:`snapshot_collectors`)
    are put back, the app's event log gets ``bank.swap_failed``, and the
    error propagates. Every flip emits one ``bank.swap``."""
    old_bank = app.bank
    engine = app.engine
    old_engine_bank = engine.bank if engine is not None else None
    events = getattr(app, "events", None)
    t0 = time.monotonic()
    generation = old_bank.generation + 1
    new_bank.generation = generation
    engine_created = False
    try:
        # the engine first: until app.bank flips, a request routes by the
        # old bank, so a target it holds is in both banks and a new one
        # goes to the per-model path
        if engine is not None:
            engine.bank = new_bank  # batches in flight keep the old one
        elif len(new_bank):
            engine = BatchingEngine(new_bank, **app.engine_config)
            engine.start()
            app.engine = engine
            engine_created = True
        _FP_SWAP.fire()
        app.bank = new_bank
    except BaseException:
        app.bank = old_bank
        if engine_created:
            app.engine = None
            engine.stop()
        elif engine is not None:
            engine.bank = old_engine_bank
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


def swap_collection_bank(app) -> tuple:
    """Rebuild the bank from the collection's current models and swap it in
    (JAX ``views._swap_collection_bank``): the one swap of ``/reload`` and
    the mesh acquire and release. The caller holds ``app.reload_lock``. A
    build that fails puts the serving generation's collectors back and
    raises; so does a flip (after its rollback). The placement controller
    records the flip. ``(bank_models, {"generation", "pause_ms"})``, or
    ``(None, None)`` with the bank off."""
    if app.bank is None:
        return None, None
    prev_collectors = snapshot_collectors(app.metrics)
    try:
        bank = build_bank(app)
    except Exception:
        restore_collectors(app.metrics, prev_collectors)
        raise
    result = swap_bank(app, bank, prev_collectors=prev_collectors)
    if app.placement is not None:
        app.placement.record_swap(result)
    return result.bank_models, {"generation": result.generation, "pause_ms": round(result.pause_s * 1e3, 3)}


def wait_drained(old_bank, timeout_s: float) -> bool:
    """Wait, at most ``timeout_s``, for ``old_bank``'s groups in flight to
    reach zero, so that "the old generation went quiet" is observed, not
    assumed (its batches hold their own reference either way)."""
    if old_bank is None:
        return True
    deadline = time.monotonic() + max(0.0, timeout_s)
    while time.monotonic() < deadline:
        if old_bank._inflight_now == 0:
            return True
        time.sleep(0.01)
    return old_bank._inflight_now == 0
