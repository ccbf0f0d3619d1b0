"""Zero-downtime bank swap.

Counterpart of ``swap_bank`` in ``gordo_components_tpu/placement/swap.py``,
for the port's one-device bank. ``POST .../reload`` builds the new bank to
the side (``ModelBank.from_models`` over the collection's current models,
with the app's bank settings) while the old bank keeps serving, then
:func:`swap_bank` flips ``app.bank`` and ``engine.bank`` to it, one
generation above the old one. The engine reads its bank once a batch, so a
batch in flight drains on the old bank and the next one scores on the new;
no request sees a torn state. If the build fails, nothing is flipped and
the old bank keeps serving. The old bank is freed when its last batch lets
go of it.

The new bank is built with the app's metrics registry, so its bucket
counters go on from the old bank's and its gauges read the new bank; the
engine, which keeps its collector, is the same across the swap.

Not in this slice: the placement planner's member order and per-model row
counts and the multi-worker engines.
"""

import logging
import time
from dataclasses import dataclass

from gordo_components_torch.server.bank import ModelBank
from gordo_components_torch.server.engine import BatchingEngine

logger = logging.getLogger(__name__)


@dataclass
class SwapResult:
    generation: int
    pause_s: float  # the flip's wall time
    bank_models: int


def swap_bank(app, new_bank: ModelBank) -> SwapResult:
    """Flip the app to ``new_bank``, its generation one above the old
    bank's; the caller holds ``app.reload_lock``. The engine starts here
    when the first bank with members arrives; if that fails, the old bank
    and engine stay."""
    old_bank = app.bank
    t0 = time.monotonic()
    new_bank.generation = old_bank.generation + 1
    # the engine first: until app.bank flips, a request routes by the old
    # bank, so a target it holds is in both banks and a new one goes to
    # the per-model path
    if app.engine is not None:
        app.engine.bank = new_bank  # batches in flight keep the old one
    elif len(new_bank):
        engine = BatchingEngine(new_bank, **app.engine_config)
        engine.start()
        app.engine = engine
    app.bank = new_bank
    pause_s = time.monotonic() - t0
    logger.info("bank swapped to generation %d (%d model(s), flip pause %.3f ms)",
                new_bank.generation, len(new_bank), pause_s * 1e3)
    return SwapResult(new_bank.generation, pause_s, len(new_bank))
