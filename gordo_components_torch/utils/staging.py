"""Load many members' datasets for a gang build (counterpart of
``gordo_components_tpu/utils/staging.py``): the provider -> resample ->
join path for every member, results in input order, through one of four
engines.

- ``load_worker_count``: the pool size, ``GORDO_LOAD_WORKERS`` or
  ``min(8, max(4, cores))``.
- ``load_mode``: ``GORDO_LOAD_MODE``, one of ``sync`` (inline),
  ``thread``, ``process`` (spawned workers; see below) or ``auto`` (unset
  or empty): ``sync`` on one core when no provider waits on I/O, else
  ``thread``. Any other value raises. The JAX package's ``auto`` picks
  ``process`` at 16 members a worker and more, for a worker start-up of
  about 3 s; the port's never does: a spawned worker imports torch and the
  calling script, which cost 11-133 s of summed load against 0.25-1.9 s on
  threads for 4-member groups on an H100 host (PERF.md, section 6), and the
  engine was not measured at the sizes where JAX picks it.

Configs that cannot be pickled (an injected provider object) stage with
threads where ``process`` was chosen, as the JAX package does. A spawned
worker runs :func:`_stage_one`, which imports the port's dataset modules
and no torch, so it never touches CUDA; multiprocessing also re-imports the
calling script when it was run as a file (not under ``python -m``, as the
CLI runs), so such a script guards its entry point with ``__main__``.
"""

import concurrent.futures
import logging
import multiprocessing
import os
import pickle
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

LOAD_MODES = ("auto", "thread", "process", "sync")


def load_worker_count(n_tasks: Optional[int] = None) -> int:
    raw = os.environ.get("GORDO_LOAD_WORKERS", "").strip()
    workers = int(raw) if raw and raw != "auto" else min(8, max(4, os.cpu_count() or 1))
    if n_tasks is not None:
        workers = min(workers, n_tasks)
    return max(1, workers)


def load_mode(n_tasks: int, workers: int, io_bound: bool = True) -> str:
    """The engine, from ``GORDO_LOAD_MODE`` (``auto`` when unset or empty)."""
    mode = os.environ.get("GORDO_LOAD_MODE") or "auto"
    if mode not in LOAD_MODES:
        raise ValueError(f"GORDO_LOAD_MODE must be auto|thread|process|sync, got {mode!r}")
    if mode == "auto":
        mode = "sync" if (os.cpu_count() or 1) == 1 and not io_bound else "thread"
    return mode


def _io_bound_hint(configs: List[Dict[str, Any]]) -> bool:
    """True when any member's provider waits on I/O (its class's
    ``io_bound``, true unless it says otherwise); a provider the port does
    not know counts as I/O-bound."""
    from gordo_components_torch.dataset import data_provider as dp_module
    from gordo_components_torch.dataset.data_provider.providers import RandomDataProvider

    for c in configs:
        dp = (c or {}).get("data_provider")
        if dp is None:
            cls: Any = RandomDataProvider  # the datasets' default provider
        elif isinstance(dp, dict):
            cls = getattr(dp_module, str(dp.get("type", "")).rsplit(".", 1)[-1], None)
        else:
            cls = type(dp)
        if cls is None or getattr(cls, "io_bound", True):
            return True
    return False


def _stage_one(config: Dict[str, Any]) -> Tuple[Any, Dict[str, Any]]:
    """One member's ``(X, dataset metadata)``; top level so that a spawned
    worker can unpickle it, importing the dataset modules only."""
    from gordo_components_torch.dataset import get_dataset

    ds = get_dataset(dict(config))
    X, _y = ds.get_data()
    return X, ds.get_metadata()


def stage_members(configs: List[Dict[str, Any]], workers: Optional[int] = None,
                  mode: Optional[str] = None) -> List[Tuple[Any, Dict[str, Any]]]:
    """Every member's ``(X, dataset metadata)``, in input order, through
    ``mode`` (default :func:`load_mode`'s)."""
    n = len(configs)
    if workers is None:
        workers = load_worker_count(n)
    if mode is None:
        mode = load_mode(n, workers, io_bound=_io_bound_hint(configs))
    elif mode not in LOAD_MODES:
        raise ValueError(f"mode must be auto|thread|process|sync, got {mode!r}")
    if n <= 1 or workers <= 1 or mode == "sync":
        return [_stage_one(c) for c in configs]
    if mode == "process":
        try:
            pickle.dumps(configs)
        except Exception:
            logger.info("member configs not picklable; staging with threads")
            mode = "thread"
    if mode == "process":
        # spawn, not fork: the parent holds CUDA state and threads
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            return list(pool.map(_stage_one, configs, chunksize=max(1, n // (workers * 4))))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        return list(pool.map(_stage_one, configs))
