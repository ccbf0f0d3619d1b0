"""Load many members' datasets for a gang build (counterpart of
``stage_members`` in ``gordo_components_tpu/utils/staging.py``): a plain
thread pool over the provider -> resample -> join path, results in input
order. ``GORDO_LOAD_WORKERS`` sets the pool size (default
``min(8, max(4, cores))``); the JAX package's process engine
(``GORDO_LOAD_MODE=process``) is not ported and raises.
"""

import concurrent.futures
import os
from typing import Any, Dict, List, Optional, Tuple


def load_worker_count(n_tasks: Optional[int] = None) -> int:
    raw = os.environ.get("GORDO_LOAD_WORKERS", "").strip()
    workers = int(raw) if raw and raw != "auto" else min(8, max(4, os.cpu_count() or 1))
    if n_tasks is not None:
        workers = min(workers, n_tasks)
    return max(1, workers)


def _stage_one(config: Dict[str, Any]) -> Tuple[Any, Dict[str, Any]]:
    from gordo_components_torch.dataset import get_dataset

    ds = get_dataset(dict(config))
    X, _y = ds.get_data()
    return X, ds.get_metadata()


def stage_members(configs: List[Dict[str, Any]], workers: Optional[int] = None):
    """Every member's ``(X, dataset metadata)``, in input order."""
    if os.environ.get("GORDO_LOAD_MODE") == "process":
        raise NotImplementedError("GORDO_LOAD_MODE=process: the port stages members with threads only")
    workers = load_worker_count(len(configs)) if workers is None else workers
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        return list(pool.map(_stage_one, configs))
