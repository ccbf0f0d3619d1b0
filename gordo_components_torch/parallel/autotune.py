"""The fleet's member-width cap, ``GORDO_FLEET_WIDTH`` (counterpart of
``gordo_components_tpu/parallel/autotune.py``).

``GORDO_FLEET_WIDTH`` caps the members of every training stack:

- unset or ``off``: no cap;
- an integer: that cap;
- ``auto``: a calibration sweep picks the cap once per (architecture,
  device kind) and persists it, so a machine that has measured an
  architecture never sweeps it again. The sweep times a proxy of an epoch's
  inner operation, a member-batched product ``(width, 8, 64) x (width, 64,
  64)`` (``torch.bmm``), at each of ``SWEEP_WIDTHS`` and takes the smallest
  width within 10% of the best members per second; a flat curve (every
  width within 10%) gives ``KNEE_DEFAULT``.

The table is a JSON file keyed ``{arch}|{device_kind}`` at
``GORDO_FLEET_WIDTH_CACHE`` (default ``~/.cache/gordo/fleet_width.json``),
in the JAX package's layout, written by an atomic rename. A corrupt or
unwritable file degrades to the process's own table.
"""

import json
import logging
import os
import threading
import time
from typing import Callable, Optional

import torch

logger = logging.getLogger(__name__)

FLEET_WIDTH_ENV = "GORDO_FLEET_WIDTH"
FLEET_WIDTH_CACHE_ENV = "GORDO_FLEET_WIDTH_CACHE"

SWEEP_WIDTHS = (512, 1024, 2048, 4096, 8192)
# the JAX package's tie-break for a flat sweep: under-capping costs
# throughput, over-capping only transient memory
KNEE_DEFAULT = 4096
# the proxy's per-member shapes: a (B, H) x (H, H) product
_PROXY_B = 8
_PROXY_H = 64
_PROXY_CALLS = 3

# widths resolved in this process (also the table when the file is unwritable),
# and one sweep at a time (gang workers resolve at once)
_process_cache: dict = {}
_resolve_lock = threading.Lock()


def cache_path() -> str:
    p = os.environ.get(FLEET_WIDTH_CACHE_ENV)
    if p:
        return p
    return os.path.join(os.path.expanduser("~"), ".cache", "gordo", "fleet_width.json")


def _load_table() -> dict:
    try:
        with open(cache_path()) as f:
            tab = json.load(f)
        return tab if isinstance(tab, dict) else {}
    except (OSError, ValueError):
        return {}


def _store(key: str, width: int, measured: dict) -> None:
    path = cache_path()
    tab = _load_table()
    tab[key] = {"width": int(width), "measured": measured}
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(tab, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        logger.warning("Fleet width cache %s unwritable; autotuned width %d for %s applies in-process only",
                       path, width, key)


def _device_kind(device) -> str:
    """The card's name with spaces replaced (``NVIDIA_H100_80GB_HBM3``), or
    ``cpu``."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device).replace(" ", "_")


def calibrate_width(arch: str, device) -> "tuple[int, dict]":
    """Time the member-batched product at each of ``SWEEP_WIDTHS`` on
    ``device`` (CUDA events after a warm call on the card, ``perf_counter``
    on the CPU) and pick the smallest width within 10% of the best members
    per second; ``KNEE_DEFAULT`` when every width is. Returns ``(width,
    {str(width): members per second})``."""
    device = torch.device(device)
    eff = {}
    for width in SWEEP_WIDTHS:
        x = torch.ones((width, _PROXY_B, _PROXY_H), device=device)
        w = torch.ones((width, _PROXY_H, _PROXY_H), device=device)
        torch.bmm(x, w)  # warm, outside the clock
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(_PROXY_CALLS):
                torch.bmm(x, w)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(_PROXY_CALLS):
                torch.bmm(x, w)
            seconds = time.perf_counter() - t0
        eff[width] = width / max(seconds, 1e-9)
    peak = max(eff.values())
    good = [w for w in SWEEP_WIDTHS if eff[w] >= 0.9 * peak]
    width = KNEE_DEFAULT if set(good) >= set(SWEEP_WIDTHS) else min(good)
    return width, {str(w): round(e, 1) for w, e in eff.items()}


def resolve_fleet_width(arch: str, sweep: Optional[Callable] = None, device="cuda") -> Optional[int]:
    """The member-width cap of a training stack, or None for no cap.

    ``arch`` keys the persisted sweep (``"LSTMAutoEncoder:lstm_hourglass"``)
    with ``device``'s kind (the card by default; ``"cpu"`` asks for the
    CPU); ``sweep(arch)`` replaces the calibration there (tests inject
    one). Resolution: unset or ``off`` -> None; an integer -> it; ``auto``
    -> the process's table, then the file's, else one sweep, persisted."""
    raw = (os.environ.get(FLEET_WIDTH_ENV) or "").strip().lower()
    if not raw or raw == "off":
        return None
    if raw != "auto":
        try:
            width = int(raw)
        except ValueError:
            raise ValueError(f"{FLEET_WIDTH_ENV} must be an integer, 'auto', or 'off'; got {raw!r}")
        if width < 1:
            raise ValueError(f"{FLEET_WIDTH_ENV} must be >= 1, got {width}")
        return width
    key = f"{arch}|{_device_kind(device)}"
    with _resolve_lock:
        if key in _process_cache:
            return _process_cache[key]
        row = _load_table().get(key)
        if isinstance(row, dict) and int(row.get("width", 0)) >= 1:
            width = int(row["width"])
        else:
            width, measured = (sweep or (lambda a: calibrate_width(a, device)))(arch)
            width = int(width)
            _store(key, width, measured)
            logger.info("Autotuned fleet width for %s: %d (persisted to %s)", key, width, cache_path())
        _process_cache[key] = width
        return width


def split_widths(names, width_cap: Optional[int]):
    """``names`` in near-equal consecutive chunks of at most ``width_cap``
    members (one chunk when there is no cap or it is not exceeded), as the
    JAX trainer splits a bucket."""
    names = list(names)
    if not width_cap or len(names) <= width_cap:
        return [names]
    n_chunks = -(-len(names) // width_cap)
    size = -(-len(names) // n_chunks)
    return [names[i:i + size] for i in range(0, len(names), size)]
