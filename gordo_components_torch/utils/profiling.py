"""On-demand profiling and the card's memory (counterpart of
``gordo_components_tpu/utils/profiling.py``).

- :func:`maybe_profile` wraps a block in ``torch.profiler.profile`` (the
  CPU activity, and the CUDA activity when a card is present) when a
  directory is passed or ``GORDO_PROFILE_DIR`` is set, and writes one
  Chrome trace (``chrome://tracing``, Perfetto) under
  ``<profile_dir>/<name>/``. It is free when neither is set. The profiler
  allows one capture a process, so captures hold one lock: a capture that
  starts while another is open waits for it, and both are written. A
  capture opened inside another on the same thread is recorded by the
  outer one (it is logged, and the inner block runs uncaptured).

  On the card a capture drops device records at its start, and each
  capture opens with a lead-in that absorbs the loss. Under
  PyTorch 2.11 and CUDA 12.8 on an H100 the first few kernels of every
  capture come back without their records, more of them the longer the
  process has been profiling (on any thread, whatever the idle time
  before them), and while other threads contend for the interpreter lock
  a kernel's stamp can land before the capture's window. So a capture
  first launches ``LEAD_IN_LAUNCHES`` one-element fills inside a
  ``gordo_profile_lead_in`` range, then idles the card for
  ``CAPTURE_MARGIN_S``, runs the block, and idles the card that long
  again before it closes (PERF.md, section 6).
- :func:`device_memory_stats` is a snapshot of the card's memory in the
  JAX package's layout, ``{device: {bytes_in_use, bytes_limit,
  peak_bytes_in_use}}``, empty on the CPU: the build metadata's
  ``device_memory`` and the server's ``gordo_device_hbm_*`` gauges read it.
"""

import contextlib
import itertools
import logging
import os
import re
import socket
import threading
import time
from typing import Any, Dict, Optional

import torch

logger = logging.getLogger(__name__)

PROFILE_DIR_ENV = "GORDO_PROFILE_DIR"
# the idle time on the card at each end of a capture
CAPTURE_MARGIN_S = 0.02
# kernels launched at a capture's start to take the records the profiler
# drops there (several milliseconds of launches)
LEAD_IN_LAUNCHES = 1024
LEAD_IN_RANGE = "gordo_profile_lead_in"

_capture_lock = threading.Lock()
_capturing = threading.local()
_serial = itertools.count()


def profile_path(name: str, profile_dir: str) -> str:
    """The directory a capture named ``name`` writes to, its name made safe
    for the file system as the JAX package makes it."""
    return os.path.join(profile_dir, re.sub(r"[^A-Za-z0-9_.-]+", "-", name) or "trace")


@contextlib.contextmanager
def maybe_profile(name: str, profile_dir: Optional[str] = None):
    """Capture the enclosed block when profiling is on (``profile_dir`` or
    ``GORDO_PROFILE_DIR``); the trace lands in
    ``<profile_dir>/<name>/<host>_<pid>.<n>.pt.trace.json``. A failure to
    start, stop or write the capture raises."""
    profile_dir = profile_dir or os.environ.get(PROFILE_DIR_ENV)
    if not profile_dir:
        yield
        return
    out = profile_path(name, profile_dir)
    if getattr(_capturing, "dir", None) is not None:
        logger.warning("Profile %r opened inside the capture %s on one thread: recorded there", name,
                       _capturing.dir)
        yield
        return
    os.makedirs(out, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with _capture_lock:
        _capturing.dir = out
        try:
            logger.info("Profiling %r -> %s", name, out)
            with torch.profiler.profile(activities=activities) as prof:
                if cuda:
                    _lead_in()
                yield
                if cuda:
                    torch.cuda.synchronize()
                    time.sleep(CAPTURE_MARGIN_S)
            path = os.path.join(out, f"{socket.gethostname()}_{os.getpid()}.{next(_serial)}.pt.trace.json")
            prof.export_chrome_trace(path)
        finally:
            _capturing.dir = None


def _lead_in() -> None:
    """The start of a capture on the card: LEAD_IN_LAUNCHES launches in a
    range of their own, then an idle card for CAPTURE_MARGIN_S."""
    torch.cuda.synchronize()
    cell = torch.empty(1, device="cuda")
    with torch.profiler.record_function(LEAD_IN_RANGE):
        for _ in range(LEAD_IN_LAUNCHES):
            cell.zero_()
    torch.cuda.synchronize()
    time.sleep(CAPTURE_MARGIN_S)


def device_memory_stats(device: Optional[torch.device] = None) -> Dict[str, Any]:
    """``{"cuda:<i>": {"bytes_in_use", "bytes_limit", "peak_bytes_in_use"}}``
    of ``device`` (default: the current card), read from PyTorch's caching
    allocator and ``mem_get_info``; ``{}`` for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    index = device.index if device.index is not None else torch.cuda.current_device()
    return {f"cuda:{index}": {
        "bytes_in_use": int(torch.cuda.memory_allocated(index)),
        "bytes_limit": int(torch.cuda.mem_get_info(index)[1]),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(index)),
    }}
