"""Shape-keyed padded-buffer arena for the bank's scoring pipeline.

Counterpart of ``gordo_components_tpu/server/arena.py``.
``ModelBank.score_many`` pads each bucket group into ``(B, T, F)`` host
buffers; the arena keeps a bounded LRU pool of them keyed by exact shape
and dtype, so the coalesced loop stops allocating (and zeroing) a fresh
pair a group. A hit returns a *dirty* buffer (the caller overwrites the
data region with real rows and zeroes only the pad tail), a miss
allocates a fresh zeroed one. The pool is bounded by
``GORDO_ARENA_MAX_MB`` (default 256; ``0`` disables pooling: every
acquire is a plain ``np.zeros`` and the arena keeps no state).

On the card (``pinned=True``) the pooled buffers are page-locked host
memory (``torch.empty(..., pin_memory=True)``, seen through
``.numpy()``): only page-locked memory lets the pipeline's
``non_blocking`` host-to-device and device-to-host copies run
asynchronously. A page-locked allocation costs far more than
``np.zeros``, so ``misses`` counts them apart from ``hits``; with pooling
disabled a pinned arena still allocates page-locked buffers, it only
keeps none.

A buffer goes back to the pool only once the copy that reads or writes
it has completed (the pipeline releases a group's buffers after waiting
on the event recorded behind its last copy), so a pooled buffer is never
handed to another group while the card may still touch it.

Thread-safety: acquire and release take one lock around the pool's dict
operations only; filling a buffer runs lock-free on the caller's buffer.
"""

import os
import threading
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["PaddedArena", "DEFAULT_MAX_MB"]

DEFAULT_MAX_MB = 256.0


def _env_max_bytes() -> int:
    raw = os.environ.get("GORDO_ARENA_MAX_MB")
    if raw is None:
        return int(DEFAULT_MAX_MB * 1024 * 1024)
    try:
        return int(float(raw) * 1024 * 1024)
    except ValueError:
        raise ValueError(f"GORDO_ARENA_MAX_MB must be a number of megabytes, got {raw!r}") from None


class PaddedArena:
    """Bounded LRU pool of reusable padded scratch buffers.

    ``acquire(shape, dtype)`` returns ``(buffer, clean)``: ``clean`` is
    True for a freshly zeroed allocation (pool miss, or pooling disabled)
    and False for a reused buffer whose pad regions the caller must zero.
    ``release(buffer)`` returns it to the pool, evicting least-recently
    used *shapes* while the pooled bytes exceed the budget. A buffer
    larger than the whole budget is dropped, never pooled. ``outstanding``
    counts acquired but unreleased buffers."""

    def __init__(self, max_bytes: int = None, pinned: bool = False):
        self.max_bytes = _env_max_bytes() if max_bytes is None else int(max_bytes)
        self.pinned = bool(pinned)
        # (shape, dtype) -> stack of free buffers; order is recency (most
        # recently used at the end)
        self._pool: "OrderedDict[Tuple[tuple, str], List[np.ndarray]]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.pooled_bytes = 0
        self.outstanding = 0

    @property
    def enabled(self) -> bool:
        return self.max_bytes > 0

    def _allocate(self, shape, dtype) -> np.ndarray:
        if not self.pinned:
            return np.zeros(shape, dtype)
        t = torch.zeros(tuple(shape), dtype=torch.from_numpy(np.empty(0, dtype)).dtype, pin_memory=True)
        return t.numpy()  # the array keeps the page-locked tensor alive

    def acquire(self, shape, dtype=np.float32):
        if self.max_bytes <= 0:
            return self._allocate(shape, dtype), True
        key = (tuple(shape), np.dtype(dtype).str)
        with self._lock:
            stack = self._pool.get(key)
            if stack:
                buf = stack.pop()
                if not stack:
                    del self._pool[key]
                else:
                    self._pool.move_to_end(key)
                self.pooled_bytes -= buf.nbytes
                self.hits += 1
                self.outstanding += 1
                return buf, False
        # allocate outside the lock, and count only an allocation that
        # succeeded: a failed one must not strand ``outstanding``
        buf = self._allocate(shape, dtype)
        with self._lock:
            self.misses += 1
            self.outstanding += 1
        return buf, True

    def release(self, buf: np.ndarray) -> None:
        if self.max_bytes <= 0:
            return
        key = (buf.shape, buf.dtype.str)
        with self._lock:
            self.outstanding -= 1
            if buf.nbytes > self.max_bytes:
                # admitting it would evict every other shape first
                self.evictions += 1
                return
            self._pool.setdefault(key, []).append(buf)
            self._pool.move_to_end(key)
            self.pooled_bytes += buf.nbytes
            while self.pooled_bytes > self.max_bytes and self._pool:
                k, stack = next(iter(self._pool.items()))
                victim = stack.pop()
                if not stack:
                    del self._pool[k]
                self.pooled_bytes -= victim.nbytes
                self.evictions += 1

    def stats(self) -> Dict[str, object]:
        """The JAX arena's keys (``/stats`` ``bank_pipeline.arena``)."""
        with self._lock:
            total = self.hits + self.misses
            return {
                "enabled": self.enabled,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / total, 4) if total else None,
                "evictions": self.evictions,
                "pooled_bytes": self.pooled_bytes,
                "pooled_buffers": sum(len(s) for s in self._pool.values()),
                "outstanding": self.outstanding,
            }
