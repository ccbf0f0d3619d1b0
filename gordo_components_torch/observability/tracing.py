"""Request tracing: spans, W3C context, Chrome export.

Counterpart of ``gordo_components_tpu/observability/tracing.py``. A
:class:`Tracer` makes request-scoped :class:`Trace` objects whose
:class:`Span` records carry monotonic timestamps, so the serving path
(``queue_wait`` -> ``coalesce`` -> ``pad`` -> ``device_execute`` ->
``postprocess``) becomes a timeline a request.

- A disabled tracer (``GORDO_TRACE_SAMPLE=0``) returns ``None`` from
  ``start_trace`` and every call site checks that one reference;
  recording a span is two clock reads and a ``list.append``.
- ``traceparent`` headers (``00-<32 hex trace id>-<16 hex span id>-<2 hex
  flags>``) parse on the way in and format on the way out; an upstream
  ``sampled`` flag (0x01) keeps the trace past head sampling.
- ``GORDO_TRACE_SAMPLE`` (default 0.1) head-samples which finished traces
  enter the recent ring (``GORDO_TRACE_RING``, default 128); the worst-N
  reservoir (``GORDO_TRACE_SLOW_KEEP``, default 16) considers every
  finished trace, so the slowest requests stay retrievable.
- :func:`chrome_trace` exports the Trace Event Format that
  ``chrome://tracing`` and Perfetto open.

Threads: the port answers each connection on its own thread beside the
engine's worker, so the tracer's ring, reservoir and counters change
under its lock; a trace's spans are appended by the thread that holds the
request at that moment (HTTP thread, then the engine's, then the HTTP
thread again), each hand-off through a future.
"""

import contextlib
import contextvars
import heapq
import itertools
import os
import random
import re
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from gordo_components_torch.utils import env_num

__all__ = [
    "Span", "Trace", "Tracer", "chrome_trace", "current_trace", "format_traceparent", "parse_traceparent",
    "use_trace",
]

_TRACEPARENT_RE = re.compile(r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str, bool]]:
    """``(trace_id, parent_span_id, sampled)`` from a W3C ``traceparent``
    header, or None for an absent, malformed or all-zero one (an invalid
    header is ignored, not an error)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if not m:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id, bool(int(flags, 16) & 0x01)


def format_traceparent(trace_id: str, span_id: str, sampled: bool = True) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


# ids are identity, not security: one urandom-seeded generator (a single
# C call per id, atomic under the GIL) instead of uuid4's urandom read
_ID_RNG = random.Random(int.from_bytes(os.urandom(16), "big"))


def _new_trace_id() -> str:
    return f"{_ID_RNG.getrandbits(128):032x}"


def _new_span_id() -> str:
    return f"{_ID_RNG.getrandbits(64):016x}"


class Span:
    """One named, timed operation inside a trace; ``start``/``end`` are
    ``time.monotonic()`` seconds (``end`` None while open)."""

    __slots__ = ("name", "span_id", "parent_id", "start", "end", "error", "attributes")

    def __init__(self, name: str, span_id: str, parent_id: Optional[str], start: float,
                 end: Optional[float] = None, error: bool = False,
                 attributes: Optional[Dict[str, Any]] = None):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end = end
        self.error = error
        self.attributes = attributes or {}

    @property
    def duration_s(self) -> float:
        return max(0.0, (self.end if self.end is not None else self.start) - self.start)

    def close(self, error: bool = False) -> None:
        if self.end is None:
            self.end = time.monotonic()
        if error:
            self.error = True


class Trace:
    """All spans of one request, rooted at one root span that opens at
    construction and closes at :meth:`finish`, which commits the trace to
    its tracer's ring and reservoir."""

    __slots__ = ("tracer", "trace_id", "name", "request_id", "parent_span_id", "keep_recent",
                 "retained", "spans", "root", "wall_start", "_finished")

    def __init__(self, tracer: Optional["Tracer"], name: str, trace_id: Optional[str] = None,
                 request_id: Optional[str] = None, parent_span_id: Optional[str] = None,
                 keep_recent: bool = True):
        self.tracer = tracer
        self.trace_id = trace_id or _new_trace_id()
        self.name = name
        self.request_id = request_id
        self.parent_span_id = parent_span_id
        self.keep_recent = keep_recent
        # True once the finished trace landed in the ring or the reservoir:
        # only then may anything (an exemplar) publish its id
        self.retained = False
        self.wall_start = time.time()
        self.root = Span(name, _new_span_id(), None, time.monotonic())
        self.spans: List[Span] = [self.root]
        self._finished = False

    def start_span(self, name: str, parent: Optional[Span] = None, **attributes: Any) -> Span:
        """Open a span now (parent: the root); close it with ``span.close()``."""
        span = Span(name, _new_span_id(), (parent or self.root).span_id, time.monotonic(),
                    attributes=attributes or None)
        self.spans.append(span)
        return span

    def add_span(self, name: str, start: float, end: float, parent: Optional[Span] = None,
                 error: bool = False, **attributes: Any) -> Span:
        """Record a finished span from boundary times measured elsewhere."""
        span = Span(name, _new_span_id(), (parent or self.root).span_id, start, end=max(start, end),
                    error=error, attributes=attributes or None)
        self.spans.append(span)
        return span

    @contextlib.contextmanager
    def span(self, name: str, parent: Optional[Span] = None, **attributes: Any):
        """A span over the block, ``error=True`` when it raised."""
        span = self.start_span(name, parent=parent, **attributes)
        try:
            yield span
        except BaseException:
            span.close(error=True)
            raise
        else:
            span.close()

    def finish(self, error: bool = False, **attributes: Any) -> None:
        """Close the root and publish the trace; idempotent."""
        if self._finished:
            return
        self._finished = True
        if attributes:
            self.root.attributes.update(attributes)
        # an abandoned child must not export as an open span
        for span in self.spans:
            if span.end is None and span is not self.root:
                span.close(error=True)
        self.root.close(error=error)
        if self.tracer is not None:
            self.tracer._commit(self)

    @property
    def finished(self) -> bool:
        return self._finished

    @property
    def duration_s(self) -> float:
        return self.root.duration_s

    @property
    def error(self) -> bool:
        return any(s.error for s in self.spans)

    def _span_dict(self, span: Span, children: Dict[Optional[str], List[Span]]) -> dict:
        out: Dict[str, Any] = {
            "name": span.name,
            "span_id": span.span_id,
            "start_ms": round((span.start - self.root.start) * 1e3, 3),
            "duration_ms": round(span.duration_s * 1e3, 3),
        }
        if span.error:
            out["error"] = True
        if span.attributes:
            out["attributes"] = dict(span.attributes)
        kids = children.get(span.span_id)
        if kids:
            out["children"] = [self._span_dict(k, children) for k in kids]
        return out

    def tree(self) -> dict:
        """Nested span tree, children sorted by start time; a span whose
        parent is not in the trace hangs under the root."""
        children: Dict[Optional[str], List[Span]] = {}
        for span in self.spans:
            if span is not self.root:
                children.setdefault(span.parent_id, []).append(span)
        for kids in children.values():
            kids.sort(key=lambda s: s.start)
        known = {s.span_id for s in self.spans}
        for pid in list(children):
            if pid not in known:
                children.setdefault(self.root.span_id, []).extend(children.pop(pid))
        return self._span_dict(self.root, children)

    def summary(self, spans: bool = True) -> dict:
        out: Dict[str, Any] = {
            "trace_id": self.trace_id,
            "name": self.name,
            "request_id": self.request_id,
            "start_unix": round(self.wall_start, 3),
            "duration_ms": round(self.duration_s * 1e3, 3),
            "error": self.error,
            "n_spans": len(self.spans),
        }
        if spans:
            out["spans"] = self.tree()
        return out


def chrome_trace(traces: Iterable[Trace]) -> dict:
    """Chrome trace-event JSON: complete events (``ph: "X"``) with
    microsecond ``ts``/``dur``, one ``pid`` a trace, wall-anchored at each
    trace's start so concurrent traces align."""
    events: List[dict] = []
    for pid, trace in enumerate(traces, start=1):
        events.append({
            "ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": f"{trace.name} {trace.trace_id[:8]}"
                     + (f" rid={trace.request_id}" if trace.request_id else "")},
        })
        base = trace.root.start
        anchor_us = trace.wall_start * 1e6
        for span in trace.spans:
            args: Dict[str, Any] = {"trace_id": trace.trace_id}
            if span.attributes:
                args.update(span.attributes)
            if span.error:
                args["error"] = True
            events.append({
                "ph": "X", "pid": pid, "tid": 1, "name": span.name, "cat": trace.name,
                "ts": round(anchor_us + (span.start - base) * 1e6, 3),
                "dur": round(span.duration_s * 1e6, 3),
                "args": args,
            })
    return {"displayTimeUnit": "ms", "traceEvents": events}


class Tracer:
    """The app's trace source, ring and slow reservoir.

    ``sample`` <= 0 disables tracing (``start_trace`` returns None). With
    ``0 < sample`` every request records spans; ``sample`` decides which
    finished traces enter the recent ring, while the worst-N reservoir
    considers all of them."""

    def __init__(self, sample: Optional[float] = None, ring: Optional[int] = None,
                 slow_keep: Optional[int] = None):
        if sample is None:
            sample = env_num("GORDO_TRACE_SAMPLE", 0.1, float)
        if ring is None:
            ring = int(env_num("GORDO_TRACE_RING", 128, float))
        if slow_keep is None:
            slow_keep = int(env_num("GORDO_TRACE_SLOW_KEEP", 16, float))
        self.sample = float(sample)
        self.slow_keep = max(1, slow_keep)
        self._recent: "deque[Trace]" = deque(maxlen=max(1, ring))
        self._slow: List[Tuple[float, int, Trace]] = []  # min-heap
        self._seq = itertools.count()
        self._rng = random.Random()
        self._lock = threading.Lock()
        self.started = 0
        self.finished = 0

    @property
    def enabled(self) -> bool:
        return self.sample > 0.0

    @property
    def inflight(self) -> int:
        """Traces started but not finished (back to 0 when nothing leaks)."""
        with self._lock:
            return self.started - self.finished

    def start_trace(self, name: str, traceparent: Optional[str] = None,
                    request_id: Optional[str] = None, force: bool = False) -> Optional[Trace]:
        """A new trace, or None when tracing is disabled. A valid
        ``traceparent`` continues the upstream trace id; its ``sampled``
        flag (or ``force``) keeps the trace in the recent ring."""
        if self.sample <= 0.0:
            return None
        trace_id = parent_span = None
        upstream_sampled = False
        parsed = parse_traceparent(traceparent)
        if parsed is not None:
            trace_id, parent_span, upstream_sampled = parsed
        with self._lock:
            keep = force or upstream_sampled or self.sample >= 1.0 or self._rng.random() < self.sample
            self.started += 1
        return Trace(self, name, trace_id=trace_id, request_id=request_id, parent_span_id=parent_span,
                     keep_recent=keep)

    def _commit(self, trace: Trace) -> None:
        with self._lock:
            self.finished += 1
            if trace.keep_recent:
                self._recent.append(trace)
                trace.retained = True
            # every finished trace competes for the worst-N reservoir
            item = (trace.duration_s, next(self._seq), trace)
            if len(self._slow) < self.slow_keep:
                heapq.heappush(self._slow, item)
                trace.retained = True
            elif item[0] > self._slow[0][0]:
                heapq.heapreplace(self._slow, item)
                trace.retained = True

    def recent(self, n: Optional[int] = None) -> List[Trace]:
        """Retained traces, most recent first; ``n`` <= 0 or None: all."""
        with self._lock:
            out = list(self._recent)
        out.reverse()
        return out[:n] if n is not None and n > 0 else out

    def slow(self, n: Optional[int] = None) -> List[Trace]:
        """The reservoir's traces, slowest first; ``n`` as in :meth:`recent`."""
        with self._lock:
            out = [t for _, _, t in sorted(self._slow, reverse=True)]
        return out[:n] if n is not None and n > 0 else out

    def find(self, trace_id: str) -> List[Trace]:
        """Retained traces of ``trace_id`` (ring and reservoir)."""
        with self._lock:
            seen = []
            for t in list(self._recent) + [t for _, _, t in self._slow]:
                if t.trace_id == trace_id and t not in seen:
                    seen.append(t)
        return seen


# the process-default tracer (a server builds one of its own per app): the
# builder's traces start here
_DEFAULT: Optional[Tracer] = None


def get_tracer() -> Tracer:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Tracer()
    return _DEFAULT


# the current trace of this context: a thread or task that sets it reads
# it back without passing it down (the engine's worker thread does not see
# the HTTP thread's, so requests carry their trace explicitly there)
_CURRENT: "contextvars.ContextVar[Optional[Trace]]" = contextvars.ContextVar(
    "gordo_current_trace", default=None)


def current_trace() -> Optional[Trace]:
    return _CURRENT.get()


@contextlib.contextmanager
def use_trace(trace: Optional[Trace]):
    token = _CURRENT.set(trace)
    try:
        yield trace
    finally:
        _CURRENT.reset(token)
