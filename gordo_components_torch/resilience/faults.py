"""Deterministic fault-injection registry.

Counterpart of ``gordo_components_tpu/resilience/faults.py``, with the same
sites, grammar and semantics; the two registries are separate objects in
one process.

Every real failure site in the stack declares a module-level
:func:`faultpoint` and trips it on its hot path::

    _FP_LOAD = faultpoint("model_io.load")   # import time: registers the site

    def _load_one(...):
        _FP_LOAD.fire()                      # no-op unless armed
        ...

Disabled cost is one method call reading one slot attribute against
``None`` — no env reads, no locks, no allocation; ``chip_smoke.py``'s
``resilience`` phase measures it on the card against a no-op stub. A
point also works as a context manager (fires on ``__enter__``) and as a
decorator (fires before the wrapped call) for sites where that reads
better.

Arming is explicit (:func:`arm`) or env-driven (:func:`configure_from_env`
reading ``GORDO_FAULTS``), with three modes composable per spec:

- **raise-N-times**: ``times=N`` — the first N ``fire()`` calls raise,
  later ones pass (deterministic "transient failure");
- **probabilistic**: ``p=0.25,seed=7`` — a *seeded* private RNG decides
  each fire, so a chaos run replays identically;
- **latency**: ``latency:0.05`` — sleep before (optionally) raising.

``GORDO_FAULTS`` grammar (';'-separated clauses)::

    site=kind[:arg][,key=value...]

    GORDO_FAULTS="model_io.load=error:OSError,times=2;bank.score=latency:0.05"
    GORDO_FAULTS="engine.queue=error,p=0.5,seed=42"

``kind`` is ``error`` (arg: exception class name, default
:class:`FaultInjected`) or ``latency`` (arg: seconds, raises nothing
unless ``error=Name`` is added), plus three transport-level kinds (at a
site on a connection-handling path, ``server.connection``, these become
real socket-level failures):

- ``refuse`` — raises :class:`ConnectionRefusedError` (the peer's port
  answers RST: process down, nothing listening);
- ``reset`` — raises :class:`ConnectionResetError` (the connection died
  mid-exchange: crash after accept, middlebox cut);
- ``blackhole[:seconds]`` — sleeps (default 5s: packets silently
  dropped, the caller hangs until its own deadline) then raises
  :class:`TimeoutError`.

Unknown sites are accepted — arming may precede the importing of the
module that registers the site.
"""

import logging
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

__all__ = [
    "FaultInjected",
    "FaultSpec",
    "arm",
    "configure_from_env",
    "disarm",
    "fault_stats",
    "faultpoint",
    "registered_sites",
    "reset",
    "set_fire_listener",
]

# one process-wide observer invoked on every ACTUAL fire (after the
# p/times gates pass, before any delay/raise) — the event timeline's
# hook. A plain module global read once per armed fire: the disabled
# hot path (spec is None) never reaches it, preserving the 5% guard.
_FIRE_LISTENER: Optional[Callable[[str, "FaultSpec"], None]] = None


def set_fire_listener(
    fn: Optional[Callable[[str, "FaultSpec"], None]]
) -> Optional[Callable[[str, "FaultSpec"], None]]:
    """Install (or clear with None) the fire observer; returns the
    previous one. Listener exceptions are swallowed — observability must
    never change injected-fault semantics."""
    global _FIRE_LISTENER
    prev = _FIRE_LISTENER
    _FIRE_LISTENER = fn
    return prev


class FaultInjected(RuntimeError):
    """Default exception raised by an armed error faultpoint."""


# exception classes an env spec may name: builtins only (arbitrary import
# paths from an env var would be an injection surface, not a test knob)
import builtins as _builtins

_ALLOWED_EXCEPTIONS: Dict[str, type] = {
    name: exc
    for name, exc in vars(_builtins).items()
    if isinstance(exc, type) and issubclass(exc, Exception)
}
_ALLOWED_EXCEPTIONS["FaultInjected"] = FaultInjected


class FaultSpec:
    """One armed behavior: what happens when its site fires."""

    __slots__ = ("exc", "delay_s", "times", "p", "_rng", "remaining", "fired", "_lock")

    def __init__(
        self,
        exc: Optional[type] = FaultInjected,
        delay_s: float = 0.0,
        times: Optional[int] = None,
        p: float = 1.0,
        seed: Optional[int] = None,
    ):
        if exc is not None and not (
            isinstance(exc, type) and issubclass(exc, BaseException)
        ):
            raise TypeError(f"exc must be an exception class, got {exc!r}")
        if not 0.0 <= float(p) <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {p!r}")
        self.exc = exc
        self.delay_s = float(delay_s)
        self.times = None if times is None else int(times)
        self.p = float(p)
        # private seeded stream: a chaos run replays identically and never
        # perturbs global random state
        self._rng = random.Random(0 if seed is None else seed)
        self.remaining = self.times
        self.fired = 0
        # the draw and the counts under one lock: a site fired from several
        # threads (gang workers) spends each of its ``times`` once
        self._lock = threading.Lock()

    def fire(self, site: str) -> None:
        with self._lock:
            if self.p < 1.0 and self._rng.random() >= self.p:
                return
            if self.remaining is not None:
                if self.remaining <= 0:
                    return
                self.remaining -= 1
            self.fired += 1
        listener = _FIRE_LISTENER
        if listener is not None:
            try:
                listener(site, self)
            except Exception:
                pass
        if self.delay_s > 0:
            time.sleep(self.delay_s)
        if self.exc is not None:
            raise self.exc(f"fault injected at {site!r}")

    def describe(self) -> Dict[str, Any]:
        return {
            "exception": None if self.exc is None else self.exc.__name__,
            "delay_s": self.delay_s,
            "times": self.times,
            "remaining": self.remaining,
            "p": self.p,
            "fired": self.fired,
        }


class FaultPoint:
    """A named injection site. ``_spec`` is the only hot-path state:
    ``None`` (the overwhelmingly common case) means pass through."""

    __slots__ = ("site", "_spec")

    def __init__(self, site: str):
        self.site = site
        self._spec: Optional[FaultSpec] = None

    def fire(self) -> None:
        """Inline trigger — the hot-path form."""
        spec = self._spec
        if spec is not None:
            spec.fire(self.site)

    # context-manager form: fires on entry, guards the whole block
    def __enter__(self) -> "FaultPoint":
        self.fire()
        return self

    def __exit__(self, *exc_info) -> bool:
        return False

    # decorator form
    def __call__(self, fn: Callable) -> Callable:
        import functools

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            self.fire()
            return fn(*args, **kwargs)

        return wrapper

    def __repr__(self) -> str:
        state = "disarmed" if self._spec is None else f"armed({self._spec.describe()})"
        return f"<faultpoint {self.site!r} {state}>"


# site name -> FaultPoint; insertion ordered, grown at import time by the
# modules that own the sites (so `registered_sites()` enumerates exactly
# the failure surfaces the chaos suite must drive)
_POINTS: Dict[str, FaultPoint] = {}
# specs armed before their site's module imported: applied on registration
_PENDING: Dict[str, FaultSpec] = {}


def faultpoint(site: str) -> FaultPoint:
    """Get-or-create the :class:`FaultPoint` for ``site`` (registering it)."""
    point = _POINTS.get(site)
    if point is None:
        point = _POINTS[site] = FaultPoint(site)
        pending = _PENDING.pop(site, None)
        if pending is not None:
            point._spec = pending
    return point


def registered_sites() -> List[str]:
    """Every site declared so far (import the subsystem first)."""
    return sorted(_POINTS)


def arm(site: str, spec: Optional[FaultSpec] = None, **kwargs: Any) -> FaultSpec:
    """Arm ``site`` with ``spec`` (or ``FaultSpec(**kwargs)``).

    Arming an unregistered site parks the spec until the owning module
    registers it — env configuration runs before subsystem imports.
    """
    if spec is None:
        spec = FaultSpec(**kwargs)
    point = _POINTS.get(site)
    if point is None:
        _PENDING[site] = spec
    else:
        point._spec = spec
    logger.warning("FAULT INJECTION armed at %r: %s", site, spec.describe())
    return spec


def disarm(site: str) -> None:
    point = _POINTS.get(site)
    if point is not None:
        point._spec = None
    _PENDING.pop(site, None)


def reset() -> None:
    """Disarm every site (test teardown)."""
    for point in _POINTS.values():
        point._spec = None
    _PENDING.clear()


def fault_stats() -> Dict[str, Dict[str, Any]]:
    """site -> spec description for every armed site (operator/debug view)."""
    out = {
        site: p._spec.describe() for site, p in _POINTS.items() if p._spec is not None
    }
    for site, spec in _PENDING.items():
        out[site] = spec.describe()
    return out


# ------------------------------------------------------------------ #
# env-driven configuration
# ------------------------------------------------------------------ #

ENV_VAR = "GORDO_FAULTS"


def _parse_clause(clause: str) -> tuple:
    site, _, spec_str = clause.partition("=")
    site, spec_str = site.strip(), spec_str.strip()
    if not site or not spec_str:
        raise ValueError(f"malformed fault clause {clause!r} (want site=spec)")
    head, *opts = spec_str.split(",")
    kind, _, arg = head.partition(":")
    kind = kind.strip().lower()
    kwargs: Dict[str, Any] = {}
    if kind == "error":
        if arg:
            exc = _ALLOWED_EXCEPTIONS.get(arg.strip())
            if exc is None:
                raise ValueError(
                    f"unknown exception {arg.strip()!r} in fault clause "
                    f"{clause!r} (builtin exceptions and FaultInjected only)"
                )
            kwargs["exc"] = exc
    elif kind == "latency":
        kwargs["delay_s"] = float(arg or 0.01)
        kwargs["exc"] = None
    elif kind == "refuse":
        if arg:
            raise ValueError(
                f"fault kind 'refuse' takes no argument (got {arg!r} in "
                f"{clause!r})"
            )
        kwargs["exc"] = ConnectionRefusedError
    elif kind == "reset":
        if arg:
            raise ValueError(
                f"fault kind 'reset' takes no argument (got {arg!r} in "
                f"{clause!r})"
            )
        kwargs["exc"] = ConnectionResetError
    elif kind == "blackhole":
        # a blackhole HANGS the caller (dropped packets, no RST) before
        # surfacing as a timeout — delay first, TimeoutError after
        kwargs["delay_s"] = float(arg or 5.0)
        kwargs["exc"] = TimeoutError
    else:
        raise ValueError(
            f"unknown fault kind {kind!r} in {clause!r} "
            "(error|latency|blackhole|refuse|reset)"
        )
    for opt in opts:
        k, _, v = opt.partition("=")
        k, v = k.strip(), v.strip()
        if k == "times":
            kwargs["times"] = int(v)
        elif k == "p":
            kwargs["p"] = float(v)
        elif k == "seed":
            kwargs["seed"] = int(v)
        elif k == "latency":
            kwargs["delay_s"] = float(v)
        elif k == "error":
            exc = _ALLOWED_EXCEPTIONS.get(v)
            if exc is None:
                raise ValueError(f"unknown exception {v!r} in {clause!r}")
            kwargs["exc"] = exc
        else:
            raise ValueError(f"unknown fault option {k!r} in {clause!r}")
    return site, FaultSpec(**kwargs)


def configure_from_env(value: Optional[str] = None) -> int:
    """Arm faultpoints from ``GORDO_FAULTS`` (or ``value``); returns the
    number of sites armed. A malformed spec raises — silently ignoring a
    typo'd chaos config would report a vacuous green run."""
    raw = os.environ.get(ENV_VAR, "") if value is None else value
    raw = raw.strip()
    if not raw:
        return 0
    n = 0
    for clause in raw.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        site, spec = _parse_clause(clause)
        arm(site, spec)
        n += 1
    return n
