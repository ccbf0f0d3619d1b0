"""QoS admission: per-tenant token buckets, per-class shedding.

Counterpart of ``gordo_components_tpu/qos/admission.py``. The controller
stands in front of the batching engine and answers each banked scoring
request with admit, or a refusal that says when to retry. Three rules, in
order:

1. **Tenant rate** (``GORDO_QOS_TENANTS``): a tenant the configuration
   names draws one token a request from its bucket; an empty bucket
   refuses with ``Retry-After`` = the deficit over the refill rate.
   Unknown tenants are admitted, counted, and labelled ``other``.
2. **Queue pressure** (``GORDO_QOS_SHED_FRACTIONS``): a class is refused
   once the engine's backlog reaches its fraction of ``max_queue``
   (best_effort 0.5, batch 0.75, interactive 1.0 by default).
3. **Goodput burn** (``GORDO_QOS_BURN_SHED``, default 2.0): under
   pressure (the backlog past the weakest class's fraction), a sheddable
   class (fraction below 1.0) whose fast-window SLO burn rate
   (``burn_for``, the SLO tracker's ``class_burn``) is at least the
   threshold and the highest of all classes is refused.

A refusal raises :class:`QosShed` with its reason and ``retry_after_s``;
the server answers it with a 429 and ``Retry-After``. The counters and
buckets take a lock (one thread a connection), held across no bank call.
"""

import json
import logging
import math
import os
import threading
import time
import weakref
from typing import Callable, Dict, Optional, Tuple

from gordo_components_torch.qos.classify import CLASSES, DEFAULT_TENANT, RequestClass

__all__ = ["AdmissionController", "QosShed", "TokenBucket", "parse_tenants"]

logger = logging.getLogger(__name__)

_ENV_TENANTS = "GORDO_QOS_TENANTS"
_ENV_FRACTIONS = "GORDO_QOS_SHED_FRACTIONS"
_ENV_BURN_SHED = "GORDO_QOS_BURN_SHED"

#: the backlog's fraction of ``max_queue`` at which a class is refused;
#: 1.0 leaves only the engine's full queue
DEFAULT_SHED_FRACTIONS: Dict[str, float] = {
    "interactive": 1.0,
    "batch": 0.75,
    "best_effort": 0.5,
}

#: the fast-window burn rate past which the hottest sheddable class is
#: refused under pressure
DEFAULT_BURN_SHED = 2.0


class QosShed(Exception):
    """Admission refused a request: ``reason`` is ``tenant_rate``,
    ``queue_pressure`` or ``goodput_burn``, ``retry_after_s`` when to
    retry."""

    def __init__(self, reason: str, retry_after_s: float, tenant: str = DEFAULT_TENANT,
                 qos_class: str = "interactive"):
        self.reason = reason
        self.retry_after_s = float(retry_after_s)
        self.tenant = tenant
        self.qos_class = qos_class
        super().__init__(f"admission refused ({reason}) for tenant={tenant} "
                         f"class={qos_class}; retry in ~{self.retry_after_s:.2f}s")


class TokenBucket:
    """A token bucket on an injectable monotonic clock, under a lock.
    ``burst`` defaults to twice the rate, at least 1."""

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        if self.rate <= 0:
            raise ValueError(f"rate must be positive, got {rate!r}")
        self.burst = float(burst) if burst is not None else max(2 * self.rate, 1.0)
        self._tokens = self.burst
        self._clock = clock
        self._stamp = clock()
        self._lock = threading.Lock()

    def try_take(self, n: float = 1.0) -> Tuple[bool, float]:
        """Take ``n`` tokens if there are: ``(admitted, retry_after_s)``,
        the wait being the deficit over the refill rate."""
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst, self._tokens + (now - self._stamp) * self.rate)
            self._stamp = now
            if self._tokens >= n:
                self._tokens -= n
                return True, 0.0
            return False, (n - self._tokens) / self.rate

    def snapshot(self) -> dict:
        with self._lock:
            tokens = min(self.burst, self._tokens + (self._clock() - self._stamp) * self.rate)
        return {"rate": self.rate, "burst": self.burst, "tokens": round(tokens, 3)}


def _parse_fractions(spec: Optional[str]) -> Dict[str, float]:
    """``GORDO_QOS_SHED_FRACTIONS`` (``"batch=0.6,best_effort=0.3"``) over
    the defaults; unknown classes and values outside (0, 1] are ignored."""
    fractions = dict(DEFAULT_SHED_FRACTIONS)
    for part in (spec or "").split(","):
        if "=" not in part:
            continue
        name, _, raw = part.partition("=")
        name = name.strip().lower().replace("-", "_")
        if name not in fractions:
            continue
        try:
            value = float(raw)
        except ValueError:
            continue
        if 0 < value <= 1.0:
            fractions[name] = value
    return fractions


def parse_tenants(spec: Optional[str], clock=time.monotonic) -> Dict[str, TokenBucket]:
    """``GORDO_QOS_TENANTS``, a JSON object
    (``{"acme": {"rate": 50, "burst": 100}, "backfill": {"rate": 5}}``), as
    buckets. A malformed document gives none and a malformed tenant is
    left out, each with a warning: a typo must not refuse the fleet."""
    if not spec:
        return {}
    try:
        doc = json.loads(spec)
        if not isinstance(doc, dict):
            raise ValueError("tenant config must be a JSON object")
    except ValueError as exc:
        logger.warning("ignoring malformed %s: %s", _ENV_TENANTS, exc)
        return {}
    buckets: Dict[str, TokenBucket] = {}
    for tenant, cfg in doc.items():
        if not isinstance(cfg, dict) or "rate" not in cfg:
            logger.warning("ignoring tenant %r: no rate", tenant)
            continue
        try:
            buckets[str(tenant)[:64]] = TokenBucket(cfg["rate"], cfg.get("burst"), clock=clock)
        except (TypeError, ValueError) as exc:
            logger.warning("ignoring tenant %r: %s", tenant, exc)
    return buckets


def _float_env(environ, key: str, default: float) -> float:
    try:
        return float(environ.get(key, default))
    except (TypeError, ValueError):
        return default


class AdmissionController:
    """Admit or refuse a scoring request by the three rules of the module
    docstring. One an app; ``burn_for`` (class -> burn or None) is wired
    to the SLO tracker after construction."""

    def __init__(self, tenants: Optional[Dict[str, TokenBucket]] = None,
                 shed_fractions: Optional[Dict[str, float]] = None,
                 burn_shed: float = DEFAULT_BURN_SHED, clock: Callable[[], float] = time.monotonic):
        self.buckets = dict(tenants or {})
        self.known_tenants = frozenset(self.buckets)
        fractions = dict(DEFAULT_SHED_FRACTIONS)
        if shed_fractions:
            for name, value in shed_fractions.items():
                if name in fractions and 0 < value <= 1.0:
                    fractions[name] = float(value)
        self.shed_fractions = fractions
        # pressure starts where the weakest class starts shedding
        self.pressure_fraction = min(fractions.values())
        self.burn_shed = float(burn_shed)
        self._clock = clock
        self.burn_for: Optional[Callable[[str], Optional[float]]] = None
        self._lock = threading.Lock()
        # (tenant label, class) -> admitted; (tenant label, class, reason) -> shed
        self.admitted: Dict[Tuple[str, str], int] = {}
        self.shed: Dict[Tuple[str, str, str], int] = {}
        self.unknown_tenants = 0

    @classmethod
    def from_env(cls, env=os, clock: Callable[[], float] = time.monotonic) -> "AdmissionController":
        environ = getattr(env, "environ", env)
        return cls(tenants=parse_tenants(environ.get(_ENV_TENANTS), clock=clock),
                   shed_fractions=_parse_fractions(environ.get(_ENV_FRACTIONS)),
                   burn_shed=_float_env(environ, _ENV_BURN_SHED, DEFAULT_BURN_SHED), clock=clock)

    def admit(self, rc: RequestClass, queue_depth: int = 0, max_queue: Optional[int] = None,
              drain_s: float = 0.05) -> str:
        """Admit ``rc`` or raise :class:`QosShed`; ``queue_depth`` and
        ``max_queue`` are the engine's at the call, ``drain_s`` its drain
        estimate (the ``Retry-After`` of a pressure or burn refusal).
        Returns the bounded tenant label to put on the request's series."""
        label = rc.label_tenant(self.known_tenants)
        if label == "other":
            with self._lock:
                self.unknown_tenants += 1
        bucket = self.buckets.get(rc.tenant)
        if bucket is not None:
            ok, wait_s = bucket.try_take()
            if not ok:
                self._count_shed(label, rc.qos_class, "tenant_rate")
                raise QosShed("tenant_rate", wait_s, tenant=label, qos_class=rc.qos_class)
        if max_queue:
            fraction = self.shed_fractions.get(rc.qos_class, 1.0)
            if queue_depth >= math.ceil(fraction * max_queue):
                self._count_shed(label, rc.qos_class, "queue_pressure")
                raise QosShed("queue_pressure", max(drain_s, 0.05), tenant=label, qos_class=rc.qos_class)
            if (fraction < 1.0 and self.burn_for is not None
                    and queue_depth >= math.ceil(self.pressure_fraction * max_queue)):
                burn = self.burn_for(rc.qos_class)
                if burn is not None and burn >= self.burn_shed:
                    others = [b for c in CLASSES if c != rc.qos_class and (b := self.burn_for(c)) is not None]
                    if not others or burn >= max(others):
                        self._count_shed(label, rc.qos_class, "goodput_burn")
                        raise QosShed("goodput_burn", max(drain_s, 0.05), tenant=label, qos_class=rc.qos_class)
        with self._lock:
            key = (label, rc.qos_class)
            self.admitted[key] = self.admitted.get(key, 0) + 1
        return label

    def _count_shed(self, tenant: str, qos_class: str, reason: str) -> None:
        with self._lock:
            key = (tenant, qos_class, reason)
            self.shed[key] = self.shed.get(key, 0) + 1

    def _counts(self):
        with self._lock:
            return dict(self.admitted), dict(self.shed), self.unknown_tenants

    def snapshot(self) -> dict:
        """The controller's state (``/qos``)."""
        admitted, shed, unknown = self._counts()
        return {
            "tenants": {t: b.snapshot() for t, b in sorted(self.buckets.items())},
            "shed_fractions": dict(self.shed_fractions),
            "burn_shed_threshold": self.burn_shed,
            "admitted": {f"{t}|{c}": n for (t, c), n in sorted(admitted.items())},
            "shed": {f"{t}|{c}|{r}": n for (t, c, r), n in sorted(shed.items())},
            "unknown_tenants": unknown,
        }

    def install_collector(self, registry) -> None:
        """Render the counters through ``registry`` from the same dicts
        ``/qos`` reads (``gordo_qos_*``)."""
        if registry is None:
            return
        ref = weakref.ref(self)

        def collect():
            ctl = ref()
            if ctl is None:
                return
            admitted, shed, unknown = ctl._counts()
            for (tenant, cls), n in sorted(admitted.items()):
                yield ("gordo_qos_admitted_total", "counter", "Requests admitted by the QoS controller",
                       {"tenant": tenant, "class": cls}, n)
            for (tenant, cls, reason), n in sorted(shed.items()):
                yield ("gordo_qos_shed_total", "counter", "Requests refused at admission (429 + Retry-After)",
                       {"tenant": tenant, "class": cls, "reason": reason}, n)
            yield ("gordo_qos_unknown_tenant_total", "counter",
                   "Requests whose tenant was collapsed to the 'other' label", {}, unknown)

        registry.collector(collect, key="qos_admission")
