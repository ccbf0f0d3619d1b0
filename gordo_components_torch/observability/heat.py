"""Per-member access heat: which members of the bank are hot now.

Counterpart of ``gordo_components_tpu/observability/heat.py``. Every
routed row feeds an exponentially decayed per-member cell (half-life
``GORDO_HEAT_HALFLIFE_S``, 300 s), whose steady state is proportional to
the member's current routed-row rate: at a steady rate ``r`` a cell
converges to ``r * halflife / ln 2``, so ``rate = heat * ln 2 / halflife``.
The rates classify members hot (``GORDO_HEAT_HOT_RATE``, 10 rows/s) and
warm (``GORDO_HEAT_WARM_RATE``, 1), the rest cold; the placement planner
and the low-precision tiers read the ranking.

- The scoring path pays one dict get and set a request: the bank's
  ``_host_prep`` adds the request's rows to ``pending``. Decay runs only
  in :meth:`HeatAccountant.sample`, on the ``GORDO_HEAT_SAMPLE_S``
  cadence (10 s) or when forced. ``GORDO_HEAT=0`` builds no accountant,
  and the bank pays one ``None`` check.
- The registry gets three tier-count gauges, two gauges and one log-binned
  rate histogram, never a series a member; ``GET .../heat?top=`` serves
  the ranking. The registry, ``/heat`` and ``/stats`` read one cached
  snapshot, rebuilt a sample.
- The accountant is the app's: every bank generation feeds it, so the
  decayed history survives ``/reload``; :meth:`HeatAccountant.bind_bank`
  points the per-bucket attribution at the live bank.

Threads: ``pending`` has one writer, the engine's thread (a reload's
warm-up does not feed it). A fold swaps the dict, so at most one update
that falls between a get and its set lands in the retired dict and is
lost: a bounded race, never a torn read. ``sample`` and the reads take
the accountant's lock.

:func:`merge_heat_snapshots` is the watchman's pure rollup of several
replicas' ``/heat`` bodies (``watchman/server.py``'s ``fleet_heat``).
"""

import math
import os
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from gordo_components_torch.observability.metrics import Histogram
from gordo_components_torch.utils import env_num

__all__ = ["HeatAccountant", "heat_from_env", "merge_heat_snapshots"]

_ENV_ENABLE = "GORDO_HEAT"

LN2 = math.log(2.0)

# a cell below this many decayed rows can move no tier: dropped
_EVICT_HEAT_ROWS = 1e-3

DEFAULT_TOP_N = 10


def _tier_of(rate: float, hot_rate: float, warm_rate: float) -> str:
    if rate >= hot_rate:
        return "hot"
    if rate >= warm_rate:
        return "warm"
    return "cold"


class HeatAccountant:
    """Decayed routed-row rates a member, for one serving app.

    ``clock`` gives epoch seconds (the app's clock seam's ``time``), so a
    replayed timeline decays heat in replayed seconds."""

    def __init__(self, halflife_s: Optional[float] = None, hot_rate: Optional[float] = None,
                 warm_rate: Optional[float] = None, sample_interval_s: Optional[float] = None,
                 registry=None, clock: Callable[[], float] = time.time):
        if halflife_s is None:
            halflife_s = env_num("GORDO_HEAT_HALFLIFE_S", 300.0, float)
        self.halflife_s = max(1e-3, float(halflife_s))
        if hot_rate is None:
            hot_rate = env_num("GORDO_HEAT_HOT_RATE", 10.0, float)
        if warm_rate is None:
            warm_rate = env_num("GORDO_HEAT_WARM_RATE", 1.0, float)
        self.hot_rate = float(hot_rate)
        self.warm_rate = float(warm_rate)
        if self.warm_rate > self.hot_rate:
            raise ValueError(f"GORDO_HEAT_WARM_RATE ({self.warm_rate}) must not exceed "
                             f"GORDO_HEAT_HOT_RATE ({self.hot_rate})")
        if sample_interval_s is None:
            sample_interval_s = env_num("GORDO_HEAT_SAMPLE_S", 10.0, float)
        self.sample_interval_s = max(0.001, float(sample_interval_s))
        self._clock = clock
        self.pending: Dict[str, float] = {}  # the scoring path's mailbox
        self._heat: Dict[str, float] = {}  # member -> decayed rows
        self._last_fold: Optional[float] = None
        self._lock = threading.Lock()
        self._cached: Optional[Dict[str, Any]] = None
        self._rates: List[Tuple[str, float]] = []  # (member, rate), hottest first
        self._histogram: Optional[Histogram] = None
        self._n_samples = 0
        self._bucket_map_fn: Optional[Callable[[], Dict[str, str]]] = None
        if registry is not None:
            registry.collector(self._collect, key="bank_heat")

    @classmethod
    def from_env(cls, registry=None, clock: Callable[[], float] = time.time) -> Optional["HeatAccountant"]:
        """An accountant, or None when ``GORDO_HEAT=0``."""
        if os.environ.get(_ENV_ENABLE, "1") == "0":
            return None
        return cls(registry=registry, clock=clock)

    def bind_bank(self, bank) -> None:
        """Attribute members to ``bank``'s buckets, from its index (member
        -> bucket key -> the bucket's label), through a weak reference: a
        swapped-out bank is not pinned. The heat carries over."""
        ref = weakref.ref(bank)

        def bucket_map() -> Dict[str, str]:
            b = ref()
            if b is None:
                return {}
            buckets = b._buckets
            return {name: buckets[key].label for name, (key, _i) in list(b._index.items()) if key in buckets}

        with self._lock:
            self._bucket_map_fn = bucket_map
            self._cached = None

    def _fold(self, now: float) -> None:
        """Decay every cell to ``now`` and absorb the mailbox (lock held)."""
        pending, self.pending = self.pending, {}
        last, heat = self._last_fold, self._heat
        if last is not None and now > last:
            decay = 0.5 ** ((now - last) / self.halflife_s)
            for name in list(heat):
                cell = heat[name] * decay
                if cell < _EVICT_HEAT_ROWS and name not in pending:
                    del heat[name]
                else:
                    heat[name] = cell
        for name, rows in pending.items():
            heat[name] = heat.get(name, 0.0) + rows
        self._last_fold = now

    def sample(self, now: Optional[float] = None, force: bool = False) -> bool:
        """Fold and rebuild the snapshot when the cadence (or ``force``)
        says so; whether a sample landed."""
        if now is None:
            now = self._clock()
        with self._lock:
            if not force and self._last_fold is not None and now - self._last_fold < self.sample_interval_s:
                return False
            self._fold(now)
            self._rebuild(now)
            self._n_samples += 1
            return True

    def _rebuild(self, now: float) -> None:
        """Rates, tiers, the per-bucket breakdown and the rate histogram
        from the folded state (lock held). Bank members with no traffic
        count as cold, at rate 0."""
        rate_of = LN2 / self.halflife_s
        rates = sorted(((name, heat * rate_of) for name, heat in self._heat.items()),
                       key=lambda kv: (-kv[1], kv[0]))
        bucket_map = self._bucket_map_fn() if self._bucket_map_fn else {}
        heated = {name for name, _ in rates}
        rates.extend((name, 0.0) for name in sorted(bucket_map) if name not in heated)
        tiers = {"hot": 0, "warm": 0, "cold": 0}
        per_bucket: Dict[str, Dict[str, int]] = {}
        # the floor: one decayed row over a half-life
        hist = Histogram(lo=max(1e-6, rate_of), hi=1e7, bins_per_decade=4)
        total_rate = 0.0
        for name, rate in rates:
            tier = _tier_of(rate, self.hot_rate, self.warm_rate)
            tiers[tier] += 1
            total_rate += rate
            label = bucket_map.get(name)
            if label is not None:
                per_bucket.setdefault(label, {"hot": 0, "warm": 0, "cold": 0})[tier] += 1
            if rate > 0.0:
                hist.record(rate)
        self._rates = rates
        self._histogram = hist
        self._cached = {
            "halflife_s": self.halflife_s,
            "hot_rate": self.hot_rate,
            "warm_rate": self.warm_rate,
            "sample_interval_s": self.sample_interval_s,
            "n_samples": self._n_samples + 1,
            "sampled_at": round(now, 3),
            "members_tracked": len(self._heat),
            "members_total": len(rates),
            "tiers": tiers,
            "per_bucket": {label: dict(cell) for label, cell in sorted(per_bucket.items())},
            "rate_total": round(total_rate, 6),
            # (upper edge, members) of every nonempty bin of the rate histogram
            "histogram": [[None if math.isinf(edge) else round(edge, 6), int(n)]
                          for edge, n in _plain_bins(hist) if n],
        }

    def snapshot(self) -> Dict[str, Any]:
        """Tier counts and the rate distribution, cached until the next
        sample (the registry, ``/heat`` and ``/stats`` read it)."""
        self.sample()
        with self._lock:
            if self._cached is None:
                self._fold(self._clock())
                self._rebuild(self._last_fold or self._clock())
            return self._cached

    def ranked(self, top_n: int = DEFAULT_TOP_N) -> Dict[str, Any]:
        """The ``top_n`` hottest and coldest members from the cached fold;
        ties rank by name."""
        self.snapshot()
        with self._lock:
            n = max(0, int(top_n))
            hottest = [self._entry(name, rate) for name, rate in self._rates[:n]]
            coldest = [self._entry(name, rate)
                       for name, rate in sorted(self._rates, key=lambda kv: (kv[1], kv[0]))[:n]]
            return {"top": n, "hottest": hottest, "coldest": coldest}

    def _entry(self, name: str, rate: float) -> Dict[str, Any]:
        bucket_map = self._bucket_map_fn() if self._bucket_map_fn else {}
        # the tier of the rounded rate, as the fleet rollup sees it
        rate = round(rate, 6)
        return {"member": name, "rate": rate, "tier": _tier_of(rate, self.hot_rate, self.warm_rate),
                "bucket": bucket_map.get(name)}

    def rates(self) -> Dict[str, float]:
        """Member -> routed rows/s from the cached fold."""
        self.snapshot()
        with self._lock:
            return dict(self._rates)

    def _collect(self):
        """The registry's view: tier counts, totals and the rate histogram."""
        snap = self.snapshot()
        for tier, n in sorted(snap["tiers"].items()):
            yield ("gordo_heat_tier_members", "gauge",
                   "Bank members per access-heat tier (decayed routed-row rate vs the hot/warm thresholds)",
                   {"tier": tier}, n)
        yield ("gordo_heat_members_tracked", "gauge", "Members with non-evicted decayed heat state", {},
               snap["members_tracked"])
        yield ("gordo_heat_rows_rate", "gauge", "Fleet-summed decayed routed rows/second estimate", {},
               snap["rate_total"])
        with self._lock:
            hist = self._histogram
        if hist is not None:
            yield ("gordo_heat_member_rate", "histogram",
                   "Distribution of per-member decayed routed-row rates (log-binned; the bounded-cardinality "
                   "skew view)", {}, hist)


def _plain_bins(hist: Histogram) -> List[Tuple[float, int]]:
    """Non-cumulative (upper edge, count) pairs of a histogram."""
    out: List[Tuple[float, int]] = []
    prev = 0
    for edge, cum in hist.buckets():
        out.append((edge, cum - prev))
        prev = cum
    return out


def heat_from_env(registry=None, clock=None) -> Optional[HeatAccountant]:
    """An accountant on ``clock``'s ``time`` (the app's clock seam; None:
    the real wall clock), or None when ``GORDO_HEAT=0``."""
    return HeatAccountant.from_env(registry=registry, clock=clock.time if clock is not None else time.time)


def merge_heat_snapshots(bodies: Sequence[Optional[Dict[str, Any]]], top_n: int = DEFAULT_TOP_N) -> Dict[str, Any]:
    """Several replicas' ``/heat`` bodies as one fleet view: a member's
    rates sum across replicas, then re-rank; tiers and the per-bucket
    breakdown sum; the thresholds are the first enabled body's. With one
    replica the ranking, tiers and per-bucket breakdown are that body's.
    Only the members each body ranks are seen; ``members_total`` sums the
    true counts."""
    member_rate: Dict[str, float] = {}
    member_bucket: Dict[str, Optional[str]] = {}
    tiers = {"hot": 0, "warm": 0, "cold": 0}
    per_bucket: Dict[str, Dict[str, int]] = {}
    hot_rate = warm_rate = None
    members_total = 0
    rate_total = 0.0
    scraped = 0
    for body in bodies:
        if not body or not body.get("enabled", True):
            continue
        scraped += 1
        if hot_rate is None:
            hot_rate = float(body.get("hot_rate", 10.0))
            warm_rate = float(body.get("warm_rate", 1.0))
        members_total += int(body.get("members_total") or 0)
        rate_total += float(body.get("rate_total") or 0.0)
        for tier, n in (body.get("tiers") or {}).items():
            tiers[tier] = tiers.get(tier, 0) + int(n)
        for label, cell in (body.get("per_bucket") or {}).items():
            agg = per_bucket.setdefault(label, {"hot": 0, "warm": 0, "cold": 0})
            for tier, n in cell.items():
                agg[tier] = agg.get(tier, 0) + int(n)
        # one member in both of a body's lists counts once
        body_rates: Dict[str, Tuple[float, Any]] = {}
        for entry in list(body.get("hottest") or ()) + list(body.get("coldest") or ()):
            name = entry.get("member")
            if name:
                body_rates[name] = (float(entry.get("rate") or 0.0), entry.get("bucket"))
        for name, (rate, bucket) in body_rates.items():
            member_rate[name] = member_rate.get(name, 0.0) + rate
            if member_bucket.get(name) is None:
                member_bucket[name] = bucket
    hot_rate = 10.0 if hot_rate is None else hot_rate
    warm_rate = 1.0 if warm_rate is None else warm_rate

    def entry(name: str) -> Dict[str, Any]:
        rate = member_rate[name]
        return {"member": name, "rate": round(rate, 6), "tier": _tier_of(rate, hot_rate, warm_rate),
                "bucket": member_bucket.get(name)}

    desc = sorted(member_rate, key=lambda n: (-member_rate[n], n))
    asc = sorted(member_rate, key=lambda n: (member_rate[n], n))
    n = max(0, int(top_n))
    return {
        "replicas_scraped": scraped,
        "hot_rate": hot_rate,
        "warm_rate": warm_rate,
        "members_total": members_total,
        "rate_total": round(rate_total, 6),
        "tiers": tiers,
        "per_bucket": {label: dict(cell) for label, cell in sorted(per_bucket.items())},
        "top": n,
        "hottest": [entry(name) for name in desc[:n]],
        "coldest": [entry(name) for name in asc[:n]],
    }
