"""Resample every tag to one resolution and outer-join them, without pandas.

Counterpart of ``fused_agg_join`` in ``gordo_components_tpu/dataset/resample.py``
(its fast path, which the JAX package takes for the default ``mean``
aggregation and every resolution that divides a day), over UTC
nanosecond timestamps:

    bucket = floor(timestamp / resolution)
    mean   = bincount(bucket, weights=values) / bincount(bucket)   (NaN-aware)

Each tag's buckets span floor(first kept sample)..floor(last kept sample);
buckets with only NaN samples bound the range but hold NaN. The joined index
is the sorted union of the tags' ranges; a bucket some tag does not cover
holds NaN for it. The pandas fallback of the JAX package (other
aggregations, resolutions that do not divide a day) is not ported: those
raise.
"""

from typing import Any, Dict, List, Tuple

import numpy as np

from gordo_components_torch.dataset.data_provider.base import Series

_DAY_NS = 86_400_000_000_000
_MAX_BUCKETS = 20_000_000
_FUSED_AGGS = ("mean", "sum", "min", "max")


def fused_agg_join(
    series_list: List[Series], start_ns: int, end_ns: int, res_ns: int, aggregation: str = "mean"
) -> Tuple[np.ndarray, Dict[str, np.ndarray], Dict[str, Any]]:
    """Resample (``aggregation`` per bucket) and outer-join the series
    over ``[start_ns, end_ns)``. Returns (bucket timestamps int64 ns,
    name -> column, per-tag row metadata)."""
    if aggregation not in _FUSED_AGGS:
        raise NotImplementedError(
            f"aggregation {aggregation!r}: the port resamples with {_FUSED_AGGS} only"
        )
    if res_ns <= 0 or _DAY_NS % res_ns != 0:
        raise NotImplementedError("the port resamples at resolutions that divide one day only")
    names = [s.name for s in series_list]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tag names in {names}")

    meta: Dict[str, Any] = {}
    cols: List[Tuple[str, Any, int, np.ndarray]] = []  # (name, dtype, lo, aggregated)
    for s in series_list:
        meta[str(s.name)] = {"rows_raw": int(s.values.size)}
        values = np.asarray(s.values)
        out_dtype = np.float32 if values.dtype == np.float32 else np.float64
        ts = np.asarray(s.index, np.int64)
        keep = (ts >= start_ns) & (ts < end_ns)
        ts, values = ts[keep], values[keep]
        if ts.size == 0:
            if s.values.size:
                meta[str(s.name)]["rows_resampled"] = 0
            cols.append((s.name, out_dtype, -1, np.empty(0)))
            continue
        bucket = ts // res_ns
        lo = int(bucket.min())
        n = int(bucket.max()) - lo + 1
        if n > _MAX_BUCKETS:
            raise ValueError(f"tag {s.name!r} spans {n} buckets, more than {_MAX_BUCKETS}")
        offs = bucket - lo
        fvals = values.astype(np.float64)
        good = ~np.isnan(fvals)
        o, v = offs[good], fvals[good]
        counts = np.bincount(o, minlength=n)
        if aggregation == "mean":
            with np.errstate(invalid="ignore", divide="ignore"):
                agg = np.bincount(o, weights=v, minlength=n) / counts  # 0/0 -> NaN
        elif aggregation == "sum":
            agg = np.bincount(o, weights=v, minlength=n)
        else:
            agg = np.full(n, np.inf if aggregation == "min" else -np.inf)
            (np.minimum if aggregation == "min" else np.maximum).at(agg, o, v)
            agg[counts == 0] = np.nan
        meta[str(s.name)]["rows_resampled"] = n
        cols.append((s.name, out_dtype, lo, agg.astype(out_dtype)))

    ranged = [(lo, lo + a.size) for (_, _, lo, a) in cols if a.size]
    if not ranged:
        return np.empty(0, np.int64), {name: np.empty(0, dt) for name, dt, _, _ in cols}, meta
    glo = min(lo for lo, _ in ranged)
    ghi = max(end for _, end in ranged)
    if ghi - glo > _MAX_BUCKETS:
        raise ValueError(f"the tags span {ghi - glo} buckets, more than {_MAX_BUCKETS}")
    covered = np.zeros(ghi - glo, dtype=bool)
    for lo, end in ranged:
        covered[lo - glo:end - glo] = True
    buckets = np.flatnonzero(covered) + glo
    data = {}
    for name, dtype, lo, agg in cols:
        col = np.full(buckets.size, np.nan)
        if agg.size:
            pos = buckets - lo
            inside = (pos >= 0) & (pos < agg.size)
            col[inside] = agg[pos[inside]]
        data[name] = col.astype(dtype, copy=False)
    return buckets * res_ns, data, meta
