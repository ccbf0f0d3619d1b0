"""Resample every tag to one resolution and outer-join them, without pandas.

Counterpart of the JAX package's ``join_timeseries``
(``gordo_components_tpu/dataset/datasets.py``) over UTC nanosecond
timestamps, with two paths.

The fused path is the JAX package's own (``fused_agg_join`` in
``gordo_components_tpu/dataset/resample.py``): for ``mean``, ``sum``,
``min`` and ``max`` at a resolution that divides a day, where every tag
is a float series (for ``mean``, an integer one too),

    bucket = floor(timestamp / resolution)
    mean   = bincount(bucket, weights=values) / bincount(bucket)   (NaN-aware)

Every other case is the JAX package's pandas fallback,
``series.resample(resolution).agg(aggregation)``, computed as pandas
computes it:

- bins: a fixed resolution's bins start at midnight (UTC) of the first kept
  sample's day (``origin="start_day"``) and are closed and labelled left;
  a calendar offset's (weeks, months, quarters, years, business days and
  their multiples, ``times.parse_resolution``) are stepped by pandas'
  offset arithmetic (``times.offset_apply``) from the first sample's day:
  an end-anchored offset's (``W``, ``ME``, ``QE``, ``YE``) bin holds the
  days after the previous edge through its own and is labelled by it
  (closed and labelled right), a start-anchored one's (``MS``, ``QS``,
  ``YS``, ``B``) is closed and labelled left, so a weekend's samples fall
  in the Friday before;
- the aggregations ``mean``, ``sum``, ``min``, ``max``, ``median``,
  ``first``, ``last``, ``std``, ``var``, ``sem``, ``count`` and ``prod``
  skip NaN and follow pandas' group kernels step by step (Kahan-compensated
  sums and means, Welford variances, with the dtypes they compute in), so
  the values match pandas' bitwise;
- dtypes: a float series keeps its dtype (``count`` gives int64); an
  integer one gives float64 for ``mean``, ``median``, ``std``, ``var`` and
  ``sem``, keeps its dtype for ``sum`` and ``prod`` (computed in 64 bits;
  64 bits where a result does not fit), and for ``min``,
  ``max``, ``first`` and ``last`` unless a bin is empty (then float64);
- an empty bin holds NaN, 0 for ``sum`` and ``count``, 1 for ``prod``.

Each tag's bins span its first kept sample's bin to its last's; the joined
index is the sorted union of the tags' bins, and a bin a tag does not cover
holds NaN for it (an integer column that gains one becomes float64). Other
aggregations (``ohlc``, which the JAX package's join refuses too, and any
that is not one of these strings) raise ``NotImplementedError`` naming
them.
"""

import datetime
from typing import Any, Dict, List, Tuple, Union

import numpy as np

from gordo_components_torch.dataset.data_provider.base import Series
from gordo_components_torch.dataset.times import RIGHT_CLOSED, Resolution, offset_apply, on_offset

_DAY_NS = 86_400_000_000_000
_MAX_BUCKETS = 20_000_000
_FUSED_AGGS = ("mean", "sum", "min", "max")
AGGREGATIONS = ("mean", "sum", "min", "max", "median", "first", "last", "std", "var", "sem", "count", "prod")
# integer series give float64 for these
_FLOAT_AGGS = ("mean", "median", "std", "var", "sem")


def fused_agg_join(
    series_list: List[Series], start_ns: int, end_ns: int, resolution: Union[int, Resolution],
    aggregation: str = "mean",
) -> Tuple[np.ndarray, Dict[str, np.ndarray], Dict[str, Any]]:
    """Resample (``aggregation`` per bin) and outer-join the series over
    ``[start_ns, end_ns)`` at ``resolution`` (a ``Resolution`` or a fixed
    step in ns). Returns (bin labels int64 ns, name -> column, per-tag row
    metadata)."""
    if not isinstance(aggregation, str) or aggregation not in AGGREGATIONS:
        raise NotImplementedError(f"aggregation {aggregation!r}: the port resamples with {AGGREGATIONS}")
    res = resolution if isinstance(resolution, Resolution) else Resolution(int(resolution))
    if res.calendar is None and res.step_ns <= 0:
        raise ValueError(f"resolution must be positive, got {res.step_ns} ns")
    names = [s.name for s in series_list]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tag names in {names}")
    # the fused path takes the whole join or none of it, as in the JAX
    # package: an integer tag under another aggregation than mean sends
    # every tag to the pandas path
    fused = (res.calendar is None and res.timedelta and _DAY_NS % res.step_ns == 0 and aggregation in _FUSED_AGGS
             and (aggregation == "mean" or all(np.asarray(s.values).dtype in (np.float32, np.float64)
                                               for s in series_list if np.asarray(s.values).size)))

    if not fused and not res.offset and any(np.asarray(s.values).size for s in series_list):
        # as the JAX package's resample of its first tag with samples refuses it
        raise ValueError("resolution: a spelling pandas' resample does not read (the fused path alone takes it: "
                         f"{', '.join(_FUSED_AGGS)} of float tags at a step dividing a day)")
    meta: Dict[str, Any] = {}
    cols: List[Tuple[str, np.ndarray, np.ndarray]] = []  # (name, bin labels, column)
    for s in series_list:
        meta[str(s.name)] = {"rows_raw": int(s.values.size)}
        values = np.asarray(s.values)
        ts = np.asarray(s.index, np.int64)
        keep = (ts >= start_ns) & (ts < end_ns)
        ts, values = ts[keep], values[keep]
        if ts.size == 0:
            if s.values.size:
                meta[str(s.name)]["rows_resampled"] = 0
            if fused:
                dtype = np.float32 if values.dtype == np.float32 else np.float64
            elif s.values.size:
                dtype = _result_dtype(values.dtype, aggregation, has_empty=False)
            else:  # the JAX package joins a tag with no samples as it came
                dtype = values.dtype
            cols.append((s.name, np.empty(0, np.int64), np.empty(0, dtype)))
            continue
        if fused:
            labels, col = _fused_column(s.name, ts, values, res.step_ns, aggregation)
        else:
            labels, col = _pandas_column(s.name, ts, values, res, aggregation)
        meta[str(s.name)]["rows_resampled"] = int(labels.size)
        cols.append((s.name, labels, col))

    index = np.unique(np.concatenate([labels for _, labels, _ in cols])) if cols else np.empty(0, np.int64)
    data = {}
    for name, labels, col in cols:
        if labels.size == index.size:  # covers every bin: the union is its own bins
            data[name] = col
            continue
        dtype = np.float64 if col.dtype.kind in "iub" else col.dtype
        out = np.full(index.size, np.nan, dtype)
        out[np.searchsorted(index, labels)] = col
        data[name] = out
    return index, data, meta


def _fused_column(name, ts: np.ndarray, values: np.ndarray, step: int, aggregation: str):
    """The JAX package's fused bincount path: epoch-floored buckets."""
    out_dtype = np.float32 if values.dtype == np.float32 else np.float64
    bucket = ts // step
    lo = int(bucket.min())
    n = int(bucket.max()) - lo + 1
    if n > _MAX_BUCKETS:
        raise ValueError(f"tag {name!r} spans {n} buckets, more than {_MAX_BUCKETS}")
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
    return (lo + np.arange(n, dtype=np.int64)) * step, agg.astype(out_dtype)


def _result_dtype(dtype: np.dtype, aggregation: str, has_empty: bool) -> np.dtype:
    """pandas' result dtype of ``aggregation`` over ``dtype`` values."""
    if aggregation == "count":
        return np.dtype(np.int64)
    if dtype.kind == "f":
        return dtype
    if aggregation in _FLOAT_AGGS or (has_empty and aggregation in ("min", "max", "first", "last")):
        return np.dtype(np.float64)
    return dtype


def _pandas_column(name, ts: np.ndarray, values: np.ndarray, res: Resolution, aggregation: str):
    """``resample(res).agg(aggregation)`` of one tag: (bin labels, column)."""
    if values.dtype.kind not in "fiu":
        raise NotImplementedError(f"tag {name!r}: resampling {values.dtype} values")
    order = np.argsort(ts, kind="stable")  # pandas sorts the index stably
    ts, values = ts[order], values[order]
    if res.calendar is not None:
        labels, b = _calendar_bins(ts, res)
        return labels, _aggregate(b, labels.size, values, aggregation)
    step = res.step_ns
    origin = (int(ts[0]) // _DAY_NS) * _DAY_NS  # midnight of the first sample's day
    b = (ts - origin) // step
    lo = int(b[0])
    n = int(b[-1]) - lo + 1
    if n > _MAX_BUCKETS:
        raise ValueError(f"tag {name!r} spans {n} buckets, more than {_MAX_BUCKETS}")
    labels = origin + (lo + np.arange(n, dtype=np.int64)) * step
    return labels, _aggregate(b - lo, n, values, aggregation)


_EPOCH_DAY = datetime.date(1970, 1, 1).toordinal()


def _calendar_bins(ts: np.ndarray, res: Resolution):
    """pandas' bins of a calendar offset over sorted ``ts``: (bin labels,
    each sample's bin). The edges run from the offset date before the
    first sample's day (one period back for an end-anchored offset, the
    date rolled back onto the offset for the others) to one period past
    the last sample's day, stepped ``res.n`` periods from there. An
    end-anchored offset's bins are closed and labelled right, each edge
    moved to the last nanosecond of its day (the day is in the bin), and
    an edge past the data is dropped; the others' bins are closed and
    labelled left."""
    first = datetime.date.fromordinal(_EPOCH_DAY + int(ts[0]) // _DAY_NS)
    last = datetime.date.fromordinal(_EPOCH_DAY + int(ts[-1]) // _DAY_NS)
    right = res.calendar in RIGHT_CLOSED
    if right:
        start = offset_apply(res, first, -res.n)
    else:
        start = first if on_offset(res, first) else offset_apply(res, first, -1)
    end = offset_apply(res, last, res.n)
    # pandas' date_range(start, end): both rolled onto the offset, then n periods a step
    cur = start if on_offset(res, start) else offset_apply(res, start, 1)
    if not on_offset(res, end):
        end = offset_apply(res, end, -1)
    days = []
    while cur <= end:
        days.append(cur.toordinal() - _EPOCH_DAY)
        if len(days) > _MAX_BUCKETS:
            raise ValueError(f"resolution spans more than {_MAX_BUCKETS} buckets")
        cur = offset_apply(res, cur, res.n)
    edges = np.asarray(days, np.int64) * _DAY_NS
    if right:
        ends = edges + (_DAY_NS - 1)
        if ends.size >= 2 and ends[-2] > ts[-1]:  # the last edge holds no sample
            edges, ends = edges[:-1], ends[:-1]
        return edges[1:], np.searchsorted(ends, ts, "left") - 1
    return edges[:-1], np.searchsorted(edges, ts, "right") - 1


def _positions(b: np.ndarray, n: int):
    """For ``b`` sorted (each bin's samples one run): the sample indices
    holding the ``j``-th sample of their bin, for j = 0, 1, ...; within a
    step no bin appears twice."""
    pos = np.arange(b.size) - np.searchsorted(b, np.arange(n))[b]
    order = np.argsort(pos, kind="stable")
    offs = np.concatenate([[0], np.cumsum(np.bincount(pos))])
    return [order[offs[j]:offs[j + 1]] for j in range(offs.size - 1)]


def _kahan_sums(b: np.ndarray, v: np.ndarray, n: int) -> np.ndarray:
    """Each bin's Kahan-compensated sum in ``v``'s dtype, sample by sample
    in time order, as pandas' ``group_sum``/``group_mean`` add."""
    sumx = np.zeros(n, v.dtype)
    comp = np.zeros(n, v.dtype)
    for idx in _positions(b, n):
        g, val = b[idx], v[idx]
        y = val - comp[g]
        s0 = sumx[g]
        t = s0 + y
        c = (t - s0) - y
        c[c != c] = 0  # an infinite value: keep the sum infinite, not NaN
        comp[g], sumx[g] = c, t
    return sumx


def _welford(b: np.ndarray, v: np.ndarray, n: int) -> np.ndarray:
    """Each bin's sum of squared deviations in ``v``'s dtype, by Welford's
    update in time order, as pandas' ``group_var`` accumulates it."""
    nobs = np.zeros(n, np.int64)
    mean = np.zeros(n, v.dtype)
    m2 = np.zeros(n, v.dtype)
    for idx in _positions(b, n):
        g, val = b[idx], v[idx]
        nobs[g] += 1
        old = mean[g]
        new = old + (val - old) / nobs[g].astype(v.dtype)
        mean[g] = new
        m2[g] = m2[g] + (val - new) * (val - old)
    return m2


def _aggregate(b: np.ndarray, n: int, values: np.ndarray, aggregation: str) -> np.ndarray:
    """``aggregation`` of each of ``n`` bins over ``values`` (time-ordered;
    ``b`` each sample's bin, non-decreasing), NaN skipped, as pandas."""
    is_int = values.dtype.kind in "iu"
    if is_int:
        bv, vv = b, values
    else:
        valid = ~np.isnan(values)
        bv, vv = b[valid], values[valid]
    count = np.bincount(bv, minlength=n)
    empty = count == 0
    if aggregation == "count":
        return count.astype(np.int64)
    if aggregation in ("sum", "prod"):
        if is_int:  # pandas adds and multiplies integers in 64 bits
            wide = np.int64 if values.dtype.kind == "i" else np.uint64
            acc = np.zeros(n, wide) if aggregation == "sum" else np.ones(n, wide)
            (np.add if aggregation == "sum" else np.multiply).at(acc, bv, vv.astype(wide))
            # back to the values' dtype where every result fits it, as pandas casts
            narrow = acc.astype(values.dtype)
            return narrow if np.array_equal(narrow, acc) else acc
        if aggregation == "sum":
            return _kahan_sums(bv, vv, n)
        acc = np.ones(n, values.dtype)
        np.multiply.at(acc, bv, vv)  # in sample order, in the values' dtype
        return acc
    out_dtype = _result_dtype(values.dtype, aggregation, has_empty=bool(empty.any()))
    if aggregation in ("min", "max", "first", "last"):
        out = np.zeros(n, values.dtype)
        have = ~empty
        if aggregation == "first":
            out[have] = vv[np.searchsorted(bv, np.flatnonzero(have), "left")]
        elif aggregation == "last":
            out[have] = vv[np.searchsorted(bv, np.flatnonzero(have), "right") - 1]
        elif have.any():  # each bin's samples are one run
            starts = np.searchsorted(bv, np.flatnonzero(have), "left")
            out[have] = (np.minimum if aggregation == "min" else np.maximum).reduceat(vv, starts)
        out = out.astype(out_dtype)
        if empty.any():
            out[empty] = np.nan
        return out
    if aggregation == "median":  # pandas' float64 median: the middle one, or the middle two's mean
        vf = vv.astype(np.float64)
        srt = vf[np.lexsort((vf, bv))]
        starts = np.searchsorted(bv, np.arange(n), "left")
        out = np.full(n, np.nan)
        have = ~empty
        mid = starts[have] + count[have] // 2
        odd = (count[have] % 2) == 1
        vals = np.where(odd, srt[mid], (srt[mid] + srt[np.maximum(mid - 1, 0)]) / 2)
        out[have] = vals
        return out.astype(out_dtype)
    if aggregation == "mean":  # in the values' float dtype, float64 for integers
        work = np.float64 if is_int else values.dtype
        with np.errstate(invalid="ignore", divide="ignore"):
            out = _kahan_sums(bv, vv.astype(work), n) / count.astype(work)
        out[empty] = np.nan
        return out.astype(out_dtype)
    # var in the values' float dtype; std and sem in float64, as pandas
    work = values.dtype.type if (aggregation == "var" and not is_int) else np.float64
    m2 = _welford(bv, vv.astype(work), n)
    ct = count.astype(work)
    with np.errstate(invalid="ignore", divide="ignore"):
        if aggregation == "var":
            out = m2 / (ct - work(1))
        elif aggregation == "std":
            out = np.sqrt(m2 / (ct - work(1)))
        else:
            out = np.sqrt(m2 / (ct - work(1)) / ct)
    out[count <= 1] = np.nan
    return out.astype(out_dtype)
