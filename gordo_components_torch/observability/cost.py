"""Per-bucket device cost: FLOPs, MFU and pad waste.

Counterpart of ``gordo_components_tpu/observability/cost.py``. An
analytic forward-FLOPs count a family (dense, variational, LSTM, conv),
computed once when a bucket is built, is multiplied by the goodput
ledger's measured device seconds and real-versus-padded row split, per
bucket: MFU, FLOPs a row, device seconds a 1,000 rows and a pad-waste
score.

- ``snapshot()`` joins one ledger read to the bank's FLOPs table and
  caches it; the registry collector, ``GET /costs`` and the ``/stats``
  embed read that cache, and :func:`merge_cost_snapshots` of one replica
  gives its body back, since both go through :func:`bucket_cost_row`.
- Series are labelled by bucket, never by member.
- The peak denominator carries its origin: ``env``
  (``GORDO_DEVICE_PEAK_FLOPS``), ``device`` (the table below, keyed by
  ``torch.cuda.get_device_name`` of the bank's card) or ``assumed`` (1
  TFLOP/s, so the CPU still exercises the arithmetic). The JAX contract
  is kept: MFU is against the card's dense bfloat16 peak whatever a
  bucket computes in, so a float32 bucket reads a low MFU.

FLOPs convention: a multiply-accumulate counts 2; bias adds, activations
and normalisation are left out.
"""

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from gordo_components_torch.utils import env_num

__all__ = [
    "dense_chain_flops", "lstm_step_flops", "lstm_stack_flops", "conv1d_autoencoder_flops",
    "estimate_flops_per_row", "resolve_peak_flops", "bucket_cost_row", "CostModel", "cost_from_env",
    "merge_cost_snapshots",
]

# the MFU denominator when nothing names the card: 1 TFLOP/s, "assumed"
_ASSUMED_PEAK_FLOPS = 1e12

# dense bfloat16 peak FLOP/s a card, by the name torch.cuda.get_device_name
# gives: the NVIDIA H100 Tensor Core GPU datasheet's H100 SXM figure
# (1,979 TFLOP/s is the sparse one)
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


# --------------------------------------------------------------------- #
# analytic forward FLOPs a family
# --------------------------------------------------------------------- #


def dense_chain_flops(n_features: int, encoding_dim, decoding_dim) -> float:
    """One row through a feedforward autoencoder: the chain n_features ->
    *encoding_dim -> *decoding_dim -> n_features, 2*in*out a layer."""
    dims = [int(n_features), *map(int, encoding_dim), *map(int, decoding_dim), int(n_features)]
    return float(sum(2 * a * b for a, b in zip(dims, dims[1:])))


def lstm_step_flops(n_features: int, dims) -> float:
    """One recurrent step through every layer of an LSTM stack: four gates
    of (in + hidden) x hidden products, 8*h*(in + h) a layer."""
    per_step = 0.0
    prev = int(n_features)
    for h in (int(d) for d in dims):
        per_step += 8.0 * h * (prev + h)
        prev = h
    return per_step


def lstm_stack_flops(n_features: int, dims, lookback: int) -> float:
    """One window through an LSTM stack: ``lookback`` steps, then the last
    step's dense head back to n_features."""
    dims = [int(d) for d in dims]
    return float(lookback) * lstm_step_flops(n_features, dims) + 2.0 * dims[-1] * int(n_features)


def conv1d_autoencoder_flops(n_features: int, channels, kernel_size: int, lookback: int) -> float:
    """One window through the conv autoencoder: stride-2 SAME encoder
    convs (the length halves, rounding up), stride-2 transposed decoder
    convs over the reversed channels (the length doubles), and a final
    stride-1 conv back to n_features; a layer is 2*out_len*K*in*out."""
    channels = [int(c) for c in channels]
    k = int(kernel_size)
    total = 0.0
    length = int(lookback)
    in_ch = int(n_features)
    for out_ch in channels:
        length = -(-length // 2)
        total += 2.0 * length * k * in_ch * out_ch
        in_ch = out_ch
    for out_ch in reversed(channels):
        length *= 2
        total += 2.0 * length * k * in_ch * out_ch
        in_ch = out_ch
    total += 2.0 * length * k * in_ch * int(n_features)
    return total


def _serving_dims(module) -> List[int]:
    """The widths of a dense or variational module's serving chain (the
    variational one's mean decode: encoder, mu, decoder, output)."""
    if module.family == "vae":
        return [module.n_features, *module.dims, module.latent_dim, *reversed(module.dims), module.n_features]
    return [module.layers[0].in_features, *(layer.out_features for layer in module.layers)]


def estimate_flops_per_row(module, n_features: int, lookback: int,
                           params_per_member: Optional[int] = None) -> Tuple[float, str]:
    """(forward FLOPs for one row, one window of a sequence bucket; method)
    for a bucket's module, by its family. A module of no known family gets
    the 2*params*steps bound, tagged ``params``.

    One divergence from the JAX package: its estimate duck-types on the
    module's attributes, and its variational module (``dims``, no
    ``encoding_dim``) falls to the LSTM closed form; here a variational
    bucket counts the mean decode the bank runs."""
    family = getattr(module, "family", None)
    if family in ("dense", "vae"):
        dims = _serving_dims(module)
        return float(sum(2 * a * b for a, b in zip(dims, dims[1:]))), "analytic"
    if family == "lstm":
        return lstm_stack_flops(n_features, module.dims, lookback), "analytic"
    if family == "conv":
        return conv1d_autoencoder_flops(n_features, module.channels, module.kernel_size, lookback), "analytic"
    if params_per_member:
        return 2.0 * float(params_per_member) * max(1, int(lookback)), "params"
    return 0.0, "unknown"


# --------------------------------------------------------------------- #
# the peak
# --------------------------------------------------------------------- #


def resolve_peak_flops(device=None) -> Tuple[float, str]:
    """(peak FLOP/s of one card, origin) for the MFU denominator:
    ``GORDO_DEVICE_PEAK_FLOPS``, else the table by the name of ``device``'s
    card (a CUDA device only), else the assumed 1 TFLOP/s."""
    raw = os.environ.get("GORDO_DEVICE_PEAK_FLOPS")
    if raw:
        return float(raw), "env"
    if device is not None and torch.device(device).type == "cuda":
        peak = PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(torch.device(device)))
        if peak:
            return peak, "device"
    return _ASSUMED_PEAK_FLOPS, "assumed"


# --------------------------------------------------------------------- #
# one bucket's row (the snapshot's and the fleet merge's)
# --------------------------------------------------------------------- #


def bucket_cost_row(flops_per_row: float, flops_method: str, routed_rows: float, padded_rows: float,
                    useful_s: float, padded_s: float, failed_s: float, peak_flops: float,
                    members: Optional[int] = None, kind: Optional[str] = None) -> Dict[str, Any]:
    """One bucket's cost from raw tallies; the inputs are rounded first
    and every field derived from the rounded values, so a fleet merge of
    one replica's body reproduces it."""
    flops_per_row = round(flops_per_row, 3)
    routed_rows = round(routed_rows, 3)
    padded_rows = round(padded_rows, 3)
    useful_s = round(useful_s, 6)
    padded_s = round(padded_s, 6)
    failed_s = round(failed_s, 6)
    device_s = useful_s + padded_s + failed_s
    dispatched_rows = routed_rows + padded_rows
    achieved = (flops_per_row * routed_rows / device_s) if device_s > 0 else 0.0
    achieved_disp = (flops_per_row * dispatched_rows / device_s) if device_s > 0 else 0.0
    row = {
        "flops_per_row": round(flops_per_row, 3),
        "flops_method": flops_method,
        "routed_rows": round(routed_rows, 3),
        "padded_rows": round(padded_rows, 3),
        "device_s": round(device_s, 6),
        "useful_s": round(useful_s, 6),
        "padded_s": round(padded_s, 6),
        "failed_s": round(failed_s, 6),
        "device_s_per_1k_rows": round(1000.0 * device_s / routed_rows, 6) if routed_rows > 0 else None,
        "achieved_flops_per_sec": round(achieved, 3),
        # mfu counts routed (real) rows, mfu_dispatched pad rows too
        "mfu": round(achieved / peak_flops, 9) if peak_flops > 0 else None,
        "mfu_dispatched": round(achieved_disp / peak_flops, 9) if peak_flops > 0 else None,
        "pad_waste_score": round(padded_s / device_s, 6) if device_s > 0 else 0.0,
    }
    if members is not None:
        row["members"] = int(members)
    if kind is not None:
        row["kind"] = kind
    return row


def _ranked(buckets: Dict[str, Dict[str, Any]], total_device_s: float) -> List[Dict[str, Any]]:
    """Buckets by wasted device time: pad-waste share x share of device time."""
    rows = []
    for label, row in buckets.items():
        share = (row["device_s"] / total_device_s) if total_device_s > 0 else 0.0
        rows.append({
            "bucket": label,
            "device_share": round(share, 6),
            "pad_waste_score": row["pad_waste_score"],
            "wasted_device_score": round(row["pad_waste_score"] * share, 6),
        })
    rows.sort(key=lambda r: (-r["wasted_device_score"], r["bucket"]))
    return rows


# --------------------------------------------------------------------- #
# CostModel
# --------------------------------------------------------------------- #


class CostModel:
    """Joins the current bank's FLOPs table (``bank.flops_stats()``) to the
    ledger's device seconds every ``GORDO_COST_SAMPLE_S``.
    ``bank_supplier`` returns the bank serving now, so a swap is followed.
    The join runs under the model's lock, which holds no scoring call."""

    def __init__(self, ledger, bank_supplier: Callable[[], Any], registry=None,
                 sample_interval_s: Optional[float] = None, peak_flops: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic, device=None):
        self.ledger = ledger
        self._bank_supplier = bank_supplier
        if sample_interval_s is None:
            sample_interval_s = env_num("GORDO_COST_SAMPLE_S", 10.0, float)
        self.sample_interval_s = max(0.001, float(sample_interval_s))
        if peak_flops is None:
            peak_flops, peak_source = resolve_peak_flops(device)
        else:
            peak_source = "explicit"
        self.peak_flops = float(peak_flops)
        self.peak_source = peak_source
        self._clock = clock
        self._lock = threading.Lock()
        self._cached: Optional[Dict[str, Any]] = None
        self._last_sample: Optional[float] = None
        self._n_samples = 0
        if registry is not None:
            registry.collector(self._collect, key="bank_cost")

    def sample(self, now: Optional[float] = None, force: bool = False) -> bool:
        if now is None:
            now = self._clock()
        with self._lock:
            if not force and self._last_sample is not None and now - self._last_sample < self.sample_interval_s:
                return False
            self._cached = self._build()
            self._last_sample = now
            self._n_samples += 1
            self._cached["n_samples"] = self._n_samples
            return True

    def _build(self) -> Dict[str, Any]:
        """One join of the ledger's tallies and the bank's table (lock held)."""
        led = self.ledger.snapshot() if self.ledger is not None else {}
        per_bucket = led.get("per_bucket") or {}
        bank = self._bank_supplier() if self._bank_supplier else None
        flops_stats = {}
        if bank is not None:
            try:
                flops_stats = bank.flops_stats()
            except Exception:
                flops_stats = {}
        buckets: Dict[str, Dict[str, Any]] = {}
        total_device_s = 0.0
        # every live bucket has a row, and a bucket a swap retired keeps its history
        for label in sorted(set(flops_stats) | set(per_bucket)):
            stats = flops_stats.get(label) or {}
            tallies = per_bucket.get(label) or {}
            row = bucket_cost_row(
                flops_per_row=float(stats.get("flops_per_row") or 0.0),
                flops_method=str(stats.get("flops_method") or "unknown"),
                routed_rows=float(tallies.get("routed_rows") or 0.0),
                padded_rows=float(tallies.get("padded_rows") or 0.0),
                useful_s=float(tallies.get("useful_s") or 0.0),
                padded_s=float(tallies.get("padded_s") or 0.0),
                failed_s=float(tallies.get("failed_s") or 0.0),
                peak_flops=self.peak_flops,
                members=stats.get("members"),
                kind=stats.get("kind"),
            )
            row["live"] = label in flops_stats
            buckets[label] = row
            total_device_s += row["device_s"]
        return {
            "peak_flops": self.peak_flops,
            "peak_source": self.peak_source,
            "sample_interval_s": self.sample_interval_s,
            "total_device_s": round(total_device_s, 6),
            "buckets": buckets,
            "ranking": _ranked(buckets, total_device_s),
        }

    def snapshot(self) -> Dict[str, Any]:
        """The cached join (``GET /costs``, ``/stats``, the collector)."""
        self.sample()
        with self._lock:
            if self._cached is None:
                self._cached = self._build()
                self._cached["n_samples"] = self._n_samples
            return self._cached

    def _collect(self):
        snap = self.snapshot()
        for label, row in snap["buckets"].items():
            lab = {"bucket": label}
            if row["mfu"] is not None:
                yield ("gordo_bucket_mfu", "gauge",
                       "Model FLOPs utilization per bucket: analytic routed-row FLOPs / measured device "
                       "seconds / peak (see peak_source for provenance)", lab, row["mfu"])
            yield ("gordo_bucket_flops_per_row", "gauge",
                   "Analytic forward FLOPs per routed row for this bucket's architecture", lab,
                   row["flops_per_row"])
            if row["device_s_per_1k_rows"] is not None:
                yield ("gordo_bucket_device_seconds_per_1k_rows", "gauge",
                       "Measured device seconds per 1000 routed rows", lab, row["device_s_per_1k_rows"])
            yield ("gordo_bucket_pad_waste_score", "gauge",
                   "Fraction of this bucket's device time spent on pad rows", lab, row["pad_waste_score"])


def cost_from_env(ledger, bank_supplier, registry=None, device=None, clock=None) -> Optional[CostModel]:
    """A cost model sampling on ``clock``'s monotonic time (the app's
    clock seam; None: the real one), or None when ``GORDO_COST=0``."""
    if os.environ.get("GORDO_COST", "1") == "0":
        return None
    mono = clock.monotonic if clock is not None else time.monotonic
    return CostModel(ledger, bank_supplier, registry=registry, clock=mono, device=device)


# --------------------------------------------------------------------- #
# fleet rollup
# --------------------------------------------------------------------- #


def merge_cost_snapshots(bodies: Sequence[Optional[Dict[str, Any]]]) -> Dict[str, Any]:
    """Per-replica ``GET /costs`` bodies as one fleet view: the raw tallies
    sum a bucket and the derived fields are recomputed through
    :func:`bucket_cost_row`. The peak is the first enabled body's;
    ``peak_sources`` lists every origin seen."""
    acc: Dict[str, Dict[str, float]] = {}
    meta: Dict[str, Dict[str, Any]] = {}
    peak_flops = None
    peak_sources: List[str] = []
    scraped = 0
    for body in bodies:
        if not body or not body.get("enabled", True):
            continue
        scraped += 1
        if peak_flops is None:
            peak_flops = float(body.get("peak_flops") or _ASSUMED_PEAK_FLOPS)
        src = body.get("peak_source")
        if src and src not in peak_sources:
            peak_sources.append(src)
        for label, row in (body.get("buckets") or {}).items():
            cell = acc.setdefault(label, {"routed_rows": 0.0, "padded_rows": 0.0, "useful_s": 0.0,
                                          "padded_s": 0.0, "failed_s": 0.0})
            for key in cell:
                cell[key] += float(row.get(key) or 0.0)
            info = meta.setdefault(label, {
                "flops_per_row": float(row.get("flops_per_row") or 0.0),
                "flops_method": row.get("flops_method") or "unknown",
                "members": row.get("members"),
                "kind": row.get("kind"),
                "live": False,
            })
            info["live"] = bool(info["live"] or row.get("live"))
    peak_flops = _ASSUMED_PEAK_FLOPS if peak_flops is None else peak_flops
    buckets: Dict[str, Dict[str, Any]] = {}
    total_device_s = 0.0
    for label in sorted(acc):
        cell, info = acc[label], meta[label]
        row = bucket_cost_row(
            flops_per_row=info["flops_per_row"], flops_method=info["flops_method"],
            routed_rows=cell["routed_rows"], padded_rows=cell["padded_rows"], useful_s=cell["useful_s"],
            padded_s=cell["padded_s"], failed_s=cell["failed_s"], peak_flops=peak_flops,
            members=info["members"], kind=info["kind"],
        )
        row["live"] = info["live"]
        buckets[label] = row
        total_device_s += row["device_s"]
    return {
        "replicas_scraped": scraped,
        "peak_flops": peak_flops,
        "peak_source": (peak_sources[0] if len(peak_sources) == 1 else "mixed") if peak_sources else "assumed",
        "peak_sources": peak_sources,
        "total_device_s": round(total_device_s, 6),
        "buckets": buckets,
        "ranking": _ranked(buckets, total_device_s),
    }
