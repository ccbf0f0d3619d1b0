"""Serving latency histograms.

Counterpart of ``gordo_components_tpu/server/stats.py``: the log-binned
:class:`~gordo_components_torch.observability.metrics.Histogram` at the
serving resolution, 50 us to 100 s at ``LATENCY_BINS_PER_DECADE`` (32) bins
a decade, everything slower in the overflow bin. It records under its own
lock: the port's server records from every connection's thread.
"""

from gordo_components_torch.observability.metrics import LATENCY_BINS_PER_DECADE, Histogram

__all__ = ["LatencyHistogram"]


class LatencyHistogram(Histogram):
    """Latency histogram over log-spaced bins with percentile reads, 50 us
    to 100 s at 32 bins a decade (a percentile within about 7.5%)."""

    __slots__ = ()

    def __init__(self, lo: float = 5e-5, hi: float = 100.0,
                 bins_per_decade: int = LATENCY_BINS_PER_DECADE, lock=None):
        super().__init__(lo=lo, hi=hi, bins_per_decade=bins_per_decade, lock=lock)
