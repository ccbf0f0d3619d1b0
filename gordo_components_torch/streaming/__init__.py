"""Streaming ingestion and online adaptation plane.

Counterpart of ``gordo_components_tpu/streaming/``:

- :mod:`ingest`: per-member bounded :class:`WindowBuffer` rings with
  event-time watermarks, late, out-of-order, duplicate and dropout
  accounting, fed by ``POST .../{target}/ingest``;
- :mod:`drift`: per-member drift over those buffers (the EWMA error ratio
  against the train-time threshold, the input's out-of-band share,
  flatlined tags, staleness), ``GET .../drift`` and ``gordo_drift_*``;
- :mod:`adapt`: recalibration and incremental refit, landing as a new
  bank generation through the zero-downtime swap, and the auto loop;
- :mod:`push`: the bounded broker behind score-on-ingest push
  (``GET .../{target}/results/stream``).

Default off: with ``GORDO_STREAM=0`` (the default) the server builds none
of it, and no ``gordo_stream_*``, ``gordo_drift_*`` or ``gordo_push_*``
series render.
"""

from gordo_components_torch.streaming.adapt import StreamingPlane
from gordo_components_torch.streaming.drift import DriftDetector
from gordo_components_torch.streaming.ingest import StreamIngestor, WindowBuffer

__all__ = ["StreamingPlane", "DriftDetector", "StreamIngestor", "WindowBuffer"]
