"""Reconstruction-error anomaly detector (inference side).

Counterpart of ``DiffBasedAnomalyDetector`` in
``gordo_components_tpu/models/anomaly/diff.py``: an autoencoder behind an
input affine scaler, with a per-feature error scaler learned at fit time.
``anomaly(X)`` returns the reference's six column groups as arrays, with the
epilogue (diff, scaled diff, both row norms) in one
:func:`fused_anomaly_score_packed` call — the CUDA kernel on the card — whose
one buffer comes back to the host in one transfer.

Sequence models score windows of ``lookback`` rows: output row i belongs to
input row ``i + offset``, with ``offset = lookback - 1 + target_offset``
(``target_offset`` 1 for a t+1 forecast), so the outputs, the target and
``model-input`` are the rows from ``offset`` on, as in the reference.

The detector is built from fitted weights and scalers (see ``convert.py`` and
``serializer/artifacts.py``); ``fit`` comes with the training slice.
"""

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from gordo_components_torch.device import resolve_device
from gordo_components_torch.models.factories.lstm import LSTMStack
from gordo_components_torch.models.register import lookup_factory
from gordo_components_torch.ops.scaler import ScalerParams, scaler_transform
from gordo_components_torch.ops.score import fused_anomaly_score_packed, unpack_scores
from gordo_components_torch.ops.windows import sliding_windows

ANOMALY_KEYS = (
    "model-input",
    "model-output",
    "tag-anomaly-unscaled",
    "tag-anomaly-scaled",
    "total-anomaly-unscaled",
    "total-anomaly-scaled",
)


def _as_f32(X) -> np.ndarray:
    X = np.asarray(X, dtype=np.float32)
    return X[:, None] if X.ndim == 1 else X


class DiffBasedAnomalyDetector:
    """Anomaly = norm of (per-feature scaled) |y - reconstruction|.

    ``model`` maps input-scaled rows (or, for an :class:`LSTMStack`,
    windows of ``lookback`` rows) to their reconstruction;
    ``in_shift``/``in_scale`` compose every affine preprocessing step in
    front of it; ``err_shift``/``err_scale`` are the fitted error scaler.
    """

    def __init__(
        self,
        model: nn.Module,
        in_shift,
        in_scale,
        err_shift,
        err_scale,
        tags: Optional[Sequence[str]] = None,
        thresholds: Optional[Dict] = None,
        device="cuda",
        lookback: int = 1,
        target_offset: int = 0,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.lookback = int(lookback)
        self.target_offset = int(target_offset)

        def vec(a):
            return torch.as_tensor(np.array(a, np.float32), device=self.device)

        self.input_scaler = ScalerParams(vec(in_shift), vec(in_scale))
        self.error_scaler = ScalerParams(vec(err_shift), vec(err_scale))
        n = self.input_scaler.shift.shape[0]
        self.tags = list(tags) if tags else [f"feature-{i}" for i in range(n)]
        self.thresholds = thresholds

    @property
    def offset(self) -> int:
        """Rows consumed by the sequence warm-up: output row i belongs to
        input row ``i + offset`` (0 for feedforward)."""
        return self.lookback - 1 + self.target_offset

    @classmethod
    def from_entry(cls, entry, device="cuda") -> "DiffBasedAnomalyDetector":
        """Build from a bank entry (``server/bank._BankEntry``): the factory
        named by its registry type and kind, loaded with its weights."""
        model = lookup_factory(entry.registry_type, entry.kind)(
            entry.n_features, **entry.factory_kwargs
        )
        model.load_state_dict({k: torch.as_tensor(v) for k, v in entry.params.items()})
        return cls(
            model, entry.in_shift, entry.in_scale, entry.err_shift, entry.err_scale,
            tags=entry.tags, thresholds=entry.thresholds, device=device,
            lookback=entry.lookback, target_offset=entry.target_offset,
        )

    @torch.no_grad()
    def anomaly(self, X, y=None) -> Dict[str, np.ndarray]:
        """The reference's anomaly columns as arrays keyed by group name:
        ``model-input`` and ``model-output`` (rows, F), the per-tag
        ``tag-anomaly-unscaled``/``-scaled`` (rows, F), and the
        ``total-anomaly-unscaled``/``-scaled`` row norms (rows,), for the
        ``len(X) - offset`` output rows."""
        Xv = _as_f32(X)
        off = self.offset
        if len(Xv) <= off:
            raise ValueError(f"need more than {off} rows (sequence warm-up), got {len(Xv)}")
        x = torch.as_tensor(Xv, device=self.device)
        yv = x if y is None else torch.as_tensor(_as_f32(y), device=self.device)
        xs = scaler_transform(self.input_scaler, x)
        if isinstance(self.model, LSTMStack):
            W = sliding_windows(xs, self.lookback)
            output = self.model(W[: len(W) - self.target_offset])
        else:
            output = self.model(xs)
        n_out = output.shape[0]
        target = scaler_transform(self.input_scaler, yv)[off:][:n_out]
        scores = fused_anomaly_score_packed(
            target.contiguous(), output.contiguous(),
            self.error_scaler.shift, self.error_scaler.scale,
        )
        # one device-to-host transfer per buffer, then one wait for both
        output, scores = (t.to("cpu", non_blocking=True) for t in (output, scores))
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        arrays = [t.numpy() for t in (output, *unpack_scores(scores, n_out, output.shape[1]))]
        return dict(zip(ANOMALY_KEYS, [Xv[off:][:n_out], *arrays]))
