"""Reconstruction-error anomaly detector (inference side).

Counterpart of ``DiffBasedAnomalyDetector`` in
``gordo_components_tpu/models/anomaly/diff.py``: an autoencoder behind an
input affine scaler, with a per-feature error scaler learned at fit time.
``anomaly(X)`` returns the reference's six column groups as arrays, with the
epilogue (diff, scaled diff, both row norms) in one :func:`fused_anomaly_score`
call — the CUDA kernel on the card.

The detector is built from fitted weights and scalers (see ``convert.py`` and
``serializer/artifacts.py``); ``fit`` comes with the training slice.
"""

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from gordo_components_torch.device import resolve_device
from gordo_components_torch.models.register import lookup_factory
from gordo_components_torch.ops.scaler import ScalerParams, scaler_transform
from gordo_components_torch.ops.score import fused_anomaly_score

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

    ``model`` maps input-scaled rows to their reconstruction;
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
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

        def vec(a):
            return torch.as_tensor(np.array(a, np.float32), device=self.device)

        self.input_scaler = ScalerParams(vec(in_shift), vec(in_scale))
        self.error_scaler = ScalerParams(vec(err_shift), vec(err_scale))
        n = self.input_scaler.shift.shape[0]
        self.tags = list(tags) if tags else [f"feature-{i}" for i in range(n)]
        self.thresholds = thresholds

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
        )

    @torch.no_grad()
    def anomaly(self, X, y=None) -> Dict[str, np.ndarray]:
        """The reference's anomaly columns as arrays keyed by group name:
        ``model-input`` and ``model-output`` (rows, F), the per-tag
        ``tag-anomaly-unscaled``/``-scaled`` (rows, F), and the
        ``total-anomaly-unscaled``/``-scaled`` row norms (rows,)."""
        Xv = _as_f32(X)
        x = torch.as_tensor(Xv, device=self.device)
        yv = x if y is None else torch.as_tensor(_as_f32(y), device=self.device)
        output = self.model(scaler_transform(self.input_scaler, x))
        target = scaler_transform(self.input_scaler, yv)
        scores = fused_anomaly_score(
            target.contiguous(), output.contiguous(),
            self.error_scaler.shift, self.error_scaler.scale,
        )
        arrays = [t.cpu().numpy() for t in (output, *scores)]
        return dict(zip(ANOMALY_KEYS, [Xv, *arrays]))
