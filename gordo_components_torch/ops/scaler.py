"""Affine feature scaling, ``transform(x) = (x - shift) * scale``.

Counterpart of ``gordo_components_tpu/ops/scaler.py`` for serving: the
struct and the transform. Min-max, standard and identity scalers are all
this one affine form, so a bank stacks them as two ``(M, F)`` tensors.
"""

from typing import NamedTuple

import torch


class ScalerParams(NamedTuple):
    shift: torch.Tensor  # (n_features,)
    scale: torch.Tensor  # (n_features,)


def scaler_transform(params: ScalerParams, X: torch.Tensor) -> torch.Tensor:
    return (X - params.shift) * params.scale
