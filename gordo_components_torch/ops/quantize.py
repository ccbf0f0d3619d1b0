"""Low-precision storage for the bank's stacked weights.

Counterpart of ``gordo_components_tpu/ops/quantize.py``. A bank bucket
stacks its members' weights with a leading member axis; below float32
(``GORDO_BANK_DTYPE``) the stacks hold:

- **bfloat16**: a plain cast, rounded to nearest even, half the bytes;
- **int8**: symmetric absmax codes per member and per tensor: codes
  ``clip(rint(w / s), -127, 127)`` with ``s = absmax / 127`` over that
  member's tensor (1.0 for an all-zero one; a rank-1 stacked leaf is its
  own absmax), and ``s`` kept beside them in float32.

A scale belongs to one tensor of the JAX parameter tree (a leaf). The
port concatenates an LSTM cell's four gate leaves into one tensor
(``convert.lstm_from_flax``), so such a tensor is quantized in
``segments`` equal parts along its last axis, one scale each: the codes
and scales are then those of the gate leaves, bit for bit.

Dequantization to float32 happens after the gather (:meth:`QuantizedTensor.take`):
only the gathered members' weights are ever expanded, never the stack.
"""

from typing import Any, Iterable, Sequence

import numpy as np
import torch

__all__ = [
    "BANK_DTYPES",
    "QuantizedTensor",
    "normalize_bank_dtype",
    "quantize_int8",
    "quantize_stack",
    "storage_dtype",
    "take",
    "tree_weight_bytes",
]

# accepted GORDO_BANK_DTYPE values (aliases normalized below)
BANK_DTYPES = ("float32", "bfloat16", "int8")
_ALIASES = {
    "fp32": "float32", "f32": "float32",
    "bf16": "bfloat16",
    "i8": "int8",
}


def normalize_bank_dtype(value: str) -> str:
    """The canonical bank dtype of an env or config string; raises
    ``ValueError`` for anything else (a mistyped fleet-wide knob fails at
    start, it does not serve float32)."""
    canon = _ALIASES.get(str(value).strip().lower(), str(value).strip().lower())
    if canon not in BANK_DTYPES:
        raise ValueError(
            f"bank dtype must be one of {'|'.join(BANK_DTYPES)}, got {value!r}"
        )
    return canon


class QuantizedTensor:
    """Int8 codes ``values`` (M, ...) and float32 ``scale`` of one stacked
    tensor. ``segments`` > 1 splits the last axis into that many equal
    leaves: ``scale`` is then (M, 1, ..., 1, segments, 1) against the codes
    viewed (M, ..., segments, L / segments); else (M, 1, ..., 1), or (M,)
    for a rank-1 stack."""

    __slots__ = ("values", "scale", "segments")

    def __init__(self, values: torch.Tensor, scale: torch.Tensor, segments: int = 1):
        self.values = values
        self.scale = scale
        self.segments = int(segments)

    @property
    def nbytes(self) -> int:
        return int(self.values.numel() * self.values.element_size() + self.scale.numel() * self.scale.element_size())

    def take(self, idx: torch.Tensor) -> torch.Tensor:
        """The float32 weights of the members ``idx`` (B,): codes and
        scales gathered, then ``codes * scale`` (the JAX package's
        ``values.astype(float32) * scale``)."""
        codes = self.values.index_select(0, idx).float()
        scale = self.scale.index_select(0, idx)
        if self.segments == 1:
            return codes * scale
        shape = codes.shape
        split = codes.reshape(*shape[:-1], self.segments, shape[-1] // self.segments)
        return (split * scale).reshape(shape)

    def __repr__(self) -> str:
        return (f"QuantizedTensor(values={tuple(self.values.shape)}, scale={tuple(self.scale.shape)}, "
                f"segments={self.segments})")


def quantize_int8(leaf: np.ndarray, segments: int = 1):
    """``(codes int8, scale float32)`` of a stacked leaf (M, ...), per
    member and per segment of its last axis (the JAX package's
    ``_quantize_leaf_int8`` on each gate leaf)."""
    leaf = np.asarray(leaf, np.float32)
    if segments > 1:
        shape = leaf.shape
        leaf = leaf.reshape(*shape[:-1], segments, shape[-1] // segments)
        axes = tuple(range(1, leaf.ndim - 2)) + (leaf.ndim - 1,)
    else:
        shape = None
        axes = tuple(range(1, leaf.ndim))
    # rank-1 stacked scalars: (M,) -> each member's tensor is a scalar,
    # its own absmax
    absmax = np.max(np.abs(leaf), axis=axes, keepdims=True) if axes else np.abs(leaf)
    # an all-zero member tensor quantizes to zeros under any scale; 1.0
    # keeps the divide finite without perturbing the codes
    scale = np.where(absmax > 0.0, absmax / 127.0, 1.0).astype(np.float32)
    codes = np.clip(np.rint(leaf / scale), -127, 127).astype(np.int8)
    if shape is not None:
        codes = codes.reshape(shape)
    return codes, scale


def quantize_stack(leaf: np.ndarray, bank_dtype: str, device, compute_dtype: torch.dtype = torch.float32,
                   segments: int = 1):
    """One stacked float32 leaf (M, ...) as the bank stores it: float32
    storage keeps the tensor in ``compute_dtype`` (a bfloat16 bucket casts
    at build), bfloat16 storage is the rounded cast, int8 a
    :class:`QuantizedTensor`."""
    leaf = np.ascontiguousarray(leaf, np.float32)
    if bank_dtype == "float32":
        return torch.from_numpy(leaf).to(device, compute_dtype)
    if bank_dtype == "bfloat16":
        return torch.from_numpy(leaf).to(device, torch.bfloat16)
    if bank_dtype == "int8":
        codes, scale = quantize_int8(leaf, segments)
        return QuantizedTensor(torch.from_numpy(codes).to(device), torch.from_numpy(scale).to(device), segments)
    raise ValueError(f"unknown bank dtype {bank_dtype!r}")


def take(stored: Any, idx: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """The members ``idx`` of a stored stack in ``compute_dtype``: a
    float32-storage stack is gathered as it is; a low-precision one is
    gathered, dequantized to float32 and then cast to the compute dtype
    (Flax's cast after the JAX package's ``dequantize_params``)."""
    if isinstance(stored, QuantizedTensor):
        out = stored.take(idx)
    else:
        out = stored.index_select(0, idx)
        if out.dtype == compute_dtype:
            return out
        out = out.float()
    return out if compute_dtype == torch.float32 else out.to(compute_dtype)


def _nbytes(stored: Any) -> int:
    if isinstance(stored, QuantizedTensor):
        return stored.nbytes
    return int(stored.numel() * stored.element_size())


def tree_weight_bytes(stacks: Iterable[Any]) -> int:
    """Bytes of stored stacks (codes and scales both count: the scales are
    what keeps int8 under a plain 4x)."""
    return int(sum(_nbytes(s) for s in stacks))


def storage_dtype(stacks: Sequence[Any]) -> str:
    """The storage dtype's name of a bucket's stacks."""
    first = stacks[0]
    if isinstance(first, QuantizedTensor):
        return "int8"
    return str(first.dtype).replace("torch.", "")
