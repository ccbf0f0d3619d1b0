"""The bfloat16 LSTM cell's gates as tables of 16-bit codes.

In the bfloat16 cell (``ops/seq_scan.py``) every gate input ``z`` is a
bfloat16 value, so ``s(z) = r(1 / r(1 + r(exp(-z))))`` and ``r(tanh(z))``
are functions of a 16-bit code, and K3's bfloat16 instance
(``csrc/lstm_step.cu``, ``TableCell``) reads them from tables that a setup
kernel fills on the card with the cell's own arithmetic. This module owns
the layout, which the kernels read from the buffer's header, and holds its
plain versions: :func:`build` fills a buffer from any gate function and
:func:`lookup` is the kernels' index function, so the CPU tests hold the
layout to the plain gates at every code.

A function tabulates the magnitudes ``m`` (the code without its sign bit)
in ``[lo, hi]``, both signs: below ``lo`` it is constant (the sigmoid's
0.5) or the identity (tanh), from ``hi`` constant (saturated, up to the
infinities), and larger magnitudes than +inf's are NaN. A code looks up
entry ``k + 2 * (clamp(m, lo, hi) + nan) + sign`` of its function, where
``nan`` is 1 for a NaN (whose slot, past ``hi``, holds the canonical NaN),
except that tanh gives the code itself below ``lo``. Two gates index at once
in the kernel, each half of a packed pair with its own bounds: no select
follows a load but tanh's identity.

Buffer (``TABLE_BYTES``, int16 words): a header of the two functions
(sigmoid, tanh), each eight int32 ``(lo, hi, k, 0, ...)``, then each
function's ``2 * (hi - lo + 2)`` entries.
"""

from typing import Callable

import torch

SIGMOID, TANH = 0, 1
HEADER_WORDS = 32  # 2 functions x 8 int32
NAN_CODE = 0x7FFF  # what cvt.rn.bf16.f32 gives for a NaN
MAX_FINITE_MAG = 0x7F80  # +inf's magnitude: larger magnitudes are NaN
# The magnitudes [first, end) where a gate is neither constant nor the
# identity, for either sign, as torch's bfloat16 ops give them on the CPU:
# the sigmoid 0.5 below 0.005889 (z >= 0; 0.01166 for z < 0), 1 from 5.5625
# and 0 from -89; r(tanh(z)) = z below 0.09033, +-1 from 3.46875.
VARYING = ((0x3BC1, 0x42B2), (0x3DB9, 0x405E))
# codes tabulated beyond each end: the card's expf and tanhf may move an end
# by a code (its self-test holds every code against the cell's formula)
MARGIN = 8
RANGES = tuple((first - 1 - MARGIN, end + MARGIN) for first, end in VARYING)


def _layout():
    words, offset = [], HEADER_WORDS
    for lo, hi in RANGES:
        words += [lo, hi, offset - 2 * lo, 0, 0, 0, 0, 0]
        offset += 2 * (hi - lo + 2)  # both signs of [lo, hi], then the NaN slot
    return tuple(words), offset


HEADER, _USED = _layout()  # (lo, hi, k, 0, 0, 0, 0, 0) for each function; the words in use
TABLE_WORDS = -(-_USED // 8) * 8  # whole 16-byte pieces: the kernels copy those
TABLE_BYTES = 2 * TABLE_WORDS


def codes_of(x: torch.Tensor) -> torch.Tensor:
    """int32 codes (0..65535) of a bfloat16 tensor."""
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


def values_of(codes: torch.Tensor) -> torch.Tensor:
    """The bfloat16 tensor of int codes (0..65535)."""
    return codes.to(torch.int32).to(torch.int16).view(torch.bfloat16)


def build(sigmoid: Callable, tanh: Callable) -> torch.Tensor:
    """A buffer of ``TABLE_WORDS`` int16 (header and entries) for gate
    functions on bfloat16 tensors; the card's buffer holds the same layout,
    its entries from the kernel's own arithmetic."""
    buf = torch.zeros(TABLE_WORDS, dtype=torch.int16)
    buf[:HEADER_WORDS] = torch.tensor(HEADER, dtype=torch.int32).view(torch.int16)
    for fn, ((lo, hi), gate) in enumerate(zip(RANGES, (sigmoid, tanh))):
        k = HEADER[8 * fn + 2]
        mags = torch.arange(lo, hi + 1, dtype=torch.int32)
        for sign in (0, 1):
            buf[k + 2 * mags + sign] = codes_of(gate(values_of(mags | (0x8000 * sign)))).to(torch.int16)
            buf[k + 2 * (hi + 1) + sign] = NAN_CODE
    return buf


def lookup(tables: torch.Tensor, fn: int, codes: torch.Tensor) -> torch.Tensor:
    """Gate ``fn`` (:data:`SIGMOID` or :data:`TANH`) of int codes through
    the tables, as ``GateTables`` computes it on the card."""
    u = codes.to(torch.int32) & 0xFFFF
    mag = u & 0x7FFF
    lo, hi, k = tables[:HEADER_WORDS].view(torch.int32)[8 * fn:8 * fn + 3].tolist()
    nan = (mag > MAX_FINITE_MAG).to(torch.int32)
    v = tables.to(torch.int32)[k + 2 * (mag.clamp(lo, hi) + nan) + (u >> 15)] & 0xFFFF
    return torch.where(mag < lo, u, v) if fn == TANH else v
