"""K3's bfloat16 design on the card (marked ``card``; skipped without one).

    python -m pytest -m card tests/test_torch_bf16_gates_card.py

Needs an NVIDIA card and the CUDA toolkit: the kernels are built from
``gordo_components_torch/ops/csrc/lstm_step.cu`` at first use. Without a
card every test here skips with its reason; ``chip_smoke.py`` runs the same
self-tests on every run on the card.
"""

import pytest
import torch

from gordo_components_torch.ops import bf16_gates as gates
from gordo_components_torch.ops import seq_scan
from gordo_components_torch.ops.activations import sigmoid

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and the CUDA toolkit: the bf16 kernels build and run only there")
    return torch.device("cuda")


def test_card_tables_keep_the_layout_and_agree_with_the_plain_gates(card):
    """The card's buffer carries the layout's header, and its lookup
    differs from the CPU's plain gates only where the card's expf or tanhf
    round a code the other way (never at a range end: the margin)."""
    tables = seq_scan.gate_tables(card).cpu()
    assert tables.numel() == gates.TABLE_WORDS
    assert tuple(tables[:gates.HEADER_WORDS].view(torch.int32).tolist()) == gates.HEADER
    plain = gates.build(sigmoid, torch.tanh)
    codes = torch.arange(65536, dtype=torch.int32)
    for fn in (gates.SIGMOID, gates.TANH):
        differ = (gates.lookup(tables, fn, codes) != gates.lookup(plain, fn, codes)).float().mean()
        assert differ < 0.01


def test_self_tests_find_no_mismatch(card):
    """Every code through the table path against the cell's formula, and
    the packed add, multiply and conversion over all their inputs."""
    import ctypes

    from gordo_components_torch.ops import _cuda

    lib, p = _cuda.load("lstm_step"), ctypes.c_void_p
    stream = torch.cuda.current_stream().cuda_stream
    gate = torch.zeros(2, dtype=torch.int32, device=card)
    arith = torch.zeros(3, dtype=torch.int32, device=card)
    for entry, args in (("gordo_lstm_bf16_gate_check", (seq_scan.gate_tables(card).data_ptr(), gate.data_ptr())),
                        ("gordo_lstm_bf16_arith_check", (arith.data_ptr(),))):
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = [p] * (len(args) + 1), ctypes.c_int
        assert fn(*args, stream) == 0
    assert gate.tolist() == [0, 0] and arith.tolist() == [0, 0, 0]
