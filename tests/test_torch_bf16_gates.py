"""K3's bfloat16 design on the CPU: its gate tables, its packed arithmetic
and a plain model of its step.

The bfloat16 instance of the fused LSTM step (``csrc/lstm_step.cu``,
``TableCell``) reads the cell's gates from tables of 16-bit codes and does
the other rounding points in packed bfloat16 arithmetic. The card builds the
tables and holds them, and the arithmetic, to the cell's own float
arithmetic (self-tests in ``chip_smoke.py``); here:

- the layout (``ops/bf16_gates.py``: range ends, index function, clamp and
  NaN), with tables built from the plain bfloat16 sigmoid
  (``ops/activations.sigmoid``) and ``torch.tanh``, gives the plain gate's
  bits at all 65,536 codes, among them +-0, subnormals, +-inf and NaN (NaN
  in, NaN out; payloads are not part of the contract);
- the double-rounding identity the packed add and multiply rest on: a sum
  or product of two bfloat16 values computed in float32 and rounded to
  bfloat16 is the correctly rounded bfloat16 result, held against the exact
  result (integer arithmetic) and torch's bfloat16 add and multiply, on
  edge cases and a seeded sample of pairs;
- a plain model of the new step, table-driven, equals ``lstm_step_plain`` in
  bfloat16 bit for bit, and holds the band ``tests/test_torch_bf16.py``
  holds against Flax's ``OptimizedLSTMCell(dtype=bfloat16)``: rtol=1e-6,
  atol=3e-7 (float32 ``tanh`` of ``c'``), at H = 1, 5, 7, 8, 32 and 33.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from gordo_components_torch.ops import bf16_gates as gates
from gordo_components_torch.ops import seq_scan
from gordo_components_torch.ops.activations import sigmoid

BF16 = torch.bfloat16
CELL = dict(rtol=1e-6, atol=3e-7)
ALL = torch.arange(65536, dtype=torch.int32)
PLAIN = {gates.SIGMOID: sigmoid, gates.TANH: torch.tanh}


@pytest.fixture(scope="module")
def tables():
    return gates.build(sigmoid, torch.tanh)


def _is_nan(codes):
    return (codes & 0x7FFF) > gates.MAX_FINITE_MAG


def _same(got, want):
    """Bitwise, or NaN on both sides."""
    return (got == want) | (_is_nan(got) & _is_nan(want))


@pytest.mark.parametrize("fn", [gates.SIGMOID, gates.TANH], ids=["sigmoid", "tanh"])
def test_tables_give_the_plain_gate_at_every_code(tables, fn):
    want = gates.codes_of(PLAIN[fn](gates.values_of(ALL)))
    got = gates.lookup(tables, fn, ALL)
    bad = (~_same(got, want)).nonzero().flatten()
    assert bad.numel() == 0, [hex(int(c)) for c in bad[:10]]


EDGE_CODES = {
    "+0": 0x0000, "-0": 0x8000, "least subnormal": 0x0001, "-least subnormal": 0x8001,
    "greatest subnormal": 0x007F, "-greatest subnormal": 0x807F, "least normal": 0x0080,
    "+1": 0x3F80, "-1": 0xBF80, "greatest finite": 0x7F7F, "-greatest finite": 0xFF7F,
    "+inf": 0x7F80, "-inf": 0xFF80, "NaN": 0x7FC0, "-NaN": 0xFFC0, "NaN payload": 0x7F81,
}


@pytest.mark.parametrize("fn", [gates.SIGMOID, gates.TANH], ids=["sigmoid", "tanh"])
@pytest.mark.parametrize("name", list(EDGE_CODES))
def test_tables_at_the_edge_codes(tables, fn, name):
    code = torch.tensor([EDGE_CODES[name]], dtype=torch.int32)
    want = gates.codes_of(PLAIN[fn](gates.values_of(code)))
    got = gates.lookup(tables, fn, code)
    assert bool(_same(got, want)), (name, hex(int(got)), hex(int(want)))
    if _is_nan(code).item():
        assert int(got) == gates.NAN_CODE


@pytest.mark.parametrize("fn,sign", [(f, s) for f in (gates.SIGMOID, gates.TANH) for s in (0, 1)],
                         ids=["sigmoid+", "sigmoid-", "tanh+", "tanh-"])
def test_every_function_clamps_where_its_gate_is_flat(tables, fn, sign):
    """Each function's range [lo, hi] is the CPU's varying range widened by
    the margin; at and past each end the lookup is the gate's constant (the
    identity below tanh's), the codes just inside come from the table, and
    each sign's NaN slot sits past hi."""
    lo, hi = gates.RANGES[fn]
    first, end = gates.VARYING[fn]
    assert (lo, hi) == (first - 1 - gates.MARGIN, end + gates.MARGIN)
    head = gates.HEADER[8 * fn:8 * fn + 8]
    assert head[:2] == (lo, hi) and head[3:] == (0,) * 5
    assert int(tables[head[2] + 2 * (hi + 1) + sign]) == gates.NAN_CODE
    mags = torch.tensor([0, lo - 1, lo, lo + 1, first - 1, first, hi - 1, hi, hi + 1, gates.MAX_FINITE_MAG],
                        dtype=torch.int32)
    codes = mags | (0x8000 * sign)
    want = gates.codes_of(PLAIN[fn](gates.values_of(codes)))
    assert bool(_same(gates.lookup(tables, fn, codes), want).all())
    flat = torch.full_like(codes, 0x3F00) if fn == gates.SIGMOID else codes  # 0.5, or the identity
    if fn == gates.SIGMOID and sign:  # 0.5 reaches further for z < 0 (first + 1 is 0x3C3F there)
        assert torch.equal(want[:6], flat[:6])
    else:
        assert torch.equal(want[:5], flat[:5]) and int(want[5]) != int(flat[5])  # flat below `first`
    above = want[6:]
    assert (above == above[0]).all() and int(above[0]) == [[0x3F80, 0x0000], [0x3F80, 0xBF80]][fn][sign]


def test_layout_fits_whole_16_byte_pieces():
    assert gates.TABLE_BYTES % 16 == 0 and gates.TABLE_WORDS * 2 == gates.TABLE_BYTES
    offset = gates.HEADER_WORDS
    for fn, (lo, hi) in enumerate(gates.RANGES):
        assert gates.HEADER[8 * fn + 2] + 2 * lo == offset  # the function's first entry follows the last's
        offset += 2 * (hi - lo + 2)
    assert offset <= gates.TABLE_WORDS < offset + 8
    # the kernels stage the tables ahead of the ring: about 10 KB beside a
    # 4-warp block's 8 KB bfloat16 ring
    assert gates.TABLE_BYTES <= 10 * 1024


# --------------------------------------------------------------------- #
# the double-rounding identity
# --------------------------------------------------------------------- #


def _exact_bf16(num: int, exp2: int) -> int:
    """The bfloat16 code of num * 2**exp2 (num an integer), correctly
    rounded to nearest even, overflow to infinity."""
    if num == 0:
        return 0
    sign, num = (0x8000, -num) if num < 0 else (0, num)
    top = num.bit_length() - 1 + exp2  # floor(log2 |value|)
    q = max(top - 7, -133)  # the quantum: 8 significant bits, or the subnormal step
    shift = q - exp2
    if shift > 0:
        n, rem = divmod(num, 1 << shift)
        half = 1 << (shift - 1)
        if rem > half or (rem == half and n & 1):
            n += 1
    else:
        n = num << -shift
    if n == 0:
        return sign
    if n >= 256:  # rounded up to the next binade
        n, q = n >> 1, q + 1
    if q + 7 > 127:
        return sign | 0x7F80
    if n < 128:  # subnormal (q == -133)
        return sign | n
    return sign | ((q + 7 + 127) << 7) | (n - 128)


def _as_int(code: int):
    """(integer, exponent) of a finite bfloat16 code: value = int * 2**exp."""
    sign = -1 if code & 0x8000 else 1
    e, m = (code >> 7) & 0xFF, code & 0x7F
    if e == 0:
        return sign * m, -133
    return sign * (m | 0x80), e - 134


def _reference(op, a: int, b: int) -> int:
    if ((a >> 7) & 0xFF) == 0xFF or ((b >> 7) & 0xFF) == 0xFF:  # inf or NaN: IEEE in float64
        x = gates.values_of(torch.tensor([a])).double()
        y = gates.values_of(torch.tensor([b])).double()
        return int(gates.codes_of((x + y if op == "add" else x * y).to(BF16)))
    (na, ea), (nb, eb) = _as_int(a), _as_int(b)
    if op == "mul":
        code = _exact_bf16(na * nb, ea + eb)
        return code | ((a ^ b) & 0x8000)  # the product's sign, also of a zero
    e = min(ea, eb)
    code = _exact_bf16((na << (ea - e)) + (nb << (eb - e)), e)
    if (code & 0x7FFF) == 0:  # an exact zero sum is +0, unless both were -0
        return a & b & 0x8000
    return code


EDGE_VALUES = [0x0000, 0x8000, 0x0001, 0x8001, 0x007F, 0x0080, 0x00FF, 0x3F80, 0xBF80, 0x3F81, 0x3B80,
               0x4000, 0x7F7F, 0xFF7F, 0x7F00, 0x7F80, 0xFF80, 0x7FC0, 0x3C01, 0xBC01, 0x4380]


def _pairs(seed=23, n=4000):
    rng = np.random.RandomState(seed)
    edge = [(a, b) for a in EDGE_VALUES for b in EDGE_VALUES]
    sample = rng.randint(0, 65536, size=(n, 2))
    # and pairs of close magnitude, where sums cancel and ties occur
    near = rng.randint(0x3000, 0x5000, size=(n, 1)) + np.array([[0, 0]]) + rng.randint(-3, 4, size=(n, 2))
    near[:, 1] ^= 0x8000 * rng.randint(0, 2, size=n)
    return edge + [tuple(p) for p in sample] + [tuple(p) for p in near]


@pytest.mark.parametrize("op", ["add", "mul"])
def test_float32_then_round_is_the_correctly_rounded_bf16_result(op):
    pairs = _pairs()
    a = torch.tensor([p[0] for p in pairs], dtype=torch.int32)
    b = torch.tensor([p[1] for p in pairs], dtype=torch.int32)
    x, y = gates.values_of(a), gates.values_of(b)
    wide = (x.float() + y.float()) if op == "add" else (x.float() * y.float())
    via_f32 = gates.codes_of(wide.to(BF16))
    torch_bf16 = gates.codes_of(x + y if op == "add" else x * y)
    exact = torch.tensor([_reference(op, int(p), int(q)) for p, q in pairs], dtype=torch.int32)
    for name, got in (("float32 then round", via_f32), ("torch bf16", torch_bf16)):
        bad = (~_same(got, exact)).nonzero().flatten()
        assert bad.numel() == 0, (name, [(hex(pairs[i][0]), hex(pairs[i][1])) for i in bad[:5]])


def test_exact_rounding_reference_at_known_points():
    one, tiny = 0x3F80, 0x3B80  # 1.0 and 2**-8: 1 + 2**-8 is the tie between 1 and 1 + 2**-7
    assert _reference("add", one, tiny) == one  # ties to even
    assert _reference("add", 0x3F81, tiny) == 0x3F82  # odd: rounds up
    assert _reference("mul", 0x0001, 0x3F00) == 0  # half the least subnormal ties to 0
    assert _reference("mul", 0x0001, 0x3FC0) == 0x0002  # 1.5 of it rounds to even, 2
    assert _reference("add", 0x7F7F, 0x7F7F) == 0x7F80  # overflow to inf
    assert _reference("add", 0x3F80, 0xBF80) == 0x0000


# --------------------------------------------------------------------- #
# a plain model of the new step
# --------------------------------------------------------------------- #


def table_step(xz_t, h, c, Wh, b, tables):
    """The table-driven step as ``TableCell`` computes it: the
    pre-activations at the cell's rounding points, the gates looked up by
    code, r(i*g) a bfloat16 product, c' and h' in float32."""
    hW = torch.bmm(h.to(BF16).transpose(0, 1), Wh).transpose(0, 1)
    z = gates.codes_of(xz_t + (hW + b[None]))
    ci, cf, cg, co = z.chunk(4, dim=-1)
    i, f, o = (gates.values_of(gates.lookup(tables, gates.SIGMOID, k)) for k in (ci, cf, co))
    g = gates.values_of(gates.lookup(tables, gates.TANH, cg))
    c2 = f.float() * c + (i * g).float()
    return c2, o.float() * torch.tanh(c2)


def _flax_cell_params(Wi, Wh, b, m, H):
    p = {}
    for k, gate in enumerate("ifgo"):
        sl = slice(k * H, (k + 1) * H)
        p[f"i{gate}"] = {"kernel": jnp.asarray(Wi[m][:, sl])}
        p[f"h{gate}"] = {"kernel": jnp.asarray(Wh[m][:, sl]), "bias": jnp.asarray(b[m][sl])}
    return {"params": p}


def _bf(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)


@pytest.mark.parametrize("H,B,M", [(1, 3, 2), (5, 97, 1), (7, 97, 1), (8, 4, 3), (32, 3, 2), (33, 5, 3)])
def test_table_step_is_the_plain_step_and_the_flax_cell(tables, H, B, M):
    rng = np.random.RandomState(2300 + H)
    Wi = (rng.randn(M, 3, 4 * H) / np.sqrt(3)).astype("f4")
    Wh = (rng.randn(M, H, 4 * H) / np.sqrt(H)).astype("f4")
    b = (0.1 * rng.randn(M, 4 * H)).astype("f4")
    x = rng.randn(B, M, 3).astype("f4")
    h, c = (torch.from_numpy(rng.randn(B, M, H).astype("f4")) for _ in range(2))
    xz = torch.einsum("bmf,mfg->bmg", _bf(x), _bf(Wi))
    c2, h2 = table_step(xz, h, c, _bf(Wh), _bf(b), tables)
    want_c, want_h = seq_scan.lstm_step_plain(xz, h, c, _bf(Wh), _bf(b))
    assert torch.equal(c2.view(torch.int32), want_c.view(torch.int32))
    assert torch.equal(h2.view(torch.int32), want_h.view(torch.int32))
    cell = nn.OptimizedLSTMCell(features=H, dtype=jnp.bfloat16)
    for m in range(M):
        (jc, jh), _ = cell.apply(_flax_cell_params(Wi, Wh, b, m, H),
                                 (jnp.asarray(c[:, m].numpy()), jnp.asarray(h[:, m].numpy())),
                                 jnp.asarray(x[:, m]))
        np.testing.assert_allclose(c2[:, m].numpy(), np.asarray(jc), err_msg=f"c member {m}", **CELL)
        np.testing.assert_allclose(h2[:, m].numpy(), np.asarray(jh), err_msg=f"h member {m}", **CELL)


@pytest.mark.parametrize("H,S,B,M", [(8, 6, 97, 2), (5, 5, 3, 3), (33, 4, 5, 2)])
def test_chained_table_steps_are_the_plain_layer(tables, H, S, B, M):
    g = torch.Generator().manual_seed(H + S)
    xz = torch.randn(S, B, M, 4 * H, generator=g).to(BF16)
    Wh = (torch.randn(M, H, 4 * H, generator=g) / H ** 0.5).to(BF16)
    b = (0.1 * torch.randn(M, 4 * H, generator=g)).to(BF16)
    h = c = torch.zeros(B, M, H)
    ys = []
    for xz_t in xz:
        c, h = table_step(xz_t, h, c, Wh, b, tables)
        ys.append(h)
    want = seq_scan.lstm_layer_plain(xz, Wh, b)
    assert torch.equal(torch.stack(ys).view(torch.int32), want.view(torch.int32))
