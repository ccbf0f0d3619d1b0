"""The port's low-precision bank against the JAX package's, on the CPU.

Random member weights are made with numpy from a seed, in the Flax layout,
for a dense autoencoder, an LSTM stack and a conv autoencoder (and a
variational one and a bfloat16-compute LSTM for the documented
divergences). The same trees become JAX bank entries and, through
``convert.entry_from_numpy``, port entries.

- ``ops/quantize``: the alias and error table, int8 codes and scales
  bitwise against JAX ``quantize_stacked`` leaf by leaf (an all-zero
  member, a rank-1 leaf, and the LSTM's concatenated gates, scaled one
  gate a segment), bfloat16 bitwise;
- the bank: JAX's and the port's at float32, bfloat16 and int8 storage on
  the same requests within the bank's band (atol 1e-5, the JAX bank
  through its plain ``jnp`` epilogue); the port's quantized results
  against its float32 ones within tests/test_bank_quantized.py's band
  (rtol 0.02, atol 0.05); the ``bank.quantize`` fault: float32 storage,
  results bitwise float32's, counted; ``capacity_stats`` against JAX's;
- ``flops_stats``: ``weight_bytes`` (the stacks alone, no scalers) and
  ``effective_dtype`` (the storage dtype) equal to JAX's, and the two
  documented divergences: a variational bucket stacks its serving chain
  alone, a bfloat16-compute bucket stores bfloat16 at float32 storage.
"""

import dataclasses

import numpy as np
import pytest
import torch

import gordo_components_tpu.server.bank as jax_bank_mod
from gordo_components_torch.convert import entry_from_numpy, params_to_flax
from gordo_components_torch.models import lookup_factory
from gordo_components_torch.observability.metrics import MetricsRegistry
from gordo_components_torch.ops import quantize as port_q
from gordo_components_torch.resilience import faults as port_faults
from gordo_components_torch.server import ModelBank
from gordo_components_tpu.ops import quantize as jax_q
from gordo_components_tpu.server.bank import ModelBank as JaxBank
from gordo_components_tpu.server.bank import _BankEntry as JaxEntry

ATOL = 1e-5  # the bank's band (tests/test_torch_bank.py)
Q_RTOL, Q_ATOL = 0.02, 0.05  # tests/test_bank_quantized.py's band against float32 storage
F = 4
LOOKBACK = 8
# family -> (registry type, kind, factory kwargs, lookback)
FAMILIES = {
    "dense": ("AutoEncoder", "feedforward_hourglass", {}, 1),
    "lstm": ("LSTMAutoEncoder", "lstm_hourglass", {}, LOOKBACK),
    "conv": ("ConvAutoEncoder", "conv1d_autoencoder", {}, LOOKBACK),  # config 4's channels
}
MEMBERS = 3


def _state(registry_type, kind, kwargs, rng, zero=False):
    """Random weights scaled by their fan-in (the inputs of one output),
    small biases: outputs of order one, as a trained member's."""
    module = lookup_factory(registry_type, kind)(F, **kwargs)
    out = {}
    for k, v in module.state_dict().items():
        shape = tuple(v.shape)
        if len(shape) == 1:
            scale = 0.1
        elif registry_type == "AutoEncoder" and kind == "feedforward_hourglass":
            scale = 1.0 / np.sqrt(shape[1])  # nn.Linear weight (out, in)
        else:
            scale = 1.0 / np.sqrt(np.prod(shape[:-1]))  # (in, out), (K, F_in, C), (in, 4H)
        out[k] = np.zeros(shape, np.float32) if zero else (scale * rng.standard_normal(shape)).astype(np.float32)
    return out


def _pair(family, i, rng, compute_dtype="float32", zero=False):
    """(JAX entry, port entry) of one member with random weights."""
    registry_type, kind, kwargs, lookback = FAMILIES[family] if isinstance(family, str) else family
    flax = params_to_flax(_state(registry_type, kind, kwargs, rng, zero))
    name = f"{kind}-{i}"
    vecs = [0.1 * rng.standard_normal(F), 1.0 + rng.random(F), 0.05 * rng.random(F), 1.0 + rng.random(F)]
    vecs = [np.asarray(v, np.float32) for v in vecs]
    jax = JaxEntry(name=name, registry_type=registry_type, kind=kind, factory_kwargs=dict(kwargs),
                   compute_dtype=compute_dtype, n_features=F, lookback=lookback, target_offset=0,
                   params=flax, in_shift=vecs[0], in_scale=vecs[1], err_shift=vecs[2], err_scale=vecs[3])
    port = entry_from_numpy(name, registry_type, kind, kwargs, F, flax, *vecs, lookback=lookback,
                            compute_dtype=compute_dtype)
    return jax, port


@pytest.fixture(scope="module")
def members():
    rng = np.random.default_rng(0)
    out = {family: [_pair(family, i, rng) for i in range(MEMBERS)] for family in FAMILIES}
    # an all-zero member: scale 1.0, codes 0
    out["dense"].append(_pair("dense", MEMBERS, rng, zero=True))
    return out


@pytest.fixture
def jax_from_entries(monkeypatch):
    """A JAX bank built from JAX bank entries: its ``_extract_entry`` hands
    an entry back as it is."""
    monkeypatch.setattr(jax_bank_mod, "_extract_entry", lambda name, model: (model, None))

    def build(entries, bank_dtype):
        return JaxBank.from_models({e.name: e for e in entries}, registry=False, bank_kernel="jnp",
                                   bank_dtype=bank_dtype)

    return build


def _requests(entries, rng):
    return [(e.name, rng.random((20, F)).astype(np.float32), None) for e in entries]


# ---------------------------------------------------------------------- #
# ops/quantize
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("value", ["float32", "fp32", " F32 ", "bf16", "BFloat16", "i8", "int8", "float16",
                                   "int4", "", "q8"])
def test_normalize_bank_dtype_matches_jax(value):
    try:
        want = jax_q.normalize_bank_dtype(value)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            port_q.normalize_bank_dtype(value)
        assert str(got.value) == str(exc)
    else:
        assert port_q.normalize_bank_dtype(value) == want
    assert port_q.BANK_DTYPES == jax_q.BANK_DTYPES


@pytest.mark.parametrize("shape", [(5,), (5, 7), (5, 3, 4), (5, 2, 3, 4)])
def test_int8_codes_and_scales_bitwise_per_leaf(shape):
    rng = np.random.default_rng(sum(shape))
    leaf = (rng.standard_normal(shape) * rng.uniform(0.01, 10.0, (shape[0],) + (1,) * (len(shape) - 1))
            ).astype(np.float32)
    leaf[1] = 0.0  # an all-zero member
    codes, scale = port_q.quantize_int8(leaf)
    want = jax_q._quantize_leaf_int8(leaf)
    assert codes.dtype == np.int8 and scale.dtype == np.float32
    assert codes.tobytes() == np.asarray(want.values).tobytes() and codes.shape == want.values.shape
    assert scale.tobytes() == np.asarray(want.scale).tobytes() and scale.shape == want.scale.shape
    assert np.all(codes[1] == 0) and np.all(scale[1] == 1.0)


def test_bf16_storage_is_the_rounded_cast_bitwise():
    rng = np.random.default_rng(3)
    leaf = (rng.standard_normal((4, 33, 17)) * 1e3).astype(np.float32)
    got = port_q.quantize_stack(leaf, "bfloat16", "cpu")
    want = np.asarray(jax_q.quantize_stacked({"w": leaf}, "bfloat16")["w"])
    assert got.dtype == torch.bfloat16
    assert got.view(torch.int16).numpy().tobytes() == want.view(np.int16).tobytes()
    # dequantized after the gather: float32, exact widening
    idx = torch.tensor([2, 0])
    assert torch.equal(port_q.take(got, idx, torch.float32), got.index_select(0, idx).float())


def _stacked_flax(entries):
    trees = [e.params for e in entries]

    def stack(*leaves):
        return np.stack(leaves)

    import jax

    return jax.tree.map(stack, *trees)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bank_int8_weights_bitwise_jax_leaves(members, family):
    """The int8 bucket's codes and scales are JAX ``quantize_stacked``'s on
    the stacked Flax tree: one to one for dense and conv leaves, and for the
    LSTM the four gate leaves of ``Wi``, ``Wh`` and ``b`` side by side, one
    scale a gate."""
    pairs = members[family]
    jq = jax_q.quantize_stacked(_stacked_flax([j for j, _ in pairs]), "int8")["params"]
    bank = ModelBank.from_entries([p for _, p in pairs], device="cpu", registry=False, bank_dtype="int8")
    (bucket,) = bank._buckets.values()
    assert bucket.effective_dtype == "int8" and bucket.label.endswith(":qint8")
    got = {k: (w.values.numpy(), w.scale.numpy()) for k, w in bucket.weights.items()}

    def leaf(q):
        return np.asarray(q.values), np.asarray(q.scale)

    want = {}
    if family == "dense":
        for i in range(len(jq)):
            want[f"{i}.kernel"] = leaf(jq[f"Dense_{i}"]["kernel"])
            want[f"{i}.bias"] = leaf(jq[f"Dense_{i}"]["bias"])
    elif family == "conv":
        for name, layer in jq.items():
            for p in ("kernel", "bias"):
                want[f"{name}.{p}"] = leaf(layer[p])
    else:
        n = sum(1 for k in jq if k.startswith("OptimizedLSTMCell_"))
        for i in range(n):
            cell = jq[f"OptimizedLSTMCell_{i}"]
            for key, parts in (("Wi", [cell[f"i{g}"]["kernel"] for g in "ifgo"]),
                               ("Wh", [cell[f"h{g}"]["kernel"] for g in "ifgo"]),
                               ("b", [cell[f"h{g}"]["bias"] for g in "ifgo"])):
                values = np.concatenate([leaf(q)[0] for q in parts], -1)
                scale = np.stack([leaf(q)[1] for q in parts], -2)  # a gate axis before the last
                want[f"layers.{i}.{key}"] = (values, scale)
        want["head.kernel"] = leaf(jq["Dense_0"]["kernel"])
        want["head.bias"] = leaf(jq["Dense_0"]["bias"])
    assert sorted(got) == sorted(want)
    for k, (values, scale) in want.items():
        assert got[k][0].tobytes() == values.tobytes() and got[k][0].shape == values.shape, k
        assert got[k][1].tobytes() == scale.tobytes() and got[k][1].size == scale.size, k
    if family == "dense":  # the all-zero member
        assert all(np.all(v[MEMBERS] == 0) and np.all(s[MEMBERS] == 1.0) for v, s in got.values())


# ---------------------------------------------------------------------- #
# the bank
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("bank_dtype", ["float32", "bfloat16", "int8"])
def test_quantized_bank_matches_jax(members, jax_from_entries, bank_dtype):
    jax_entries = [j for pairs in members.values() for j, _ in pairs]
    port_entries = [p for pairs in members.values() for _, p in pairs]
    requests = _requests(port_entries, np.random.default_rng(7))
    want = jax_from_entries(jax_entries, bank_dtype).score_many(requests)
    got = ModelBank.from_entries(port_entries, device="cpu", registry=False, bank_dtype=bank_dtype).score_many(
        requests)
    for (name, _, _), g, w in zip(requests, got, want):
        for k, a in g.to_arrays().items():
            np.testing.assert_allclose(a, np.asarray(w.to_arrays()[k]), atol=ATOL, rtol=0, err_msg=f"{name} {k}")


@pytest.mark.parametrize("bank_dtype", ["bfloat16", "int8"])
def test_quantized_bank_within_band_of_float32(members, bank_dtype):
    entries = [p for pairs in members.values() for _, p in pairs]
    requests = _requests(entries, np.random.default_rng(8))
    fp32 = ModelBank.from_entries(entries, device="cpu", registry=False).score_many(requests)
    low = ModelBank.from_entries(entries, device="cpu", registry=False, bank_dtype=bank_dtype).score_many(requests)
    moved = 0.0
    for (name, _, _), g, w in zip(requests, low, fp32):
        for k, a in g.to_arrays().items():
            np.testing.assert_allclose(a, w.to_arrays()[k], rtol=Q_RTOL, atol=Q_ATOL, err_msg=f"{name} {k}")
            moved = max(moved, float(np.abs(a - w.to_arrays()[k]).max()))
    assert moved > 0  # the storage is not float32 in disguise


def test_float32_storage_is_the_identity(members):
    """float32 storage keeps the stacks as the bank always stacked them."""
    entries = [p for _, p in members["lstm"]]
    bank = ModelBank.from_entries(entries, device="cpu", registry=False, bank_dtype="float32")
    (bucket,) = bank._buckets.values()
    assert all(isinstance(w, torch.Tensor) and w.dtype == torch.float32 for w in bucket.weights.values())
    stacked = np.stack([e.params["layers.0.Wi"] for e in entries])
    assert bucket.weights["layers.0.Wi"].numpy().tobytes() == stacked.tobytes()
    idx = torch.tensor([1, 1, 0])
    assert bucket._take("layers.0.Wi", idx).data_ptr() != bucket.weights["layers.0.Wi"].data_ptr()
    assert torch.equal(bucket._take("layers.0.Wi", idx), bucket.weights["layers.0.Wi"].index_select(0, idx))


def test_quantize_fault_serves_float32_bitwise_and_counts(members):
    entries = [p for pairs in members.values() for _, p in pairs]
    requests = _requests(entries, np.random.default_rng(9))
    fp32 = ModelBank.from_entries(entries, device="cpu", registry=False).score_many(requests)
    registry = MetricsRegistry()
    port_faults.reset()
    port_faults.arm("bank.quantize", port_faults.FaultSpec(times=1))
    try:
        bank = ModelBank.from_models({}, device="cpu", registry=registry, bank_dtype="int8")
        for key, group in bank._group(entries).items():
            bank._add_bucket(key, group)
    finally:
        port_faults.reset()
    assert len(bank.quantize_fallbacks) == 1
    (label, error), = bank.quantize_fallbacks.items()
    fell = next(b for b in bank._buckets.values() if b.label == label)
    assert fell.effective_dtype == "float32" and fell.weight_bytes == fell.weight_bytes_fp32
    assert error.startswith("InjectedFault") or "fault" in error.lower()
    assert sorted(b.effective_dtype for b in bank._buckets.values()) == ["float32", "int8", "int8"]
    got = bank.score_many(requests)
    members_of = {e.name: e.bucket_label("int8") for e in entries}
    for (name, _, _), g, w in zip(requests, got, fp32):
        if members_of[name] == label:
            for k, a in g.to_arrays().items():
                assert a.tobytes() == w.to_arrays()[k].tobytes(), (name, k)
    text = registry.render()
    assert f'gordo_bank_quantize_fallback_total{{bucket="{label}"}} 1' in text
    cap = bank.capacity_stats()
    assert cap["quantize_fallbacks"] == {label: error}
    assert set(cap["weight_bytes_by_dtype"]) == {"float32", "int8"}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_flops_stats_weight_bytes_and_dtype_match_jax(members, jax_from_entries, family):
    """The repair of ``flops_stats`` at float32 compute and storage:
    ``weight_bytes`` counts the weight stacks alone (not the four scaler
    stacks) and ``effective_dtype`` is the storage dtype, as JAX's."""
    pairs = members[family]
    (want,) = jax_from_entries([j for j, _ in pairs], "float32").flops_stats().values()
    (got,) = ModelBank.from_entries([p for _, p in pairs], device="cpu", registry=False).flops_stats().values()
    assert (got["weight_bytes"], got["effective_dtype"]) == (want["weight_bytes"], want["effective_dtype"])
    assert got["weight_bytes"] == sum(np.asarray(a).nbytes for e in [p for _, p in pairs] for a in e.params.values())


@pytest.mark.parametrize("bank_dtype", ["float32", "bfloat16", "int8"])
def test_capacity_and_flops_bytes_match_jax(members, jax_from_entries, bank_dtype):
    """``flops_stats``' ``weight_bytes`` is the stored stacks' bytes
    without the scalers, ``effective_dtype`` their storage dtype, as JAX
    reports them; ``capacity_stats`` has JAX's keys and numbers (its
    ``kernel`` names the port's route)."""
    jax_entries = [j for pairs in members.values() for j, _ in pairs]
    port_entries = [p for pairs in members.values() for _, p in pairs]
    jax = jax_from_entries(jax_entries, bank_dtype)
    port = ModelBank.from_entries(port_entries, device="cpu", registry=False, bank_dtype=bank_dtype)
    want = {(b["registry_type"], b["members"]): b for b in jax.flops_stats().values()}
    got = {(b["registry_type"], b["members"]): b for b in port.flops_stats().values()}
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert (got[key]["weight_bytes"], got[key]["effective_dtype"]) == (w["weight_bytes"], w["effective_dtype"])
    jc, pc = jax.capacity_stats(), port.capacity_stats()
    assert sorted(pc) == sorted(jc) and pc["kernel"] == "plain"
    assert {k: v for k, v in pc.items() if k != "kernel"} == {k: v for k, v in jc.items() if k != "kernel"}


@pytest.mark.parametrize("case", ["variational", "bf16_compute"])
def test_documented_byte_divergences(jax_from_entries, case):
    """Two buckets whose ``flops_stats``/``capacity_stats`` bytes differ from
    JAX's by design: a variational bucket stacks only its serving chain (the
    mean decode: no ``logvar``), where JAX stacks every leaf; a
    bfloat16-compute bucket at float32 storage keeps its stacks in bfloat16
    (cast once at build), where JAX stores float32 and casts each forward.
    Below float32 storage both store the same leaves' codes as JAX would
    of that chain."""
    rng = np.random.default_rng(11)
    if case == "variational":
        pairs = [_pair(("AutoEncoder", "feedforward_variational", {}, 1), i, rng) for i in range(2)]
    else:
        pairs = [_pair("lstm", i, rng, compute_dtype="bfloat16") for i in range(2)]
    jax = jax_from_entries([j for j, _ in pairs], "float32")
    port = ModelBank.from_entries([p for _, p in pairs], device="cpu", registry=False)
    (w,), (g,) = jax.flops_stats().values(), port.flops_stats().values()
    (bucket,) = port._buckets.values()
    if case == "variational":
        logvar = sum(np.asarray(v).nbytes for v in pairs[0][0].params["params"]["logvar"].values()) * len(pairs)
        assert g["weight_bytes"] == w["weight_bytes"] - logvar
        assert g["effective_dtype"] == w["effective_dtype"] == "float32"
    else:
        assert g["weight_bytes"] * 2 == w["weight_bytes"]
        assert (g["effective_dtype"], w["effective_dtype"]) == ("bfloat16", "float32")
        assert port.capacity_stats()["capacity_ratio"] == 2.0 and jax.capacity_stats()["capacity_ratio"] == 1.0
    assert bucket.weight_bytes_fp32 == g["weight_bytes"] * (2 if case == "bf16_compute" else 1)


def test_bank_dtype_from_env_and_bad_values(monkeypatch, members):
    entries = [p for _, p in members["dense"]]
    monkeypatch.setenv("GORDO_BANK_DTYPE", "bf16")
    bank = ModelBank.from_entries(entries, device="cpu", registry=False)
    assert bank.bank_dtype == "bfloat16"
    assert [b.label for b in bank._buckets.values()] == [entries[0].bucket_label() + ":qbf16"]
    monkeypatch.setenv("GORDO_BANK_DTYPE", "fp8")
    with pytest.raises(ValueError, match="bank dtype must be one of float32|bfloat16|int8"):
        ModelBank(device="cpu", registry=False)
    # the storage rides in a copy of the entries' bucket: the same members, other bytes
    assert dataclasses.replace(entries[0]).bucket_key() == entries[0].bucket_key()
