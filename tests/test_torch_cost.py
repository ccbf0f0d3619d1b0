"""The port's per-bucket cost model against the JAX package's, on the CPU.

``estimate_flops_per_row`` of each bank family's factory module equals
the JAX estimate of the JAX module of the same kind and arguments (dense,
LSTM, conv); for the variational family the JAX estimate falls to the
LSTM closed form (its module has ``dims`` and no ``encoding_dim``), and
the port counts the mean decode its bank runs. Every family's analytic
count lies within the JAX suite's 0.4x-2x band of what
``torch.utils.flop_counter.FlopCounterMode`` counts over the port bucket's
forward (tests/test_heat_cost.py holds the JAX count to XLA's the same
way). ``bucket_cost_row`` and ``merge_cost_snapshots`` give the JAX
package's rows; the cost model joins a bank and its ledger, with the
peak's origin.
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gordo_components_torch.convert import entry_from_numpy, params_to_flax
from gordo_components_torch.models import lookup_factory as port_factory
from gordo_components_torch.observability import cost as port_cost
from gordo_components_torch.observability.goodput import GoodputLedger
from gordo_components_torch.observability.metrics import MetricsRegistry, parse_prometheus_text
from gordo_components_torch.server import ModelBank
from gordo_components_tpu.models.register import lookup_factory as jax_factory
from gordo_components_tpu.observability import cost as jax_cost

F = 5
# (registry type, kind, factory kwargs, lookback)
FAMILIES = {
    "dense": ("AutoEncoder", "feedforward_model", {"encoding_dim": (16, 8), "decoding_dim": (8, 16)}, 1),
    "hourglass": ("AutoEncoder", "feedforward_hourglass", {}, 1),
    "lstm": ("LSTMAutoEncoder", "lstm_model", {"dims": (6, 4)}, 8),
    "lstm_hourglass": ("LSTMAutoEncoder", "lstm_hourglass", {}, 12),
    "forecast": ("LSTMForecast", "lstm_symmetric", {"dims": (6,)}, 6),
    "conv": ("ConvAutoEncoder", "conv1d_autoencoder", {"channels": (8, 4), "kernel_size": 3}, 16),
    "conv_odd": ("ConvAutoEncoder", "conv1d_autoencoder", {"channels": (6,), "kernel_size": 2}, 10),
    "vae": ("AutoEncoder", "feedforward_variational", {"dims": (12, 6), "latent_dim": 3}, 1),
}


@pytest.mark.parametrize("family", [f for f in FAMILIES if f != "vae"])
def test_flops_per_row_equal_jax(family):
    rt, kind, kw, lookback = FAMILIES[family]
    got = port_cost.estimate_flops_per_row(port_factory(rt, kind)(F, **kw), F, lookback, 123)
    want = jax_cost.estimate_flops_per_row(jax_factory(rt, kind)(F, **kw), F, lookback, 123)
    assert got == want and got[1] == "analytic" and got[0] > 0


def test_the_variational_count_is_the_mean_decode():
    rt, kind, kw, lookback = FAMILIES["vae"]
    got = port_cost.estimate_flops_per_row(port_factory(rt, kind)(F, **kw), F, lookback)
    dims = [F, 12, 6, 3, 6, 12, F]
    assert got == (float(sum(2 * a * b for a, b in zip(dims, dims[1:]))), "analytic")
    # the JAX estimate duck-types the module's `dims` onto the LSTM form
    want = jax_cost.estimate_flops_per_row(jax_factory(rt, kind)(F, **kw), F, lookback)
    assert want == (jax_cost.lstm_stack_flops(F, (12, 6), 1), "analytic") and want[0] > 3 * got[0]


def test_closed_forms_and_the_fallback_equal_jax():
    for fn, args in ((port_cost.dense_chain_flops, (7, (5, 3), (3, 5))), (port_cost.lstm_step_flops, (3, (16, 4))),
                     (port_cost.lstm_stack_flops, (3, (16, 4), 9)),
                     (port_cost.conv1d_autoencoder_flops, (10, (32, 16), 3, 33))):
        assert fn(*args) == getattr(jax_cost, fn.__name__)(*args)
    assert port_cost.estimate_flops_per_row(object(), 3, 4, params_per_member=100) == (800.0, "params")
    assert port_cost.estimate_flops_per_row(object(), 3, 4) == (0.0, "unknown")


def _entry(family, name, rng, **extra):
    rt, kind, kw, lookback = FAMILIES[family]
    state = {k: (rng.standard_normal(tuple(v.shape)) / np.sqrt(max(1, v.shape[0]))).astype("f4")
             for k, v in port_factory(rt, kind)(F, **kw).state_dict().items()}
    return entry_from_numpy(name, rt, kind, kw, F, params_to_flax(state), np.zeros(F), np.ones(F),
                            np.zeros(F), np.ones(F), lookback=lookback if rt != "AutoEncoder" else 1,
                            target_offset=int(rt == "LSTMForecast"), **extra)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_analytic_flops_within_the_band_of_the_flop_counter(family):
    """Per output row (a window of a sequence bucket), the analytic count
    against FlopCounterMode over the bucket's forward on the CPU: the
    plain versions run, so the counter sees every step of the recurrence."""
    rng = np.random.default_rng(0)
    bank = ModelBank.from_entries([_entry(family, f"m{i}", rng) for i in range(3)], device="cpu", registry=False)
    (bucket,) = bank._buckets.values()
    B, T = 2, 32
    idx = torch.tensor([0, 2], dtype=torch.int32)
    xs = torch.from_numpy(rng.random((B, T, F), dtype=np.float32))
    with FlopCounterMode(display=False) as counter:
        out = bucket.forward(idx, xs)
    per_row = counter.get_total_flops() / (B * out.shape[1])
    analytic = bucket.flops_per_row
    assert 0.4 * per_row <= analytic <= 2.0 * per_row, (analytic, per_row)
    assert bank.flops_stats()[bucket.label]["flops_per_row"] == analytic


@pytest.mark.parametrize("tallies", [
    dict(routed_rows=300.0, padded_rows=212.0, useful_s=0.0123456789, padded_s=0.004, failed_s=0.0),
    dict(routed_rows=0.0, padded_rows=0.0, useful_s=0.0, padded_s=0.0, failed_s=0.0),
    dict(routed_rows=1e6 / 3, padded_rows=17.5, useful_s=1.0 / 3, padded_s=0.0, failed_s=0.25),
])
@pytest.mark.parametrize("peak", [1e12, 989.4e12, 0.0])
def test_bucket_cost_row_equals_jax(tallies, peak):
    args = dict(flops_per_row=734.0, flops_method="analytic", peak_flops=peak, members=1000, kind="ff", **tallies)
    assert port_cost.bucket_cost_row(**args) == jax_cost.bucket_cost_row(**args)


def _body(label_rows, peak=1e12, source="assumed"):
    buckets = {label: {**port_cost.bucket_cost_row(734.0, "analytic", r, p, u, 0.001, 0.0, peak, 4, "ff"),
                       "live": True} for label, (r, p, u) in label_rows.items()}
    return {"enabled": True, "peak_flops": peak, "peak_source": source, "buckets": buckets}


@pytest.mark.parametrize("bodies", [
    [_body({"a": (100, 28, 0.01), "b": (64, 0, 0.002)})],
    [_body({"a": (100, 28, 0.01)}), None, {"enabled": False}, _body({"a": (50, 14, 0.004), "c": (8, 8, 0.001)})],
    [_body({"a": (1, 1, 0.0)}), _body({"a": (2, 2, 0.1)}, peak=989.4e12, source="device")],
    [None],
])
def test_merge_cost_snapshots_equals_jax(bodies):
    got = port_cost.merge_cost_snapshots(bodies)
    assert got == jax_cost.merge_cost_snapshots(bodies)
    if len(bodies) == 1 and bodies[0] is not None:  # one replica's body comes back
        assert got["buckets"] == bodies[0]["buckets"]


def test_peak_resolution(monkeypatch):
    monkeypatch.delenv("GORDO_DEVICE_PEAK_FLOPS", raising=False)
    assert port_cost.resolve_peak_flops("cpu") == (1e12, "assumed")
    assert port_cost.resolve_peak_flops() == (1e12, "assumed")
    # the H100 SXM's dense bf16 figure, by the name the card reports
    assert port_cost.PEAK_BF16_FLOPS["NVIDIA H100 80GB HBM3"] == 989.4e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert port_cost.resolve_peak_flops(torch.device("cuda", 0)) == (989.4e12, "device")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "Some Other Card")
    assert port_cost.resolve_peak_flops("cuda") == (1e12, "assumed")
    monkeypatch.setenv("GORDO_DEVICE_PEAK_FLOPS", "5e14")
    assert port_cost.resolve_peak_flops("cuda") == (5e14, "env")


def test_the_cost_model_joins_the_bank_and_the_ledger(monkeypatch):
    monkeypatch.delenv("GORDO_DEVICE_PEAK_FLOPS", raising=False)
    rng = np.random.default_rng(1)
    led = GoodputLedger()
    bank = ModelBank.from_entries([_entry("dense", "d0", rng), _entry("lstm", "l0", rng)], device="cpu",
                                  registry=False, ledger=led)
    registry = MetricsRegistry()
    model = port_cost.cost_from_env(led, lambda: bank, registry=registry, device=bank.device)
    assert model.peak_source == "assumed"
    before = model.snapshot()
    assert sorted(before["buckets"]) == sorted(bank.flops_stats()) and before["total_device_s"] == 0.0
    bank.score_many([("d0", rng.random((20, F), dtype=np.float32), None),
                     ("l0", rng.random((40, F), dtype=np.float32), None)])
    assert model.snapshot() is before  # cached until the next sample
    model.sample(force=True)
    snap = model.snapshot()
    for label, row in snap["buckets"].items():
        tallies = led.snapshot()["per_bucket"][label]
        assert (row["routed_rows"], row["padded_rows"]) == (tallies["routed_rows"], tallies["padded_rows"])
        assert row["mfu"] > 0 and row["live"] is True
    scores = [(-r["wasted_device_score"], r["bucket"]) for r in snap["ranking"]]
    assert scores == sorted(scores) and len(scores) == len(snap["buckets"])
    families = {name for name, *_ in parse_prometheus_text(registry.render())[1]}
    assert {"gordo_bucket_mfu", "gordo_bucket_flops_per_row", "gordo_bucket_pad_waste_score",
            "gordo_bucket_device_seconds_per_1k_rows"} <= families
    monkeypatch.setenv("GORDO_COST", "0")
    assert port_cost.cost_from_env(led, lambda: bank) is None
