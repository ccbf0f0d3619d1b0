"""The port's access heat against the JAX package's, on the CPU.

- One sequence of routed rows over a fake clock (bursts, quiet stretches
  that decay and evict members, a bank rebinding midway) gives the JAX
  accountant and the port's equal ``snapshot()``, ``ranked()`` and
  ``rates()`` after every sample, and the registry renders the same
  ``gordo_heat_*`` text.
- ``merge_heat_snapshots`` of the same replica bodies is the JAX one's.
- The bank feeds heat one dict get and set a request from ``_host_prep``;
  its warm-up does not; ``GORDO_HEAT=0`` builds no accountant.
- A served app keeps its heat across ``/reload``: the ranking stands and
  the bucket attribution follows the new bank.
"""

import json
import urllib.request

import numpy as np
import pytest

from gordo_components_torch.convert import entry_from_numpy
from gordo_components_torch.observability import heat as port_heat
from gordo_components_torch.observability.metrics import MetricsRegistry as PortRegistry
from gordo_components_torch.server import ModelBank, run_server
from gordo_components_torch import serializer
from gordo_components_tpu.observability import MetricsRegistry as JaxRegistry
from gordo_components_tpu.observability import heat as jax_heat

F = 3


class _JaxBank:
    """What the JAX accountant reads of a bank: ``placement()``."""

    def __init__(self, buckets):
        self.buckets = buckets

    def placement(self):
        return {"buckets": [{"bucket": label, "members": list(members)} for label, members in self.buckets.items()]}


class _Bucket:
    def __init__(self, label):
        self.label = label


class _PortBank:
    """What the port's accountant reads of a bank: its index and buckets."""

    def __init__(self, buckets):
        self._buckets = {f"key-{label}": _Bucket(label) for label in buckets}
        self._index = {m: (f"key-{label}", i) for label, members in buckets.items() for i, m in enumerate(members)}


def _pair(now, **kwargs):
    jreg, preg = JaxRegistry(), PortRegistry()
    clock = lambda: now[0]  # noqa: E731
    return (jax_heat.HeatAccountant(registry=jreg, clock=clock, **kwargs), jreg,
            port_heat.HeatAccountant(registry=preg, clock=clock, **kwargs), preg)


@pytest.mark.parametrize("seed,halflife", [(0, 30.0), (1, 300.0), (2, 5.0)])
def test_heat_matches_jax_over_one_sequence(seed, halflife):
    rng = np.random.default_rng(seed)
    now = [1000.0]
    jh, jreg, ph, preg = _pair(now, halflife_s=halflife, hot_rate=5.0, warm_rate=0.5, sample_interval_s=10.0)
    banks = [
        {"dense:f3": [f"m{i:02d}" for i in range(12)], "lstm:f3": [f"s{i:02d}" for i in range(5)]},
        {"dense:f3": [f"m{i:02d}" for i in range(0, 12, 2)], "conv:f3": ["c0", "c1"]},
    ]
    held = [_JaxBank(banks[0]), _PortBank(banks[0])]
    jh.bind_bank(held[0])
    ph.bind_bank(held[1])
    names = [m for members in banks[0].values() for m in members] + ["ghost"]
    for step in range(40):
        if step == 20:  # a reload: the heat stays, the attribution follows the new bank
            held = [_JaxBank(banks[1]), _PortBank(banks[1])]
            jh.bind_bank(held[0])
            ph.bind_bank(held[1])
        for _ in range(int(rng.integers(0, 30))):
            name = names[int(rng.zipf(1.5)) % len(names)]
            rows = float(rng.integers(1, 400))
            for h in (jh, ph):
                h.pending[name] = h.pending.get(name, 0.0) + rows
        now[0] += float(rng.choice([0.5, 3.0, 11.0, 120.0, 2000.0]))
        assert ph.sample(force=step % 7 == 0) == jh.sample(force=step % 7 == 0)
        assert ph.snapshot() == jh.snapshot(), step
        for n in (0, 3, 50):
            assert ph.ranked(n) == jh.ranked(n), (step, n)
        assert ph.rates() == jh.rates()
        assert preg.render() == jreg.render(), step
    now[0] += 100 * halflife  # a long quiet stretch evicts every member
    assert ph.sample() and jh.sample()
    assert ph.snapshot() == jh.snapshot() and ph.snapshot()["members_tracked"] == 0
    assert preg.render() == jreg.render()


def test_merge_heat_snapshots_matches_jax():
    now = [0.0]
    bodies = []
    for replica in range(3):
        jh, _, ph, _ = _pair(now, halflife_s=60.0)
        ph.bind_bank(_PortBank({"dense:f3": [f"m{i}" for i in range(8)]}))
        for i in range(8):
            ph.pending[f"m{i}"] = float((i + 1) * (replica + 1) * 100)
        now[0] += 30.0
        ph.sample(force=True)
        bodies.append({"enabled": True, **ph.snapshot(), **ph.ranked(4)})
    bodies += [None, {"enabled": False}]
    for top in (0, 2, 10):
        assert port_heat.merge_heat_snapshots(bodies, top) == jax_heat.merge_heat_snapshots(bodies, top)
    # one replica is that replica's body
    one = port_heat.merge_heat_snapshots(bodies[:1], 4)
    for key in ("hottest", "coldest", "tiers", "per_bucket"):
        assert one[key] == bodies[0][key]


def test_heat_from_env(monkeypatch):
    monkeypatch.setenv("GORDO_HEAT", "0")
    assert port_heat.heat_from_env() is None and jax_heat.heat_from_env() is None
    monkeypatch.setenv("GORDO_HEAT", "1")
    monkeypatch.setenv("GORDO_HEAT_HALFLIFE_S", "45")
    monkeypatch.setenv("GORDO_HEAT_HOT_RATE", "20")
    monkeypatch.setenv("GORDO_HEAT_WARM_RATE", "2")
    monkeypatch.setenv("GORDO_HEAT_SAMPLE_S", "0.5")
    h = port_heat.heat_from_env()
    assert (h.halflife_s, h.hot_rate, h.warm_rate, h.sample_interval_s) == (45.0, 20.0, 2.0, 0.5)
    monkeypatch.setenv("GORDO_HEAT_WARM_RATE", "30")
    with pytest.raises(ValueError, match="must not exceed"):
        port_heat.heat_from_env()
    monkeypatch.setenv("GORDO_HEAT_WARM_RATE", "x")
    with pytest.raises(ValueError, match="must be a number"):
        port_heat.heat_from_env()


def _entry(name, rng):
    dims = [F, 2, F]
    params = {"params": {f"Dense_{i}": {"kernel": rng.standard_normal((a, b)).astype(np.float32),
                                        "bias": rng.standard_normal(b).astype(np.float32)}
                         for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}}
    return entry_from_numpy(name, "AutoEncoder", "feedforward_model", {"encoding_dim": [2], "decoding_dim": []},
                            F, params, in_shift=np.zeros(F), in_scale=np.ones(F), err_shift=np.zeros(F),
                            err_scale=np.ones(F))


def test_the_bank_feeds_heat_and_its_warmup_does_not():
    rng = np.random.default_rng(0)
    heat = port_heat.HeatAccountant(clock=lambda: 0.0)
    bank = ModelBank.from_entries([_entry(f"m{i}", rng) for i in range(3)], device="cpu", registry=False,
                                  heat=heat)
    assert bank.warmup() == 1 and heat.pending == {}
    X = rng.random((20, F), dtype=np.float32)
    bank.score_many([("m0", X, None), ("m2", X[:5], None), ("m0", X[:7], None)])
    assert heat.pending == {"m0": 27.0, "m2": 5.0}
    assert heat.ranked(5)["hottest"][0]["bucket"] == bank._buckets[bank._index["m0"][0]].label
    assert heat.snapshot()["members_total"] == 3  # m1 is cold, not missing


def _get(server, path):
    with urllib.request.urlopen(server.url + path, timeout=60) as resp:
        return json.load(resp)


def _post(server, path, body):
    req = urllib.request.Request(server.url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.load(resp)


def test_heat_survives_a_reload(tmp_path, monkeypatch):
    monkeypatch.setenv("GORDO_HEAT_SAMPLE_S", "3600")
    rng = np.random.default_rng(1)
    for name in ("a", "b", "c"):
        serializer.dump(_entry(name, rng), str(tmp_path / name))
    server = run_server(str(tmp_path), host="127.0.0.1", port=0, device="cpu", background=True)
    try:
        for name, posts in (("a", 3), ("b", 1), ("c", 2)):
            for _ in range(posts):
                assert _post(server, f"/gordo/v0/p/{name}/anomaly/prediction", {"X": [[0.1, 0.2, 0.3]] * 10})[0] == 200
        before = _get(server, "/gordo/v0/p/heat?refresh=1&top=3")
        assert [e["member"] for e in before["hottest"]] == ["a", "c", "b"]
        serializer.dump(_entry("d", rng), str(tmp_path / "d"))
        status, body = _post(server, "/gordo/v0/p/reload", {})
        assert status == 200 and body["changes"]["added"] == ["d"] and server.app.bank.heat is server.app.heat
        after = _get(server, "/gordo/v0/p/heat?refresh=1&top=4")
        assert [e["member"] for e in after["hottest"]] == ["a", "c", "b", "d"]
        assert [e["rate"] for e in after["hottest"][:3]] == pytest.approx([e["rate"] for e in before["hottest"]],
                                                                          rel=1e-3)
        assert after["members_total"] == 4 and sum(after["tiers"].values()) == 4
        assert sum(sum(cell.values()) for cell in after["per_bucket"].values()) == 4
        assert _get(server, "/gordo/v0/p/stats")["heat"]["members_total"] == 4
    finally:
        server.close()


def test_heat_off_answers_disabled(tmp_path, monkeypatch):
    monkeypatch.setenv("GORDO_HEAT", "0")
    serializer.dump(_entry("a", np.random.default_rng(2)), str(tmp_path / "a"))
    server = run_server(str(tmp_path), host="127.0.0.1", port=0, device="cpu", background=True)
    try:
        assert server.app.heat is None and server.app.bank.heat is None
        assert _get(server, "/gordo/v0/p/heat") == {"enabled": False}
        assert "heat" not in _get(server, "/gordo/v0/p/stats")
    finally:
        server.close()
