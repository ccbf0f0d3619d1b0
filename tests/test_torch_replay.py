"""The port's replay harness against the JAX package's, on the CPU.

- the pure modules on seeded inputs, equal results: ``combine_injection``
  over a fuzz of overlapping incidents, ``Scenario.judge`` and the game-day
  ``GamedayScenario.judge`` over seeded verdicts, both catalogs field by
  field, ``finalize_verdict`` and its two checks, and the watchman's
  ``burn_episodes``, ``group_incidents`` and ``render_timeline`` over seeded
  burn series and event lists;
- the engine end to end: ``default_fleet()`` trained once with the JAX
  ``train_fleet`` and carried across with ``tools/jax_artifact_to_torch.py``
  (as tests/test_torch_streaming.py does), ``mean_shift`` through both
  engines (the port's on the CPU). Detection, the delivery totals, the
  statuses, the adaptations and the FP/FN rates before adaptation are
  equal; the rates after the refit lie within one probe row (1/48), each
  package refitting with its own optimizer. Each side's ``judge`` gives
  no failure but the speed line: the 100x speed floor is a wall-clock
  bound, which a loaded CPU runner can miss, so it is judged on the card
  (``python3 chip_smoke.py replay``);
- the port alone: its registry renders the four ``gordo_replay_*`` series,
  its event time is pandas' nanoseconds, and its entry points default to
  the card.
"""

import copy
import dataclasses
import importlib.util
import os

import numpy as np
import pandas as pd
import pytest

from gordo_components_torch import gameday as port_gameday
from gordo_components_torch import replay as port_replay
from gordo_components_torch.observability.metrics import MetricsRegistry, parse_prometheus_text
from gordo_components_torch.replay import engine as port_engine
from gordo_components_torch.replay import incidents as port_incidents
from gordo_components_torch.replay import scenarios as port_scenarios
from gordo_components_torch.replay import verdict as port_verdict
from gordo_components_torch.watchman import correlate as port_correlate
from gordo_components_tpu.gameday import scenarios as jax_gameday
from gordo_components_tpu.replay import engine as jax_engine
from gordo_components_tpu.replay import incidents as jax_incidents
from gordo_components_tpu.replay import scenarios as jax_scenarios
from gordo_components_tpu.replay import verdict as jax_verdict
from gordo_components_tpu.watchman import correlate as jax_correlate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = importlib.util.spec_from_file_location(
    "jax_artifact_to_torch", os.path.join(REPO, "tools", "jax_artifact_to_torch.py"))
TOOL = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(TOOL)

PROBE_ROW = 1.0 / 48  # one row of a 48-row FP/FN probe batch
RATE_ROUNDING = 1e-4  # each engine rounds a rate to 4 decimals: 0.5e-4 a side
DELIVERY = ("rows_total", "late_rows_total", "dropped_rows_total", "duplicate_rows_total", "dropout_cells_total")
REPLAY_SERIES = {"gordo_replay_scenarios_total": "counter", "gordo_replay_event_seconds_total": "counter",
                 "gordo_replay_non200_total": "counter", "gordo_replay_speedup": "gauge"}


# ---------------------------------------------------------------------- #
# incidents
# ---------------------------------------------------------------------- #


def _random_incident_kwargs(rng, tags):
    kw = {"kind": f"k{int(rng.integers(5))}", "start_s": float(rng.integers(0, 4)) * 100.0}
    if rng.random() < 0.5:
        kw["duration_s"] = float(rng.integers(1, 4)) * 100.0
    if rng.random() < 0.5:
        kw["members"] = tuple(sorted(rng.choice(["a", "b", "c"], size=int(rng.integers(1, 3)), replace=False)))
    if rng.random() < 0.5:
        kw["mean_shift"] = float(np.round(rng.normal(0, 3), 3))
    if rng.random() < 0.4:
        kw["var_inflation"] = float(rng.choice([1.0, 2.0, 400.0]))
    for key in ("dropout_p", "late_fraction", "duplicate_p"):
        if rng.random() < 0.3:
            kw[key] = float(np.round(rng.random(), 3))
    if rng.random() < 0.3:
        kw["season_amp"] = float(np.round(rng.random(), 3))
        kw["season_period_s"] = float(rng.choice([0.0, 400.0, 8 * 3600.0]))
    if rng.random() < 0.4:
        kw["tags"] = tuple(rng.choice(tags, size=int(rng.integers(1, len(tags))), replace=False))
    if rng.random() < 0.2:
        kw["flatline_tags"] = (str(rng.choice(tags)),)
    if rng.random() < 0.2:
        kw["faults"] = ({"site": "stream.refit", "times": 1},)
    kw["expect_detect"] = bool(rng.random() < 0.7)
    return kw


@pytest.mark.parametrize("seed", range(4))
def test_combine_injection_matches_jax_over_overlapping_incidents(seed):
    rng = np.random.default_rng(seed)
    tags = [f"tag-{i}" for i in range(5)]
    for _ in range(50):
        kws = [_random_incident_kwargs(rng, tags) for _ in range(int(rng.integers(0, 5)))]
        port = [port_incidents.Incident(**kw) for kw in kws]
        jax = [jax_incidents.Incident(**kw) for kw in kws]
        duration = 500.0
        for t in (0.0, 50.0, 150.0, 299.5, 450.0):
            got = port_incidents.combine_injection([i for i in port if i.active(t, duration)], t)
            want = jax_incidents.combine_injection([i for i in jax if i.active(t, duration)], t)
            assert got == want, (kws, t)
            for p, j in zip(port, jax):
                assert (p.active(t, duration), p.applies_to("a"), p.end_s(duration), p.key(3)) == (
                    j.active(t, duration), j.applies_to("a"), j.end_s(duration), j.key(3))


# ---------------------------------------------------------------------- #
# judges and the verdict envelope
# ---------------------------------------------------------------------- #

REPLAY_BOUNDS = {
    "max_detection_latency_s": lambda r: float(r.integers(1, 5)) * 3600.0,
    "forbid_detection": lambda r: bool(r.random() < 0.5),
    "fp_after_max": lambda r: float(np.round(r.random(), 2)),
    "fp_drop_factor_min": lambda r: float(r.integers(1, 4)),
    "fn_after_max": lambda r: float(np.round(r.random(), 2)),
    "min_duplicates": lambda r: int(r.integers(0, 200)),
    "max_non200": lambda r: int(r.integers(0, 3)),
    "min_speedup": lambda r: float(r.choice([1.0, 100.0, 1e6])),
    "expect_rolled_back": lambda r: bool(r.random() < 0.5),
    "require_adapted": lambda r: bool(r.random() < 0.5),
    "no_such_bound": lambda r: 1,
}


def _random_replay_verdict(rng):
    members = ["m3-0", "m3-1", "m5-0"]
    v = {
        "incidents": {
            f"{i}:k": {"expect_detect": bool(rng.random() < 0.7), "detected": bool(rng.random() < 0.7),
                       "detection_latency_s": float(rng.integers(0, 6)) * 3600.0}
            for i in range(int(rng.integers(0, 3)))
        },
        "ever_drifted": sorted(rng.choice(members, size=int(rng.integers(0, 3)), replace=False).tolist()),
        "non_200": int(rng.integers(0, 3)),
        "statuses": {"200": 5},
        "speedup": float(rng.choice([50.0, 500.0, 1e5])),
        "rolled_back": int(rng.integers(0, 2)),
        "adaptations": int(rng.integers(0, 3)),
        "duplicate_rows_total": int(rng.integers(0, 300)),
    }
    for key in ("fp_rate_before", "fp_rate_after", "fn_rate_after"):
        if rng.random() < 0.8:
            v[key] = {m: float(np.round(rng.random(), 4) * (rng.random() < 0.8)) for m in members}
    return v


@pytest.mark.parametrize("seed", range(4))
def test_scenario_judge_matches_jax_over_seeded_verdicts(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(60):
        keys = [k for k in REPLAY_BOUNDS if rng.random() < 0.5]
        bounds = {k: REPLAY_BOUNDS[k](rng) for k in keys}
        kw = dict(name="t", duration_s=100.0, incidents=(), bounds=bounds)
        verdict = _random_replay_verdict(rng)
        got = port_incidents.Scenario(**kw).judge(copy.deepcopy(verdict))
        want = jax_incidents.Scenario(**kw).judge(copy.deepcopy(verdict))
        assert got == want, (bounds, verdict)


GAMEDAY_BOUNDS = {
    "max_detection_latency_s": lambda r: float(r.integers(5, 60)),
    "max_non200": lambda r: int(r.integers(0, 3)),
    "max_recovery_s": lambda r: float(r.integers(10, 150)),
    "max_drift_recovery_s": lambda r: float(r.integers(10, 150)),
    "require_event_order": lambda r: ["mesh.replica_unreachable", "mesh.replica_recovered"][::int(r.choice([1, -1]))],
    "min_routing_version_steps": lambda r: int(r.integers(0, 4)),
    "min_hedge_wins": lambda r: int(r.integers(0, 4)),
    "min_reroutes": lambda r: int(r.integers(0, 3)),
    "max_routing_refreshes": lambda r: int(r.integers(0, 20)),
    "min_drift_replicas": lambda r: int(r.integers(0, 4)),
    "min_distinct_reconnect_delays": lambda r: int(r.integers(0, 6)),
    "require_all_subscribers_recovered": lambda r: bool(r.random() < 0.5),
    "min_burn_peak": lambda r: float(r.integers(0, 3)),
    "min_shed_precision": lambda r: float(np.round(r.random(), 2)),
    "min_class_burn_peak": lambda r: float(r.integers(0, 3)),
    "max_interactive_p99_ratio": lambda r: float(r.integers(1, 3)),
    "bogus": lambda r: 0,
}


def _random_gameday_verdict(rng):
    types = ["mesh.replica_unreachable", "mesh.replica_recovered", "drift.flagged", "adapt.recalibrate"]
    pick = lambda p, v: v if rng.random() < p else None  # noqa: E731
    v = {
        "detected": bool(rng.random() < 0.7),
        "detection_latency_s": pick(0.8, float(np.round(rng.random() * 60, 1))),
        "non_200": int(rng.integers(0, 3)),
        "statuses": {"200": 9},
        "recovered": bool(rng.random() < 0.7),
        "recovery_s": pick(0.8, float(np.round(rng.random() * 200, 1))),
        "events": [{"type": t} for t in rng.permutation(types)[: int(rng.integers(0, 5))]] + ["not a dict"],
        "routing_version_steps": int(rng.integers(0, 4)),
        "hedge_wins": int(rng.integers(0, 5)),
        "reroutes": int(rng.integers(0, 3)),
        "routing_refreshes": int(rng.integers(0, 20)),
        "drifted_replicas": list(range(int(rng.integers(0, 4)))),
        "distinct_reconnect_delays": int(rng.integers(0, 6)),
        "subscribers_lost": list(range(int(rng.integers(0, 2)))),
        "burn_peak": pick(0.8, float(np.round(rng.random() * 3, 2))),
        "shed_precision": pick(0.8, float(np.round(rng.random(), 3))),
        "class_burn_peak": pick(0.8, float(np.round(rng.random() * 3, 2))),
        "interactive_p99_ratio": pick(0.8, float(np.round(rng.random() * 3, 2))),
    }
    return {k: x for k, x in v.items() if x is not None or rng.random() < 0.5}


@pytest.mark.parametrize("seed", range(4))
def test_gameday_judge_matches_jax_over_seeded_verdicts(seed):
    rng = np.random.default_rng(200 + seed)
    for _ in range(60):
        keys = [k for k in GAMEDAY_BOUNDS if rng.random() < 0.4]
        multi = [k for k in GAMEDAY_BOUNDS if rng.random() < 0.2]
        kw = dict(name="g", description="d", mesh="replicated", bounds={k: GAMEDAY_BOUNDS[k](rng) for k in keys},
                  multicore_bounds={k: GAMEDAY_BOUNDS[k](rng) for k in multi})
        verdict = _random_gameday_verdict(rng)
        for single_core in (False, True):
            got = port_gameday.GamedayScenario(**kw).finalize(copy.deepcopy(verdict), single_core)
            want = jax_gameday.GamedayScenario(**kw).finalize(copy.deepcopy(verdict), single_core)
            assert got == want, (kw, verdict)
    # the catalog's own scenarios judge alike
    for name in port_gameday.known_scenarios():
        verdict = _random_gameday_verdict(rng)
        assert (port_gameday.SCENARIOS[name].judge(copy.deepcopy(verdict))
                == jax_gameday.SCENARIOS[name].judge(copy.deepcopy(verdict)))


def test_the_catalogs_match_jax_field_by_field():
    port, jax = port_scenarios.standard_scenarios(), jax_scenarios.standard_scenarios()
    assert [dataclasses.asdict(s) for s in port] == [dataclasses.asdict(s) for s in jax]
    assert [s.name for s in port] == ["mean_shift", "variance_inflation", "sensor_dropout", "flatline",
                                      "late_duplicate", "seasonal_cycle", "correlated_failure",
                                      "refit_fault_mid_incident"]
    assert port_scenarios.default_fleet() == jax_scenarios.default_fleet()
    assert (port_scenarios.TAGS3, port_scenarios.TAGS5) == (jax_scenarios.TAGS3, jax_scenarios.TAGS5)
    assert {n: dataclasses.asdict(s) for n, s in port_gameday.SCENARIOS.items()} == {
        n: dataclasses.asdict(s) for n, s in jax_gameday.SCENARIOS.items()}
    assert list(port_gameday.SCENARIOS) == list(jax_gameday.SCENARIOS)
    assert port_gameday.GATE_DEFAULT == jax_gameday.GATE_DEFAULT
    assert port_gameday.known_scenarios() == jax_gameday.known_scenarios()


def test_finalize_verdict_and_its_checks_match_jax():
    rng = np.random.default_rng(7)
    assert port_verdict.VERDICT_SCHEMA == jax_verdict.VERDICT_SCHEMA
    for _ in range(40):
        verdict = {"non_200": int(rng.integers(0, 4)), "statuses": {"200": 3, "503": 1}}
        fails_p, fails_j = [], []
        budget = int(rng.integers(0, 3))
        port_verdict.check_non200(verdict, budget, fails_p)
        jax_verdict.check_non200(verdict, budget, fails_j)
        args = (bool(rng.random() < 0.7), float(rng.integers(0, 50)) if rng.random() < 0.8 else None,
                float(rng.integers(0, 50)) if rng.random() < 0.8 else None, "the drill")
        port_verdict.check_detection(*args, fails_p)
        jax_verdict.check_detection(*args, fails_j)
        assert fails_p == fails_j
        assert port_verdict.finalize_verdict(dict(verdict), fails_p) == jax_verdict.finalize_verdict(
            dict(verdict), fails_j)


# ---------------------------------------------------------------------- #
# watchman correlation
# ---------------------------------------------------------------------- #


def _seeded_events(rng, n):
    types = ["bank.swap", "drift.flagged", "fault.fired", "quarantine.enter", "adapt.refit"]
    out = []
    for seq in range(n):
        ev = {"seq": seq, "wall": float(np.round(rng.random() * 1000, 3)), "type": str(rng.choice(types)),
              "severity": str(rng.choice(["info", "warning", "critical"]))}
        if rng.random() < 0.6:
            ev["attrs"] = {k: int(rng.integers(0, 9)) for k in rng.choice(["site", "gen", "b"], 2, replace=False)}
        if rng.random() < 0.5:
            ev["replica"] = f"r{int(rng.integers(3))}"
        out.append(ev)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_correlation_matches_jax_over_seeded_series_and_events(seed):
    rng = np.random.default_rng(300 + seed)
    for _ in range(20):
        points = [[float(t) * 10.0, None if rng.random() < 0.1 else float(np.round(rng.random() * 3, 3))]
                  for t in range(int(rng.integers(0, 60)))]
        for threshold, min_points in ((1.0, 1), (1.5, 2), (0.5, 3)):
            assert (port_correlate.burn_episodes(points, threshold, min_points)
                    == jax_correlate.burn_episodes(points, threshold, min_points))
        episodes = port_correlate.burn_episodes(points, 1.0)
        for ep in episodes:
            if rng.random() < 0.7:
                ep["series"] = str(rng.choice(["availability", "goodput_ratio"]))
            if rng.random() < 0.7:
                ep["replica"] = f"r{int(rng.integers(3))}"
        events = _seeded_events(rng, int(rng.integers(0, 30)))
        for margin in (0.0, 30.0):
            assert (port_correlate.group_incidents(copy.deepcopy(episodes), copy.deepcopy(events), margin)
                    == jax_correlate.group_incidents(copy.deepcopy(episodes), copy.deepcopy(events), margin))
        start = float(rng.random() * 500)
        assert port_correlate.render_timeline(start, events) == jax_correlate.render_timeline(start, events)
    assert port_correlate.group_incidents([]) == jax_correlate.group_incidents([]) == []


# ---------------------------------------------------------------------- #
# the engine end to end
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def mean_shift_runs(tmp_path_factory):
    """(JAX verdict, port verdict, port engine) of ``mean_shift`` over one
    fleet: trained with the JAX ``train_fleet``, converted for the port."""
    members = jax_scenarios.default_fleet()
    jax_root = str(tmp_path_factory.mktemp("replay-jax"))
    port_root = str(tmp_path_factory.mktemp("replay-port"))
    jax_engine.train_fleet(jax_root, members, epochs=3)
    assert TOOL.main([jax_root, port_root]) == 0
    scenario = {s.name: s for s in jax_scenarios.standard_scenarios()}["mean_shift"]
    jax_verdict_ = jax_engine.ReplayEngine(jax_root, members).run_sync(scenario)
    engine = port_engine.ReplayEngine(port_root, members, device="cpu")
    port_scenario = {s.name: s for s in port_scenarios.standard_scenarios()}["mean_shift"]
    port_verdict_ = engine.run_sync(port_scenario)
    return jax_verdict_, port_verdict_, engine


def test_mean_shift_detection_delivery_and_statuses_match_jax(mean_shift_runs):
    jax, port, _ = mean_shift_runs
    for key, want in jax["incidents"].items():
        got = port["incidents"][key]
        assert got == want, key
        assert got["detected"] and got["members_flagged"] == ["m3-1", "m5-0"]
    assert port["ever_drifted"] == jax["ever_drifted"]
    for key in DELIVERY:
        assert port[key] == jax[key], key
    assert port["rows_total"] > 0
    assert port["statuses"] == jax["statuses"] and port["non_200"] == jax["non_200"] == 0


def test_mean_shift_adaptations_and_rates_match_jax(mean_shift_runs):
    jax, port, _ = mean_shift_runs
    for key in ("adaptations", "refits", "rolled_back", "swap_count", "generation"):
        assert port[key] == jax[key], key
    assert port["adaptations"] >= 2 and port["generation"] >= 2
    assert port["fp_rate_before"] == jax["fp_rate_before"]
    assert port["fn_rate_before"] == jax["fn_rate_before"]
    for key in ("fp_rate_after", "fn_rate_after"):
        assert sorted(port[key]) == sorted(jax[key])
        for member, want in jax[key].items():
            assert abs(port[key][member] - want) <= PROBE_ROW + RATE_ROUNDING, (key, member, port[key][member], want)
    assert port["adaptation_cost_s"] > 0 and port["swap_pause_ms_max"] > 0


def test_mean_shift_judged_alike_but_for_the_speed_line(mean_shift_runs):
    jax, port, _ = mean_shift_runs
    for verdict in (jax, port):
        assert [f for f in verdict["failures"] if not f.startswith("speedup ")] == []
        assert verdict["schema"] == "gordo.scenario-verdict/v1"
    assert sorted(port) == sorted(jax)
    assert port["scenario"] == "mean_shift" and port["speed"] == jax["speed"] == 500.0
    assert port["event_seconds"] == jax["event_seconds"]
    flagged = [e["attrs"] for e in port["events"] if e["type"] == "drift.flagged"]
    assert sorted(a["target"] for a in flagged) == ["m3-1", "m5-0"]
    assert len(port["timeline"]) == len(port["events"])


def test_the_port_registry_renders_the_replay_series(mean_shift_runs):
    jax, port, engine = mean_shift_runs
    types, samples = parse_prometheus_text(engine.registry.render())
    values = {name: value for name, labels, value in samples if name in REPLAY_SERIES}
    assert {n: types[n] for n in values} == REPLAY_SERIES
    assert values["gordo_replay_scenarios_total"] == 1
    assert values["gordo_replay_event_seconds_total"] >= port["event_seconds"]
    assert values["gordo_replay_non200_total"] == 0
    assert values["gordo_replay_speedup"] == port["speedup"]
    # a second registry reads the same totals through the collector
    other = MetricsRegistry()
    other.collector(engine._collect, key="replay")
    assert "gordo_replay_speedup " in other.render()


# ---------------------------------------------------------------------- #
# the port alone
# ---------------------------------------------------------------------- #


def test_event_time_is_pandas_nanoseconds():
    rng = np.random.default_rng(11)
    for s in [0.0, 1440.0, 0.1, 43199.5, 2.5e-7, *(rng.random(200) * 1e6)]:
        assert port_engine.seconds_ns(float(s)) == pd.Timedelta(seconds=float(s)).value
    engine = port_engine.ReplayEngine("unused", {}, device="cpu", start="2026-08-02T00:00:00Z")
    start = pd.Timestamp("2026-08-02T00:00:00Z")
    assert engine.start_ns == start.value
    assert engine.step_s == pd.Timedelta("1min").total_seconds() and engine.batch_span_s == 1440.0
    naive = port_engine.ReplayEngine("unused", {}, device="cpu", start="2026-08-02T00:00:00")
    assert naive.start_ns == pd.Timestamp("2026-08-02T00:00:00").tz_localize("UTC").value
    jax = jax_engine.ReplayEngine("unused", {})
    assert (engine.step_s, engine.batch_span_s, engine.sweep_every_s, engine._env()) == (
        jax.step_s, jax.batch_span_s, jax.sweep_every_s, jax._env())
    t = 3 * 1440.0
    assert (float(engine.start_ns + port_engine.seconds_ns(t) + port_engine.seconds_ns(engine.batch_span_s)) / 1e9
            == float((start + pd.Timedelta(seconds=t) + pd.Timedelta(seconds=engine.batch_span_s)).value) / 1e9)


def test_entry_points_default_to_the_card_and_pass_devices_to_run_server(tmp_path, monkeypatch):
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_engine.ReplayEngine(str(tmp_path), {})
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_engine.train_fleet(str(tmp_path), {"m": ["a"]})
    # once refused; devices now goes to the server's build_app, as the JAX
    # engine passes it
    import gordo_components_torch.server as port_server

    seen = {}

    def fake_run_server(root, **kwargs):
        seen.update(kwargs)
        raise RuntimeError("stop here")

    monkeypatch.setattr(port_server, "run_server", fake_run_server)
    engine = port_engine.ReplayEngine(str(tmp_path), {}, devices=2, device="cpu")
    with pytest.raises(RuntimeError, match="stop here"):
        engine.run(port_replay.standard_scenarios()[0])
    assert seen["devices"] == 2 and str(seen["device"]) == "cpu"


def test_the_package_exports_lazily():
    assert port_replay.Scenario is port_incidents.Scenario
    assert port_replay.Incident is port_incidents.Incident
    assert port_replay.ReplayEngine is port_engine.ReplayEngine
    assert port_replay.standard_scenarios is port_scenarios.standard_scenarios
    assert sorted(port_replay.__all__) == sorted(__import__("gordo_components_tpu.replay").replay.__all__)
    with pytest.raises(AttributeError):
        port_replay.no_such_name  # noqa: B018
