"""The port's workflow compile side against the JAX package's, on the CPU.

- ``content_key`` over seeded payloads (datetimes from both YAML readers
  among them: ``default=str`` renders them, so their ``str()`` must agree),
  ``FleetDAG`` through JSON both ways, ``schedule_gangs``,
  ``CanaryConfig.from_spec`` from the spec and from the environment, and
  ``judge_canary``, ``CanaryHistory`` and ``judge_canary_window`` over
  seeded signals: equal results;
- ``compile_fleet`` of tests/test_fleet_compiler.py's ``fleet_spec()``:
  byte-equal to tests/golden_fleet_dag.json (as ``workflow compile -o``
  writes it) and to the JAX compile; of examples/fleet.yaml: byte-equal to
  the JAX compile once the default model is swapped. That swap is the one
  documented divergence: the port's ``DEFAULT_MODEL_CONFIG`` names
  ``gordo_components_torch`` classes, so a machine that leaves its model
  to the default has other keys (its own test below). Every ``ValueError``
  of a table of bad specs reads as the JAX compiler's;
- ``generate_workflow`` byte-equal to the JAX render (jinja2) for the
  golden spec, examples/fleet.yaml, a compiled DAG sent through JSON and an
  SLO objective whose name holds ``<``, ``&`` and ``'`` (``tojson`` escapes
  them); its override and knob errors read as JAX's. The port's template
  subset against jinja2 itself on small templates;
- the CLI's ``workflow compile`` and ``workflow generate`` against the JAX
  CLI's bytes and exit codes (``workflow run`` in
  ``tests/test_torch_executor.py``);
- the ``workflow.canary`` fault point is registered.
"""

import copy
import datetime
import json
import os

import jinja2
import numpy as np
import pytest
import yaml
from click.testing import CliRunner

import gordo_components_torch.workflow.config as port_config
from gordo_components_torch import resilience as port_resilience
from gordo_components_torch.cli import main
from gordo_components_torch.utils import template_subset
from gordo_components_torch.utils.yaml_subset import safe_load
from gordo_components_torch.workflow import canary as port_canary
from gordo_components_torch.workflow import compiler as port_compiler
from gordo_components_torch.workflow import dag as port_dag
from gordo_components_torch.workflow import generator as port_generator
from gordo_components_torch.workflow import scheduler as port_scheduler
from gordo_components_tpu.cli.cli import gordo
from gordo_components_tpu.workflow import canary as jax_canary
from gordo_components_tpu.workflow import compiler as jax_compiler
from gordo_components_tpu.workflow import config as jax_config
from gordo_components_tpu.workflow import dag as jax_dag
from gordo_components_tpu.workflow import generator as jax_generator
from gordo_components_tpu.workflow import scheduler as jax_scheduler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden_fleet_dag.json")
FLEET_YAML = os.path.join(REPO, "examples", "fleet.yaml")
_DS = {"type": "RandomDataset", "train_start_date": "2017-12-25 06:00:00Z", "train_end_date": "2017-12-25 18:00:00Z"}
_MODEL = {"gordo_components_tpu.models.DiffBasedAnomalyDetector": {"base_estimator": {"sklearn.pipeline.Pipeline": {
    "steps": ["sklearn.preprocessing.MinMaxScaler", {"gordo_components_tpu.models.AutoEncoder": {
        "kind": "feedforward_hourglass", "epochs": 1, "batch_size": 32}}]}}}}
CANARY_ENV = {"traffic_slice": "GORDO_FLEET_CANARY_SLICE", "window_s": "GORDO_FLEET_CANARY_WINDOW_S",
              "poll_s": "GORDO_FLEET_CANARY_POLL_S", "min_requests": "GORDO_FLEET_CANARY_MIN_REQUESTS",
              "min_samples": "GORDO_FLEET_CANARY_MIN_SAMPLES", "burn_polls": "GORDO_FLEET_CANARY_BURN_POLLS",
              "fast_burn_threshold": "GORDO_FLEET_FAST_BURN", "max_goodput_drop": "GORDO_FLEET_MAX_GOODPUT_DROP",
              "max_success_drop": "GORDO_FLEET_MAX_SUCCESS_DROP"}


def fleet_spec(gameday_gate=None):
    """tests/test_fleet_compiler.py's golden spec: 8 machines in 2 buckets."""
    machines = [{"name": f"m-{i}", "dataset": dict(_DS, tag_list=[f"a{i}", f"b{i}", f"c{i}"]),
                 "metadata": {"rev": 1}} for i in range(5)]
    machines += [{"name": f"w-{i}", "dataset": dict(_DS, tag_list=[f"x{i}", f"y{i}"])} for i in range(3)]
    fleet = {"canary": {"window_s": 1.0, "poll_s": 0.05, "min_requests": 1}, "schedules": {"refit_every": "6h"}}
    if gameday_gate is not None:
        fleet["gameday"] = {"gate": list(gameday_gate)}
    return {"machines": machines, "globals": {"model": copy.deepcopy(_MODEL)}, "fleet": fleet}


@pytest.fixture
def jax_default(monkeypatch):
    """The port's default model swapped for the JAX package's."""
    monkeypatch.setattr(port_config, "DEFAULT_MODEL_CONFIG", copy.deepcopy(jax_config.DEFAULT_MODEL_CONFIG))


def fleet_yaml():
    with open(FLEET_YAML) as f:
        text = f.read()
    return safe_load(text), yaml.safe_load(text)


# ---------------------------------------------------------------------- #
# content keys and the DAG
# ---------------------------------------------------------------------- #


def _random_value(rng, depth=0):
    kind = int(rng.integers(0, 9 if depth < 3 else 6))
    if kind == 0:
        return int(rng.integers(-1000, 1000))
    if kind == 1:
        return float(np.round(rng.normal() * 100, int(rng.integers(0, 6))))
    if kind == 2:
        return "".join(rng.choice(list("abc-_ <&'é\"\\"), size=int(rng.integers(0, 8))))
    if kind == 3:
        return [None, True, False][int(rng.integers(3))]
    if kind == 4:
        tz = [None, datetime.timezone.utc, datetime.timezone(datetime.timedelta(hours=-5, minutes=-30))]
        return datetime.datetime(2017, 12, 25, int(rng.integers(24)), int(rng.integers(60)), 0,
                                 int(rng.integers(0, 2)) * 500000, tzinfo=tz[int(rng.integers(3))])
    if kind == 5:
        return datetime.date(2020, 1, int(rng.integers(1, 29)))
    if kind == 6:
        return [_random_value(rng, depth + 1) for _ in range(int(rng.integers(0, 4)))]
    return {f"k{int(rng.integers(10))}": _random_value(rng, depth + 1) for _ in range(int(rng.integers(0, 4)))}


@pytest.mark.parametrize("seed", range(3))
def test_content_key_matches_jax_over_seeded_payloads(seed):
    rng = np.random.default_rng(seed)
    for _ in range(100):
        payload = _random_value(rng)
        deps = [f"{int(rng.integers(1 << 30)):x}" for _ in range(int(rng.integers(0, 4)))]
        assert port_dag.content_key(payload, deps) == jax_dag.content_key(payload, deps)


def test_yaml_timestamps_render_as_pyyaml_ones_in_keys():
    """``default=str`` renders a non-JSON value: an unquoted timestamp must
    come out of the port's YAML reader with PyYAML's ``str()``."""
    text = ("a: 2017-12-25 06:00:00Z\nb: 2020-01-01T00:00:00.25+01:30\nc: 2020-01-01\n"
            "d: 2020-01-01 10:11:12\ne: 2001-12-14t21:59:43.10-05:00\n")
    got, want = safe_load(text), yaml.safe_load(text)
    assert {k: str(v) for k, v in got.items()} == {k: str(v) for k, v in want.items()}
    assert port_dag.content_key(got) == jax_dag.content_key(want)


def test_fleet_dag_through_json_both_ways():
    for spec in (fleet_spec(), fleet_spec(gameday_gate=["replica_crash_restart"])):
        jax = jax_compiler.compile_fleet(copy.deepcopy(spec), "p")
        port = port_compiler.compile_fleet(copy.deepcopy(spec), "p")
        assert port.to_json() == jax.to_json()
        from_jax = port_dag.FleetDAG.from_dict(json.loads(jax.to_json()))
        from_port = jax_dag.FleetDAG.from_dict(json.loads(port.to_json()))
        assert from_jax.to_json() == from_port.to_json() == jax.to_json()
        assert from_jax.to_json(indent=None) == jax.to_json(indent=None)
        assert [s.step_id for s in from_jax.order()] == [s.step_id for s in jax.order()]
        assert from_jax.keys() == jax.keys() and from_jax.counts() == jax.counts()
        prior = {k: (v if i % 3 else "stale") for i, (k, v) in enumerate(sorted(jax.keys().items()))}
        assert from_jax.stale_steps(prior) == jax.stale_steps(prior)


def _dag_error(module, steps):
    try:
        module.FleetDAG([module.Step(*a, **kw) for a, kw in steps])
    except ValueError as exc:
        return str(exc)
    return None


@pytest.mark.parametrize("case", ["duplicate", "unknown dep", "cycle", "unknown kind"])
def test_dag_errors_match_jax(case):
    k = jax_dag.content_key({})
    steps = {
        "duplicate": [(("a", "build", k), {}), (("a", "build", k), {})],
        "unknown dep": [(("a", "bucket", k), {"deps": ("ghost",)})],
        "cycle": [(("a", "build", k), {"deps": ("b",)}), (("b", "bucket", k), {"deps": ("a",)})],
        "unknown kind": [(("a", "deploy", k), {})],
    }[case]
    want = _dag_error(jax_dag, steps)
    assert want is not None and _dag_error(port_dag, steps) == want
    with pytest.raises(ValueError) as exc:
        port_dag.FleetDAG.from_dict({"schema": "other"})
    with pytest.raises(ValueError) as jexc:
        jax_dag.FleetDAG.from_dict({"schema": "other"})
    assert str(exc.value) == str(jexc.value)


@pytest.mark.parametrize("seed", range(3))
def test_schedule_gangs_matches_jax(seed):
    rng = np.random.default_rng(40 + seed)
    dicts = []
    for i in range(int(rng.integers(1, 40))):
        key = "tag_list" if rng.random() < 0.7 else "tags"
        dicts.append({"name": f"m{i}", "dataset": {key: [f"t{j}" for j in range(int(rng.integers(0, 5)))]},
                      "model": {"x": {}}})
    port_m = [port_config.Machine(**copy.deepcopy(d)) for d in dicts]
    jax_m = [jax_config.Machine(**copy.deepcopy(d)) for d in dicts]
    for models, devices in ((1024, 8), (3, 1), (1, 4)):
        got = port_scheduler.schedule_gangs(port_m, models, devices)
        want = jax_scheduler.schedule_gangs(jax_m, models, devices)
        assert [(g.gang_id, g.machine_names(), g.n_features, g.devices, g.to_manifest_payload()) for g in got] == [
            (g.gang_id, g.machine_names(), g.n_features, g.devices, g.to_manifest_payload()) for g in want]
    for bad in ((0, 1), (1, 0)):
        with pytest.raises(ValueError, match="must be >= 1"):
            port_scheduler.schedule_gangs(port_m, *bad)


# ---------------------------------------------------------------------- #
# the canary judge
# ---------------------------------------------------------------------- #


def _from_spec(module, spec, use_env=True):
    try:
        return module.CanaryConfig.from_spec(spec, use_env=use_env).describe()
    except ValueError as exc:
        return f"ValueError: {exc}"


@pytest.mark.parametrize("seed", range(3))
def test_canary_config_from_spec_and_env_matches_jax(seed, monkeypatch):
    rng = np.random.default_rng(60 + seed)
    values = {"traffic_slice": (0.1, 0.25, 1.0, 1.5, 0.0), "window_s": (0, 30, -1), "poll_s": (0.05, 1.0, 0),
              "min_requests": (1, 10, 0), "min_samples": (1, 3, 0), "burn_polls": (1, 2, 0),
              "fast_burn_threshold": (14.4, 2.0, 0), "max_goodput_drop": (0.05, 0.5),
              "max_success_drop": (0.02, 0.1)}
    for _ in range(40):
        spec = {k: v[int(rng.integers(len(v)))] for k, v in values.items() if rng.random() < 0.3}
        if rng.random() < 0.1:
            spec["windw_s"] = 9
        for k, env in CANARY_ENV.items():
            if rng.random() < 0.2:
                monkeypatch.setenv(env, str(values[k][int(rng.integers(len(values[k])))]))
            else:
                monkeypatch.delenv(env, raising=False)
        if rng.random() < 0.05:
            monkeypatch.setenv("GORDO_FLEET_FAST_BURN", "fast")
        for use_env in (True, False):
            assert _from_spec(port_canary, spec, use_env) == _from_spec(jax_canary, spec, use_env), spec
    assert _from_spec(port_canary, None) == _from_spec(jax_canary, None)


def _signals(module, rng, n):
    return [module.CanarySignal(*(float(np.round(x, 2)) for x in rng.random(4) * [100, 100, 50, 60]))
            for _ in range(n)]


@pytest.mark.parametrize("seed", range(3))
def test_canary_judges_match_jax_over_seeded_signals(seed):
    rng = np.random.default_rng(80 + seed)
    for _ in range(60):
        spec = {"min_requests": int(rng.integers(1, 30)), "min_samples": int(rng.integers(1, 4)),
                "burn_polls": int(rng.integers(1, 3)), "max_goodput_drop": float(rng.choice([0.0, 0.05, 0.5])),
                "max_success_drop": float(rng.choice([0.0, 0.02, 0.5]))}
        state = rng.bit_generator.state
        verdicts = []
        for module in (port_canary, jax_canary):
            rng.bit_generator.state = state
            cfg = module.CanaryConfig.from_spec(spec, use_env=False)
            incumbent, window = _signals(module, rng, 2)
            if rng.random() < 0.2:
                window = module.CanarySignal()
            burning = str(rng.choice(["availability", "p99_latency_ms"])) if rng.random() < 0.3 else None
            history = module.CanaryHistory(module.signal_delta(window, incumbent))
            for i, sig in enumerate(_signals(module, rng, int(rng.integers(0, 5)))):
                history.add(float(i), sig, burning if rng.random() < 0.6 else None)
            snap = {"requests": {"goodput": float(rng.integers(0, 50)), "wasted": float(rng.integers(0, 5))},
                    "wall": {"goodput_s": float(rng.random()), "wasted_s": float(rng.random())}}
            slo = {"enabled": bool(rng.random() < 0.8), "objectives": [
                {"name": "availability", "fast_burn": bool(rng.random() < 0.4)},
                {"name": "goodput_ratio", "fast_burn": bool(rng.random() < 0.4)}]}
            verdicts.append((
                module.judge_canary(incumbent, window, cfg, burning).to_dict(),
                module.judge_canary_window(incumbent, history, cfg).to_dict(),
                history.describe(), history.consecutive_burning(), history.window_delta(),
                module.CanarySignal.from_goodput_snapshot(snap), module.CanarySignal.from_goodput_snapshot(None),
                module.slo_fast_burn(slo), module.slo_fast_burn(None),
                module.signal_delta(incumbent, window), incumbent.success_ratio(), window.goodput_ratio(),
            ))
        port, jax = verdicts
        assert port[:4] == jax[:4]
        assert [dataclass_tuple(x) for x in port[4:]] == [dataclass_tuple(x) for x in jax[4:]]


def dataclass_tuple(x):
    return tuple(vars(x).values()) if hasattr(x, "__dataclass_fields__") else x


def test_the_canary_fault_point_is_registered():
    assert "workflow.canary" in port_resilience.registered_sites()
    assert port_canary._FP_CANARY.site == "workflow.canary"
    assert (port_canary.PROMOTE, port_canary.ROLLBACK, port_canary.NO_SIGNAL) == (
        jax_canary.PROMOTE, jax_canary.ROLLBACK, jax_canary.NO_SIGNAL)


# ---------------------------------------------------------------------- #
# the compiler
# ---------------------------------------------------------------------- #


def test_compile_of_the_golden_spec_is_the_golden_file():
    doc = port_compiler.compile_fleet(fleet_spec(), "golden").to_json()
    with open(GOLDEN) as f:
        assert doc + "\n" == f.read()
    assert doc == jax_compiler.compile_fleet(fleet_spec(), "golden").to_json()
    for overrides in ({"models_per_bucket": 2}, {"devices_per_gang": 4}, {"models_per_gang": 3}):
        assert (port_compiler.compile_fleet(fleet_spec(), "g", **overrides).to_json()
                == jax_compiler.compile_fleet(fleet_spec(), "g", **overrides).to_json())


def test_compile_of_the_example_fleet_matches_jax_with_the_default_swapped(jax_default):
    port_spec, jax_spec = fleet_yaml()
    got = port_compiler.compile_fleet(port_spec, "demo").to_json()
    assert got == jax_compiler.compile_fleet(jax_spec, "demo").to_json()
    assert json.loads(got)["counts"] == {"bucket": 2, "build": 3, "canary": 1, "place": 1, "promote": 1}


def test_the_default_model_is_the_one_divergence():
    """Without the swap, the machines that leave their model to the default
    carry the port's classes, so their build keys and every key downstream
    differ; their payloads are JAX's with the default renamed."""
    port_spec, jax_spec = fleet_yaml()
    port = json.loads(port_compiler.compile_fleet(port_spec, "demo").to_json())
    jax = json.loads(jax_compiler.compile_fleet(jax_spec, "demo").to_json())
    port_steps = {s["id"]: s for s in port["steps"]}
    jax_steps = {s["id"]: s for s in jax["steps"]}
    assert list(port_steps) == list(jax_steps)
    differ = sorted(sid for sid in port_steps if port_steps[sid]["key"] != jax_steps[sid]["key"])
    defaulted = sorted(f"build/{m['name']}" for m in jax_spec["machines"] if "model" not in m)
    assert defaulted == ["build/compressor-a", "build/compressor-b"]
    bucket = next(s["id"] for s in jax["steps"] if s["kind"] == "bucket" and "build/compressor-a" in s["deps"])
    assert differ == sorted([*defaulted, bucket, "canary/fleet", "place/fleet", "promote/fleet"])
    for sid, step in jax_steps.items():
        want = copy.deepcopy(step["payload"])
        if sid in defaulted:
            assert want["machine"]["model"] == jax_config.DEFAULT_MODEL_CONFIG
            want["machine"]["model"] = port_config.DEFAULT_MODEL_CONFIG
        assert port_steps[sid]["payload"] == want, sid
    assert port["meta"] == jax["meta"]


def _bad(mutate):
    spec = fleet_spec()
    mutate(spec)
    return spec


def _set(path, value):
    def mutate(spec):
        node = spec
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return mutate


BAD_SPECS = {
    "unknown fleet key": _set(("fleet", "canarry"), {}),
    "unknown canary key": _set(("fleet", "canary", "windw_s"), 9),
    "traffic slice": _set(("fleet", "canary", "traffic_slice"), 1.5),
    "negative window": _set(("fleet", "canary", "window_s"), -1),
    "zero poll": _set(("fleet", "canary", "poll_s"), 0),
    "zero min_requests": _set(("fleet", "canary", "min_requests"), 0),
    "zero burn polls": _set(("fleet", "canary", "burn_polls"), 0),
    "zero fast burn": _set(("fleet", "canary", "fast_burn_threshold"), 0),
    "slo windows not strings": _set(("fleet", "slo"), {"windows": [300, 3600]}),
    "slo window grammar": _set(("fleet", "slo"), {"windows": ["5 minutes"]}),
    "slo objective name": _set(("fleet", "slo"), {"objectives": [{"name": "p99_lateny_ms", "target": 100}]}),
    "slo objective ratio": _set(("fleet", "slo"), {"objectives": [{"name": "availability", "target": 2}]}),
    "slo duplicate objective": _set(("fleet", "slo"), {"objectives": [{"name": "availability", "target": 0.9}] * 2}),
    "slo not a mapping": _set(("fleet", "slo"), ["availability"]),
    "slo unknown key": _set(("fleet", "slo"), {"budgets": 1}),
    "refit grammar": _set(("fleet", "schedules"), {"refit_every": "6 fortnights"}),
    "schedules unknown key": _set(("fleet", "schedules"), {"rebuild_every": "6h"}),
    "gate unknown scenario": _set(("fleet", "gameday"), {"gate": ["no_such_drill"]}),
    "gate not gate-capable": _set(("fleet", "gameday"), {"gate": ["watchman_partition"]}),
    "gate empty": _set(("fleet", "gameday"), {"gate": []}),
    "gameday unknown key": _set(("fleet", "gameday"), {"gates": ["replica_crash_restart"]}),
    "fleet not a mapping": _set(("fleet",), ["canary"]),
    "zero replicas": _set(("fleet", "replicas"), 0),
    "replicas of another type": _set(("fleet", "replicas"), [1, 2]),
    "zero bucket width": _set(("fleet", "models_per_bucket"), 0),
    "duplicate machine": lambda s: s["machines"].append(copy.deepcopy(s["machines"][0])),
    "no machines": lambda s: s.pop("machines"),
}


def _compile_error(module, spec, **overrides):
    try:
        module.compile_fleet(copy.deepcopy(spec), "p", **overrides)
    except ValueError as exc:
        return str(exc)
    return None


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_compile_errors_match_jax(case):
    spec = _bad(BAD_SPECS[case])
    want = _compile_error(jax_compiler, spec)
    assert want is not None
    assert _compile_error(port_compiler, spec) == want


def test_unknown_compile_override_matches_jax():
    want = _compile_error(jax_compiler, fleet_spec(), models_per_shard=2)
    assert want == _compile_error(port_compiler, fleet_spec(), models_per_shard=2) == (
        "unknown compile override(s) ['models_per_shard']")


# ---------------------------------------------------------------------- #
# the generator
# ---------------------------------------------------------------------- #


def _generate(module, config_module, spec, **overrides):
    try:
        return module.generate_workflow(config_module.NormalizedConfig(copy.deepcopy(spec)), "proj", **overrides)
    except ValueError as exc:
        return f"ValueError: {exc}"


def test_generate_matches_jax_for_the_golden_spec():
    got = _generate(port_generator, port_config, fleet_spec())
    assert got == _generate(jax_generator, jax_config, fleet_spec())
    assert got.count("kind: Job") == 2 and got.endswith("\n")
    spec = fleet_spec()
    spec["globals"]["runtime"] = {"load_workers": 4, "namespace": "ns-x", "models_per_gang": 3}
    spec["fleet"]["slo"] = {"objectives": [{"name": "availability", "target": 0.999},
                                           {"name": "p99_latency_ms", "target": 50, "quantile": 0.95}],
                            "windows": ["1h", "5m"]}
    for overrides in ({}, {"models_per_gang": 2, "devices_per_gang": 4}, {"server_devices": 2, "namespace": "n"}):
        got = _generate(port_generator, port_config, spec, **overrides)
        assert got == _generate(jax_generator, jax_config, spec, **overrides), overrides
        assert "GORDO_SLO_OBJECTIVES" in got and 'value: "4"' in got


def test_generate_matches_jax_for_the_example_fleet(jax_default):
    port_spec, jax_spec = fleet_yaml()
    got = port_generator.generate_workflow(port_config.NormalizedConfig(port_spec), "demo")
    assert got == jax_generator.generate_workflow(jax_config.NormalizedConfig(jax_spec), "demo")
    assert "GORDO_SLO_OBJECTIVES" in got


def test_generate_matches_jax_for_a_dag_through_json():
    spec = fleet_spec()
    spec["globals"]["runtime"] = {"load_mode": "thread", "builder_retries": 5}
    dag = jax_compiler.compile_fleet(spec, "p")
    doc = json.loads(dag.to_json())
    got = port_generator.generate_workflow(port_dag.FleetDAG.from_dict(doc), "p")
    assert got == jax_generator.generate_workflow(jax_dag.FleetDAG.from_dict(doc), "p")
    assert got == port_generator.generate_workflow(port_config.NormalizedConfig(spec), "p")


def test_generate_escapes_an_objective_name_as_tojson_does():
    """An objective the compiler would refuse, set straight into a DAG's
    meta: its name's ``<``, ``&`` and ``'`` come out as jinja2's ``tojson``
    escapes them."""
    doc = json.loads(jax_compiler.compile_fleet(fleet_spec(), "p").to_json())
    doc["meta"]["fleet"]["slo_objectives"] = [{"name": "a<b>&c'd\"e", "target": 0.5, "budget": 0.5}]
    doc["meta"]["fleet"]["slo_windows"] = [["5m", 300.0]]
    got = port_generator.generate_workflow(port_dag.FleetDAG.from_dict(doc), "p")
    assert got == jax_generator.generate_workflow(jax_dag.FleetDAG.from_dict(doc), "p")
    assert "\\u003c" in got and "\\u0026" in got and "\\u0027" in got and "\\u003e" in got


GENERATE_ERRORS = {
    "load_mode": {"load_mode": "fork"},
    "load_workers": {"load_workers": "many"},
    "server_devices": {"server_devices": "eight"},
}


@pytest.mark.parametrize("case", sorted(GENERATE_ERRORS))
def test_generate_knob_errors_match_jax(case):
    want = _generate(jax_generator, jax_config, fleet_spec(), **GENERATE_ERRORS[case])
    assert want.startswith("ValueError: ")
    assert _generate(port_generator, port_config, fleet_spec(), **GENERATE_ERRORS[case]) == want
    spec = fleet_spec()
    spec["globals"]["runtime"] = GENERATE_ERRORS[case]
    assert _generate(port_generator, port_config, spec) == _generate(jax_generator, jax_config, spec)


def test_generate_override_of_a_compiled_dag_matches_jax():
    doc = json.loads(jax_compiler.compile_fleet(fleet_spec(), "p").to_json())
    errors = []
    for module in (port_dag, jax_dag):
        gen = port_generator if module is port_dag else jax_generator
        with pytest.raises(ValueError) as exc:
            gen.generate_workflow(module.FleetDAG.from_dict(doc), "p", models_per_gang=2)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]
    assert port_generator.DEFAULTS == jax_generator.DEFAULTS


def test_the_template_is_the_jax_template():
    with open(os.path.join(os.path.dirname(port_generator.__file__), "templates", "tpu-workflow.yaml.j2"), "rb") as f:
        ours = f.read()
    with open(os.path.join(os.path.dirname(jax_generator.__file__), "templates", "tpu-workflow.yaml.j2"), "rb") as f:
        assert ours == f.read()


TEMPLATES = {
    "text only": "a\n b \n",
    "names and attributes": "{{ a }}-{{ d.k }}-{{ o.real }}\n",
    "whitespace control": "x  \n{%- if t %}\n  y\n{%- endif %}\nz {{- a -}} \n w\n",
    "for and if": "{% for g in gs %}\n- {{ g.id }}{% if g.on %} on{% endif %}{% if f %}never{% endif %}\n{% endfor %}\n",
    "filters": "{{ gs | length }} {{ s | indent(4) }} {{ s | indent(2, true) }} {{ v | tojson }} {{ n | tojson }}",
    "comment": "a{# hidden #}b{#- x -#}  c",
    "no trailing newline": "{{ a }}",
    "none and numbers": "{{ none }} {{ f }} {{ big }} {{ flt }}",
}
CONTEXT = {"a": "A", "d": {"k": 3}, "o": 2 + 3j, "t": True, "f": False, "none": None, "big": 10 ** 20,
           "flt": 0.1, "gs": [{"id": "g1", "on": True}, {"id": "g2", "on": False}],
           "s": "one\ntwo\n\nthree", "v": ["<a>", "b&'c", {"z": 1, "a": None}], "n": 1.5}


@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_the_template_subset_renders_as_jinja2(name):
    env = jinja2.Environment(undefined=jinja2.StrictUndefined, keep_trailing_newline=True)
    want = env.from_string(TEMPLATES[name]).render(**CONTEXT)
    assert template_subset.render(TEMPLATES[name], **CONTEXT) == want


def test_the_template_subset_is_strict():
    with pytest.raises(template_subset.UndefinedError):
        template_subset.render("{{ missing }}")
    with pytest.raises(template_subset.UndefinedError):
        template_subset.render("{{ d.missing }}", d={})
    for source in ("{% macro m() %}{% endmacro %}", "{{ a + 1 }}", "{% for x in xs %}", "{{ a | upper }}",
                   "{% if a %}x{% else %}y{% endif %}", "{{ s | indent(2.5) }}"):
        with pytest.raises(template_subset.TemplateSyntaxError):
            template_subset.Template(source)


# ---------------------------------------------------------------------- #
# the CLI
# ---------------------------------------------------------------------- #


def run_jax(args):
    result = CliRunner().invoke(gordo, args)
    return result.exit_code, result.stdout, result.stderr


def run_port(args, capsys):
    rc = main(args)
    captured = capsys.readouterr()
    return rc, captured.out, captured.err


def _write_spec(tmp_path, spec, name="spec.yaml"):
    path = tmp_path / name
    path.write_text(yaml.safe_dump(spec, sort_keys=False))
    return str(path)


@pytest.mark.parametrize("command", ["compile", "generate"])
def test_workflow_commands_print_the_jax_bytes(command, tmp_path, capsys, jax_default):
    flags = {"compile": ["--models-per-bucket", "2"], "generate": ["--models-per-gang", "2"]}[command]
    for spec in (FLEET_YAML, _write_spec(tmp_path, fleet_spec())):
        for extra in ([], flags):
            args = ["workflow", command, "-f", spec, "-p", "demo", *extra]
            assert run_port(args, capsys) == run_jax(args)
        port_out, jax_out = tmp_path / "port.out", tmp_path / "jax.out"
        rc, out, _ = run_port(["workflow", command, "-f", spec, "-p", "demo", "-o", str(port_out)], capsys)
        assert (rc, out) == (0, f"{port_out}\n")
        assert run_jax(["workflow", command, "-f", spec, "-p", "demo", "-o", str(jax_out)])[:2] == (0, f"{jax_out}\n")
        assert port_out.read_bytes() == jax_out.read_bytes()


def test_workflow_compile_output_file_is_the_golden_file(tmp_path, capsys):
    out = tmp_path / "dag.json"
    rc, _, _ = run_port(["workflow", "compile", "-f", _write_spec(tmp_path, fleet_spec()), "-p", "golden",
                         "-o", str(out)], capsys)
    with open(GOLDEN) as f:
        assert rc == 0 and out.read_text() == f.read()


@pytest.mark.parametrize("command", ["compile", "generate"])
def test_workflow_commands_exit_81_as_jax_does(command, tmp_path, capsys):
    bad_spec = _write_spec(tmp_path, _bad(BAD_SPECS["unknown canary key"]), "bad.yaml")
    not_a_config = tmp_path / "list.yaml"
    not_a_config.write_text("- a\n- b\n")
    for path in (bad_spec, str(not_a_config)):
        args = ["workflow", command, "-f", path, "-p", "p"]
        rc, out, err = run_port(args, capsys)
        assert (rc, out, err) == run_jax(args)
        assert rc == 81 and err.startswith("Invalid ")


def test_workflow_commands_refuse_a_missing_file_with_2(capsys):
    for command in ("compile", "generate"):
        with pytest.raises(SystemExit) as exc:
            main(["workflow", command, "-f", "/no/such/fleet.yaml", "-p", "p"])
        assert exc.value.code == 2 == run_jax(["workflow", command, "-f", "/no/such/fleet.yaml", "-p", "p"])[0]
        capsys.readouterr()
