"""The port's ``NormalizedConfig`` against the JAX package's, on the CPU.

The same inputs (YAML strings, mappings and files) give the same machines
(compared as ``to_dict()``, with the default model config written in each
package's own class paths), the same ``runtime`` and the same ``raw``; a
duplicate name and a missing ``machines`` list raise ``ValueError`` in
both.
"""

import copy
import json
import os

import pytest
import yaml

from gordo_components_torch.workflow import DEFAULT_MODEL_CONFIG, Machine, NormalizedConfig
from gordo_components_torch.workflow.config import _deep_merge
from gordo_components_tpu.workflow.config import DEFAULT_MODEL_CONFIG as JAX_DEFAULT_MODEL
from gordo_components_tpu.workflow.config import NormalizedConfig as JaxNormalizedConfig
from gordo_components_tpu.workflow.config import _deep_merge as jax_deep_merge
from test_torch_yaml import REPO_TEXTS, same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_dicts(config):
    """The JAX machines as dicts, its default model written as the port's."""
    out = []
    for m in config.machines:
        d = copy.deepcopy(m.to_dict())
        if d["model"] == JAX_DEFAULT_MODEL:
            d["model"] = copy.deepcopy(DEFAULT_MODEL_CONFIG)
        out.append(d)
    return out


def assert_same_config(got, want):
    assert same([m.to_dict() for m in got.machines], _jax_dicts(want))
    assert same(got.runtime, want.runtime)
    assert same(got.raw, want.raw)


# the globals case of tests/test_fleet_cv.py (TestEvaluationPlumbing)
GLOBALS_EVALUATION = {
    "machines": [
        {"name": "m-a", "dataset": {}},
        {"name": "m-b", "dataset": {}, "evaluation": {"n_splits": 5}},
    ],
    "globals": {"evaluation": {"cross_validation": True, "n_splits": 3}},
}
MAPPINGS = {
    "globals evaluation": GLOBALS_EVALUATION,
    "bare names": {"machines": ["m1", {"name": "m2", "dataset": {"tags": ["a"]}}]},
    "globals everywhere": {
        "machines": [
            {"name": "m1", "dataset": {"tags": ["a", "b"], "resolution": "1h"}, "metadata": {"k": {"x": 1}}},
            {"name": "m2", "model": {"gordo_components_tpu.models.AutoEncoder": {}}, "dataset": None,
             "metadata": None, "evaluation": None},
        ],
        "globals": {
            "model": {"gordo_components_tpu.models.AutoEncoder": {"kind": "feedforward_symmetric"}},
            "dataset": {"resolution": "10min", "type": "RandomDataset"},
            "metadata": {"owner": "x", "k": {"y": 2}},
            "evaluation": {"cv_mode": "cross_val_only"},
            "runtime": {"models_per_gang": 64},
        },
        "fleet": {"canary": {"window_s": 30}},
    },
    "empty globals": {"machines": [{"name": "m1"}], "globals": None},
}


# the repo's YAML that holds a machines list (docs/configs.md's other blocks
# are snippets of a fleet file)
FLEET_TEXTS = sorted(n for n, t in REPO_TEXTS.items() if "machines" in (yaml.safe_load(t) or {}))


@pytest.mark.parametrize("name", FLEET_TEXTS)
def test_normalized_config_of_repo_yaml_matches_jax(name):
    text = REPO_TEXTS[name]
    assert_same_config(NormalizedConfig(text), JaxNormalizedConfig(text))


@pytest.mark.parametrize("name", sorted(MAPPINGS))
def test_normalized_config_of_mappings_matches_jax(name):
    got = NormalizedConfig(copy.deepcopy(MAPPINGS[name]))
    assert_same_config(got, JaxNormalizedConfig(copy.deepcopy(MAPPINGS[name])))
    # the same config written as YAML reads the same
    text = yaml.safe_dump(MAPPINGS[name])
    assert_same_config(NormalizedConfig(text), JaxNormalizedConfig(text))


def test_globals_evaluation_merges_into_every_machine():
    by_name = {m.name: m for m in NormalizedConfig(copy.deepcopy(GLOBALS_EVALUATION)).machines}
    assert by_name["m-a"].evaluation == {"cross_validation": True, "n_splits": 3}
    assert by_name["m-b"].evaluation == {"cross_validation": True, "n_splits": 5}


def test_fleet_yaml_keeps_its_fleet_block_and_runtime():
    config = NormalizedConfig.from_yaml_file(os.path.join(REPO, "examples", "fleet.yaml"))
    want = JaxNormalizedConfig.from_yaml_file(os.path.join(REPO, "examples", "fleet.yaml"))
    assert_same_config(config, want)
    assert config.raw["fleet"]["canary"]["traffic_slice"] == 0.25
    assert config.runtime == {"models_per_gang": 1024, "devices_per_gang": 8}
    assert [m.name for m in config.machines] == ["compressor-a", "compressor-b", "turbine-lstm"]
    assert config.machines[0].model == DEFAULT_MODEL_CONFIG


def test_from_yaml_file_reads_json_too(tmp_path):
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps(MAPPINGS["globals everywhere"]))
    assert_same_config(NormalizedConfig.from_yaml_file(str(path)),
                       JaxNormalizedConfig.from_yaml_file(str(path)))


BAD = {
    "duplicate names": {"machines": [{"name": "m"}, {"name": "m"}]},
    "no machines": {"globals": {}},
    "not a mapping": ["m1"],
    "yaml without machines": "globals: {}\n",
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_bad_configs_raise_in_both(name):
    with pytest.raises(ValueError) as jax_err:
        JaxNormalizedConfig(copy.deepcopy(BAD[name]))
    with pytest.raises(ValueError) as port_err:
        NormalizedConfig(copy.deepcopy(BAD[name]))
    assert str(port_err.value) == str(jax_err.value)


def test_deep_merge_matches_jax():
    base = {"a": {"b": 1, "c": [1]}, "d": 2}
    override = {"a": {"c": [2], "e": {"f": 3}}, "d": {"g": 4}}
    assert _deep_merge(base, override) == jax_deep_merge(base, override)
    assert base == {"a": {"b": 1, "c": [1]}, "d": 2}  # inputs untouched


def test_machine_from_dict_unchanged():
    m = Machine.from_dict({"name": "m", "dataset": {"tags": ["a"]}})
    assert m.dataset == {"tag_list": ["a"]} and m.model == DEFAULT_MODEL_CONFIG
