"""``into_definition`` of the port against the JAX package's, on the CPU.

Each config resolves in both packages (``from_definition``) and is written
back (``into_definition``). The port's definition equals the JAX
package's with the package name ``gordo_components_tpu`` replaced by
``gordo_components_torch`` and sklearn's private module path
``sklearn.preprocessing._data`` by its public one, and it resolves back in
the port to an object with the same definition.
"""

import json

import pytest

from gordo_components_torch import serializer
from gordo_components_tpu.serializer import definitions as jax_definitions

_DET = "gordo_components_tpu.models.DiffBasedAnomalyDetector"
_AE = "gordo_components_tpu.models.AutoEncoder"
CONFIGS = {
    "estimator": {_AE: {"epochs": 1}},
    "estimator-defaults": _AE,
    "pipeline": {"sklearn.pipeline.Pipeline": {"steps": ["sklearn.preprocessing.MinMaxScaler", _AE]}},
    "named-steps": {"sklearn.pipeline.Pipeline": {"steps": [
        ["scale", "sklearn.preprocessing.StandardScaler"],
        ["model", {_AE: {"kind": "feedforward_symmetric", "dims": [4, 2]}}]]}},
    "scaler-kwargs": {"sklearn.pipeline.Pipeline": {"steps": [
        {"sklearn.preprocessing.MinMaxScaler": {"feature_range": [-1, 1]}}, _AE]}},
    "detector": {_DET: {"base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [
        "sklearn.preprocessing.MinMaxScaler",
        {"gordo_components_tpu.models.LSTMForecast": {"lookback_window": 6, "compute_dtype": "bfloat16"}}]}},
        "threshold_quantile": 0.99}},
    "reference-paths": {"gordo_components.model.anomaly.DiffBasedAnomalyDetector": {"base_estimator": {
        "gordo_components.model.models.KerasLSTMAutoEncoder": {"kind": "lstm_hourglass"}}}},
    "conv": {_DET: {"base_estimator": {"gordo_components_tpu.models.ConvAutoEncoder": {
        "lookback_window": 8, "channels": [4, 2]}}}},
}


def _as_port(definition):
    text = json.dumps(definition, default=list)
    return json.loads(text.replace("gordo_components_tpu.", "gordo_components_torch.")
                      .replace("sklearn.preprocessing._data.", "sklearn.preprocessing."))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_into_definition_matches_jax(name):
    config = CONFIGS[name]
    got = serializer.into_definition(serializer.from_definition(config))
    want = jax_definitions.into_definition(jax_definitions.from_definition(config))
    assert json.loads(json.dumps(got, default=list)) == _as_port(want)
    again = serializer.pipeline_into_definition(serializer.pipeline_from_definition(got))
    assert json.dumps(again, default=list) == json.dumps(got, default=list)


def test_transformer_list_entries_are_named():
    """``transformer_list`` entries are resolved and auto-named as
    ``steps`` are (JAX ``_resolve_value``)."""
    from gordo_components_torch.models.transformers import MinMaxScaler
    from gordo_components_torch.serializer.definitions import _resolve_value

    got = _resolve_value("transformer_list", ["sklearn.preprocessing.MinMaxScaler",
                                              ["mine", "sklearn.preprocessing.MinMaxScaler"]])
    assert [n for n, _ in got] == ["step_0", "mine"]
    assert all(isinstance(obj, MinMaxScaler) for _, obj in got)
