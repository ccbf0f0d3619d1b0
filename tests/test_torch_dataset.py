"""The port's datasets (numpy only) against the JAX package's (pandas), on
the CPU: the same values bitwise, the same index and tag names."""

import numpy as np
import pandas as pd
import pytest

from gordo_components_torch.dataset import RandomDataset, get_dataset, normalize_sensor_tags
from gordo_components_torch.dataset.data_provider.base import Series
from gordo_components_torch.dataset.resample import fused_agg_join
from gordo_components_torch.dataset.times import resolution_ns, to_ns
from gordo_components_torch.utils.staging import stage_members
from gordo_components_tpu.dataset import RandomDataset as JaxRandomDataset
from gordo_components_tpu.dataset import get_dataset as jax_get_dataset
from gordo_components_tpu.dataset import normalize_sensor_tags as jax_normalize
from gordo_components_tpu.dataset.resample import fused_agg_join as jax_fused

# the three machines of examples/fleet.yaml, as dicts
FLEET_YAML_DATASETS = {
    "compressor-a": ["ca-pressure", "ca-temperature", "ca-rpm"],
    "compressor-b": ["cb-pressure", "cb-temperature", "cb-rpm"],
    "turbine-lstm": ["tl-vibration", "tl-load"],
}


def _config(tags, **kw):
    return {"type": "RandomDataset", "train_start_date": "2020-01-01T00:00:00Z",
            "train_end_date": "2020-01-08T00:00:00Z", "tag_list": tags, **kw}


def _index_ns(index: pd.DatetimeIndex) -> np.ndarray:
    return index.tz_convert(None).values.astype("datetime64[ns]")


@pytest.mark.parametrize("machine", sorted(FLEET_YAML_DATASETS))
def test_random_dataset_matches_jax(machine):
    config = _config(FLEET_YAML_DATASETS[machine])
    ours, theirs = get_dataset(config), jax_get_dataset(config)
    X, y = ours.get_data()
    JX, Jy = theirs.get_data()
    assert y is None and Jy is None
    assert X.values.dtype == np.float32 and X.values.shape == JX.shape == (1008, len(X.columns))
    np.testing.assert_array_equal(X.values, JX.values)
    np.testing.assert_array_equal(X.index, _index_ns(JX.index))
    assert X.columns == list(JX.columns)
    got, want = ours.get_metadata(), theirs.get_metadata()
    assert got.keys() == want.keys()
    for k in want:
        if k != "data_provider":
            assert got[k] == want[k], k
    assert got["data_provider"]["type"].endswith(".RandomDataProvider")


def test_targets_seed_and_dates():
    kw = dict(train_start_date="2017-12-25 06:00:00Z", train_end_date="2017-12-25 18:00:00",
              tag_list=["a", "b"], target_tag_list=["b", "c"], seed=3, resolution="10T")
    X, y = RandomDataset(**kw).get_data()
    JX, Jy = JaxRandomDataset(**kw).get_data()
    np.testing.assert_array_equal(X.values, JX.values)
    np.testing.assert_array_equal(y.values, Jy.values)
    assert y.columns == ["b", "c"]
    assert not np.array_equal(X.values, RandomDataset(**dict(kw, seed=4)).get_data()[0].values)
    assert to_ns("2020-01-01T01:00:00+01:00") == to_ns("2020-01-01T00:00:00Z") == to_ns("2020-01-01")
    assert resolution_ns("10T") == resolution_ns("10min") == 600 * 10**9
    with pytest.raises(NotImplementedError, match="row_filter"):
        RandomDataset(row_filter="`a` > 0")
    with pytest.raises(ValueError, match="precede"):
        RandomDataset(train_start_date="2020-01-02", train_end_date="2020-01-01")


@pytest.mark.parametrize("agg", ["mean", "sum", "min", "max"])
def test_fused_agg_join_matches_jax(agg):
    rng = np.random.RandomState(0)
    start = pd.Timestamp("2020-01-01T00:00:00Z")
    end = pd.Timestamp("2020-01-01T06:00:00Z")
    series = []
    for i, (lo, hi, n) in enumerate([(-30, 200, 300), (60, 400, 97), (500, 600, 5), (0, 0, 0)]):
        ts = np.sort(rng.randint(lo * 60, max(hi, lo + 1) * 60, n)) if n else np.array([], int)
        values = rng.randn(n).astype("f4")
        values[::7] = np.nan
        idx = pd.DatetimeIndex(start + pd.to_timedelta(ts, "s"))
        series.append(pd.Series(values, index=idx, name=f"t{i}"))
    want_df, want_meta = jax_fused(series, start, end, "10min", agg)
    index, cols, meta = fused_agg_join(
        [Series(s.name, s.index.as_unit("ns").asi8, s.values) for s in series],
        to_ns("2020-01-01T00:00:00Z"), to_ns("2020-01-01T06:00:00Z"), resolution_ns("10min"), agg)
    np.testing.assert_array_equal(index.astype("datetime64[ns]"), _index_ns(want_df.index))
    for name in want_df.columns:
        np.testing.assert_array_equal(cols[name], want_df[name].values)
        assert cols[name].dtype == want_df[name].dtype
    assert meta == want_meta
    with pytest.raises(NotImplementedError, match="aggregation"):
        fused_agg_join([], 0, 1, 60, "median")
    with pytest.raises(NotImplementedError, match="divide one day"):
        fused_agg_join([], 0, 1, resolution_ns("7min"), "mean")


def test_sensor_tags_and_staging(monkeypatch):
    specs = ["a", ["b", "asset-1"], {"name": "c", "asset": "asset-2"}, ("d",)]
    assert [tuple(t) for t in normalize_sensor_tags(specs, "x")] == [
        tuple(t) for t in jax_normalize(specs, "x")]
    configs = [_config([f"s{i}-a", f"s{i}-b"]) for i in range(5)]
    staged = stage_members(configs, workers=3)
    for config, (X, meta) in zip(configs, staged):
        assert X.columns == config["tag_list"]
        np.testing.assert_array_equal(X.values, get_dataset(config).get_data()[0].values)
        assert meta["rows_after_dropna"] == 1008
    monkeypatch.setenv("GORDO_LOAD_MODE", "process")
    with pytest.raises(NotImplementedError, match="process"):
        stage_members(configs)
