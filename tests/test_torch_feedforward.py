"""The port's feedforward factories against the Flax ones.

Params are initialised by JAX and carried across by ``convert.py``; the port's
forward must match ``module.apply`` within rtol=1e-5, atol=1e-6 (float32
matrix products accumulate in another order in PyTorch than in XLA).
"""

import jax
import numpy as np
import pytest
import torch

from gordo_components_torch.convert import feedforward_from_flax, feedforward_to_flax
from gordo_components_torch.models import lookup_factory as port_lookup
from gordo_components_torch.models.factories import feedforward as port_ff
from gordo_components_tpu.models.factories import feedforward as jax_ff
from gordo_components_tpu.models.register import lookup_factory as jax_lookup

KINDS = {
    "feedforward_model": dict(
        encoding_dim=(16, 8), decoding_dim=(8, 16),
        encoding_func=("relu", "elu"), decoding_func=("sigmoid", "softplus"),
    ),
    "feedforward_symmetric": dict(dims=(12, 6), funcs=("tanh", "relu")),
    "feedforward_hourglass": dict(),
}


@pytest.mark.parametrize(
    "compression_factor, encoding_layers, n_features",
    [(0.5, 3, 10), (0.5, 3, 40), (0.2, 4, 7), (1.0, 2, 5), (0.0, 1, 3), (0.7, 5, 128)],
)
def test_hourglass_calc_dims_matches(compression_factor, encoding_layers, n_features):
    assert port_ff.hourglass_calc_dims(
        compression_factor, encoding_layers, n_features
    ) == jax_ff.hourglass_calc_dims(compression_factor, encoding_layers, n_features)


def test_hourglass_reference_width_has_417_params():
    model = port_ff.feedforward_hourglass(10)
    assert port_ff.hourglass_calc_dims(0.5, 3, 10) == (8, 7, 5)
    assert sum(p.numel() for p in model.parameters()) == 417


@pytest.mark.parametrize("n_features", [10, 40])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_forward_matches_flax_apply(kind, n_features):
    module = jax_lookup("AutoEncoder", kind)(n_features, **KINDS[kind])
    rng = np.random.RandomState(n_features)
    X = rng.randn(37, n_features).astype("float32")
    params = jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(3), X[:1]))
    want = np.asarray(module.apply(params, X))

    model = port_lookup("AutoEncoder", kind)(n_features, **KINDS[kind])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in feedforward_from_flax(params).items()})
    with torch.no_grad():
        got = model(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the artifact layout round-trips exactly
    back = feedforward_to_flax(feedforward_from_flax(params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_unknown_activation_and_kind_raise():
    with pytest.raises(ValueError, match="Unknown activation"):
        port_ff.feedforward_symmetric(4, dims=(2,), funcs=("swish",))
    with pytest.raises(ValueError, match="Unknown kind"):
        port_lookup("AutoEncoder", "lstm_hourglass")
    with pytest.raises(ValueError, match="float32 only"):
        port_ff.feedforward_hourglass(4, compute_dtype="bfloat16")
