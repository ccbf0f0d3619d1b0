"""Variational feedforward autoencoder factory.

Counterpart of ``gordo_components_tpu/models/factories/variational.py``
(``BASELINE.json`` config 4): a dense encoder to a latent mean ``mu`` and
log-variance ``logvar``, a dense decoder back to ``n_features``. The
forward decodes ``mu`` (the deterministic reconstruction that scores);
training adds the KL term through :meth:`VariationalAutoEncoder.elbo_terms`,
whose reparameterization noise is an explicit argument (the train core
draws it from each member's own generator). The module computes in
``compute_dtype`` (JAX ``variational.py:29-60``): in bfloat16 every layer,
``mu``, ``logvar``, the latent sample and the KL term round as Flax's do,
and the reconstruction and KL come back in float32.

Parameters keep Flax's names and layout: ``enc_i``, ``mu``, ``logvar``,
``dec_j`` and ``out``, each a ``kernel`` (in, out) and a ``bias`` (out,).
"""

from typing import Callable, List, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from gordo_components_torch.device import resolve_compute_dtype
from gordo_components_torch.models.register import register_model_builder
from gordo_components_torch.ops.activations import resolve_activation
from gordo_components_torch.ops.dense import dense_chain

_identity = resolve_activation("linear")


class _Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(n_in, n_out))
        self.bias = nn.Parameter(torch.zeros(n_out))


class VariationalAutoEncoder(nn.Module):
    """Rows (N, n_features) -> (N, n_features), decoding the latent mean."""

    family = "vae"  # keys the port's per-family tables (models.register.by_family)
    windowed = False  # the model reads rows

    def __init__(self, n_features: int, dims: Tuple[int, ...], latent_dim: int, func: str,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.n_features = n_features
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.dims = tuple(dims)
        self.latent_dim = int(latent_dim)
        self.func = func
        self.activation = resolve_activation(func)
        enc = [n_features, *self.dims]
        for i, (n_in, n_out) in enumerate(zip(enc[:-1], enc[1:])):
            self.add_module(f"enc_{i}", _Dense(n_in, n_out))
        self.mu = _Dense(enc[-1], self.latent_dim)
        self.logvar = _Dense(enc[-1], self.latent_dim)
        dec = [self.latent_dim, *reversed(self.dims)]
        for j, (n_in, n_out) in enumerate(zip(dec[:-1], dec[1:])):
            self.add_module(f"dec_{j}", _Dense(n_in, n_out))
        self.out = _Dense(dec[-1], n_features)

    def encoder_names(self) -> List[str]:
        return [f"enc_{i}" for i in range(len(self.dims))]

    def decoder_names(self) -> List[str]:
        return [f"dec_{j}" for j in range(len(self.dims))] + ["out"]

    def chains(self, get: Callable[[str], Tuple]) -> Tuple[list, Tuple, Tuple, list]:
        """``(encoder, mu, logvar, decoder)`` as layer lists of ``(kernel,
        bias, activation)``, the arrays of layer ``name`` from ``get(name)``
        -> ``(kernel, bias)``; ``mu`` and ``logvar`` are single layers."""
        enc = [(*get(n), self.activation) for n in self.encoder_names()]
        dec = [(*get(n), self.activation) for n in self.decoder_names()[:-1]]
        dec.append((*get("out"), _identity))
        return enc, (*get("mu"), _identity), (*get("logvar"), _identity), dec

    def serving_chain(self, state: Mapping[str, np.ndarray]) -> list:
        """The mean decode as one dense chain ``enc_i -> mu -> dec_j -> out``
        of ``(kernel (in, out), bias, activation)`` from a state dict;
        ``logvar`` is not read."""
        enc, mu, _logvar, dec = self.chains(lambda n: (state[f"{n}.kernel"], state[f"{n}.bias"]))
        return [*enc, mu, *dec]

    def _member_chains(self):
        return self.chains(lambda n: (getattr(self, n).kernel[None], getattr(self, n).bias[None]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        enc, mu, _logvar, dec = self._member_chains()
        return dense_chain(x[None], [*enc, mu, *dec], self.compute_dtype)[0].float()

    def elbo_terms(self, x: torch.Tensor, noise: torch.Tensor):
        """``(recon, kl)`` of rows ``x`` (N, n_features) with the latent
        ``mu + exp(0.5 * logvar) * noise``, ``noise`` (N, latent_dim)."""
        recon, kl = vae_elbo_terms(self._member_chains(), x[None], noise[None], self.compute_dtype)
        return recon[0], kl[0]


def vae_elbo_terms(chains, x: torch.Tensor, noise: torch.Tensor, dtype: torch.dtype = torch.float32):
    """Stacked ELBO terms computed in ``dtype``: ``x`` (M, B, F) and
    ``noise`` (M, B, latent, cast to ``dtype`` as JAX draws it in
    ``mu.dtype``) -> float32 ``recon`` (M, B, F) decoded from ``z = mu +
    exp(0.5 * logvar) * noise`` and ``kl`` (M, B) ``= -0.5 * sum(1 + logvar
    - mu^2 - exp(logvar))``."""
    enc, mu_layer, logvar_layer, dec = chains
    h = dense_chain(x, enc, dtype)
    mu = dense_chain(h, [mu_layer], dtype)
    logvar = dense_chain(h, [logvar_layer], dtype)
    recon = dense_chain(mu + torch.exp(0.5 * logvar) * noise.to(dtype), dec, dtype)
    kl = -0.5 * torch.sum(1 + logvar - mu**2 - torch.exp(logvar), dim=-1)
    return recon.float(), kl.float()


@register_model_builder(type="AutoEncoder")
def feedforward_variational(
    n_features: int,
    dims: Sequence[int] = (128, 64),
    latent_dim: int = 16,
    func: str = "tanh",
    compute_dtype: str = "float32",
    **_ignored,
) -> VariationalAutoEncoder:
    """Variational dense autoencoder (reference: ``feedforward_variational``)."""
    return VariationalAutoEncoder(n_features, tuple(dims), latent_dim, func, compute_dtype)
