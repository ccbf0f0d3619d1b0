"""Training core: stacked members, explicit state, one forward layout.

Counterpart of ``gordo_components_tpu/models/train_core.py``. Every function
here works on a stack of ``M`` members (``M = 1`` for a single estimator),
so the single fit and the fleet run the same code:

- :class:`StackedDense` holds a dense autoencoder's parameters for all
  members in one flat ``(M, P)`` tensor and runs the forward in the bank's
  layout, one ``torch.baddbmm`` per layer over ``(M, B, .)`` with Flax's
  ``(in, out)`` kernels;
- :class:`StackedLSTM` does the same for an LSTM stack in Flax's
  ``OptimizedLSTMCell`` layout; its items are window starts, gathered from
  the raw rows batch by batch (:func:`gather_window_batch`), and its
  forward is the autograd forward where a gradient is wanted and the fused
  step kernel elsewhere;
- :class:`StackedConv` (the conv autoencoder, windowed items as the LSTM's)
  and :class:`StackedVAE` (the variational autoencoder, rows as items, the
  ELBO loss with explicit reparameterization noise) keep Flax's layout;
  :func:`make_stack` picks the stack by the module's family;
- :func:`make_optimizer` is a stacked functional update with optax's
  formulas and defaults: per-member step counts and learning rates, and a
  per-member skip of the whole update;
- :func:`make_train_fns` gives ``init_fn`` and ``epoch_fn`` over either
  stack. Gradients come from the sum of the per-member masked losses, which
  decouples exactly: each member's loss depends on its own parameter row
  only.

The epoch keeps the reference's semantics (``train_core.py:142-188`` and
the sequence gang epoch ``:284-378``): padding items sort to the end of
every shuffle, a batch that is all padding is an exact no-op for its member
(parameters, moments and step count unchanged), and the epoch loss is
weighted by real items. Nothing inside the batch loop reads a device value
on the host.

Every stack computes in its module's ``compute_dtype`` (float32 or
bfloat16, as the JAX modules do) and returns float32 outputs; the ``(M,
P)`` parameters, their gradients, the stacked optimizer state and the loss
stay float32, as Flax keeps float32 parameters under ``dtype=bfloat16``.

Random draws come from explicit ``torch.Generator`` objects on the CPU, one
per member, seeded from ``(seed, member position)``: a member's
initialization, shuffles and variational noise do not depend on the gang's
width or on its item padding, and the card and the CPU draw the same
numbers. The variational validation loss uses one fixed noise block drawn
from a generator seeded 0 for every batch (:func:`validation_noise`): the
port's own stream, where the JAX package uses one fixed key.
"""

import hashlib
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gordo_components_torch.device import rows_tensor
from gordo_components_torch.models.factories.conv import Conv1DAutoEncoder, conv_autoencoder_forward
from gordo_components_torch.models.factories.variational import VariationalAutoEncoder, vae_elbo_terms
from gordo_components_torch.models.register import by_family
from gordo_components_torch.ops.dense import dense_chain
from gordo_components_torch.ops.losses import mse_loss
from gordo_components_torch.ops.seq_scan import lstm_time_major_forward, lstm_train_forward

# Flax's Dense kernel init, lecun_normal: a normal truncated to two standard
# deviations, rescaled so its variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def member_generator(seed: int, position: int) -> torch.Generator:
    """The random stream of the member at ``position`` of a gang seeded
    with ``seed`` (a CPU generator)."""
    digest = hashlib.sha256(f"{int(seed)}|{int(position)}".encode()).digest()
    return torch.Generator().manual_seed(int.from_bytes(digest[:8], "little"))


def lecun_normal(shape, generator: torch.Generator, receptive_field: int = 1) -> torch.Tensor:
    """Flax's ``lecun_normal`` for a kernel whose fan-in is ``shape[-2] *
    receptive_field``: a dense kernel (in, out) has a receptive field of 1,
    a convolution's kernel (K, F_in, C) one of K (Flax's fan-in ``K *
    F_in``)."""
    std = (1.0 / (shape[-2] * receptive_field)) ** 0.5 / _TRUNC_STD
    return torch.nn.init.trunc_normal_(torch.empty(shape), generator=generator) * std


def gather_window_batch(X, item_idx, lookback: int, target_offset: int, Y=None):
    """``(xb, yb)`` for a batch of window-start items over each member's raw
    rows ``X`` (M, rows, F): ``xb`` (M, B, lookback, F) gathers rows ``[i,
    i + lookback)`` of ``item_idx`` (M, B), ``yb`` (M, B, F) the target row
    ``i + lookback - 1 + target_offset`` of ``Y`` (default ``X``). Indices
    clip into range, so padded items gather rows the caller's item mask must
    zero out (JAX ``gather_window_batch``, ``train_core.py:193-205``)."""
    Y = X if Y is None else Y
    rows = X.shape[1]
    member = torch.arange(X.shape[0], device=X.device)[:, None]
    widx = (item_idx[..., None] + torch.arange(lookback, device=X.device)).clamp(0, rows - 1)
    tidx = (item_idx + (lookback - 1 + target_offset)).clamp(0, rows - 1)
    return X[member[..., None], widx], Y[member, tidx]


def _row_batch(X, Y, idx):
    """The batch of items (rows) ``idx`` (M, B): ``(xb, yb)`` (M, B, F)."""
    xb = torch.take_along_dim(X, idx[..., None], dim=1)
    return xb, xb if Y is X else torch.take_along_dim(Y, idx[..., None], dim=1)


class _NamedStack:
    """Parameters for ``M`` members in one ``(M, P)`` tensor, piece by piece
    in a module's state-dict order and shapes (``shapes``: key -> shape),
    and their conversions to and from per-member state dicts."""

    warmup = 0  # rows before an item's target row
    windowed = False  # items are rows, not window starts

    def _set_shapes(self, shapes: Dict[str, Tuple[int, ...]]) -> None:
        self.shapes = dict(shapes)
        self.sizes = [int(np.prod(s)) for s in self.shapes.values()]
        self.n_params = sum(self.sizes)

    def pieces(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Views ``(M, *shape)`` of every state-dict key."""
        M = flat.shape[0]
        return {k: p.view(M, *shape) for (k, shape), p in
                zip(self.shapes.items(), flat.split(self.sizes, dim=-1))}

    def state_dicts(self, flat: torch.Tensor) -> List[Dict[str, np.ndarray]]:
        """Each member's module state dict, as numpy."""
        pieces = {k: v.detach().cpu().numpy() for k, v in self.pieces(flat).items()}
        return [{k: np.array(v[m]) for k, v in pieces.items()} for m in range(flat.shape[0])]

    def from_state_dicts(self, states: Sequence[Dict[str, np.ndarray]]) -> torch.Tensor:
        """Inverse of :meth:`state_dicts`: ``(M, P)`` on the CPU."""
        rows = []
        for sd in states:
            row = []
            for k, shape in self.shapes.items():
                a = np.asarray(sd[k], np.float32)
                if a.shape != shape:
                    raise ValueError(f"{k}: shape {a.shape}; this architecture wants {shape}")
                row.append(a.reshape(-1))
            rows.append(np.concatenate(row))
        return torch.from_numpy(np.stack(rows))

    def _init_kernels(self, generators: Sequence[torch.Generator]) -> torch.Tensor:
        """Fresh ``(M, P)`` parameters on the CPU, one member per generator,
        as Flax's ``Dense`` and ``Conv`` draw them: ``lecun_normal`` kernels
        (``*.kernel``, the fan-in over their receptive field), zero biases."""
        flat = torch.zeros(len(generators), self.n_params)
        for m, g in enumerate(generators):
            for k, piece in self.pieces(flat[m:m + 1]).items():
                if k.endswith(".kernel"):
                    shape = piece.shape[1:]
                    piece[0] = lecun_normal(shape, g, int(np.prod(shape[:-2])))
        return flat


class StackedDense(_NamedStack):
    """A dense autoencoder's parameters for ``M`` members, and its forward.

    Member ``m``'s parameters are row ``m`` of one ``(M, P)`` tensor: per
    layer the kernel ``(in, out)`` row-major (Flax's layout), then the bias
    ``(out,)``. ``module`` is a
    :class:`~.factories.feedforward.FeedForwardAutoEncoder` giving the layer
    widths and activations; its state dicts hold ``nn.Linear``'s ``(out,
    in)`` weights, which :meth:`state_dicts` and :meth:`from_state_dicts`
    transpose."""

    batch = staticmethod(_row_batch)
    init = _NamedStack._init_kernels

    def __init__(self, module):
        self.activations = list(module.activations)
        self.dtype = module.compute_dtype
        self._set_shapes({key: shape for i, l in enumerate(module.layers) for key, shape in (
            (f"layers.{i}.kernel", (l.in_features, l.out_features)),
            (f"layers.{i}.bias", (l.out_features,)),
        )})

    def split(self, flat: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Views ``(W (M, in, out), b (M, out))`` of each layer."""
        p = self.pieces(flat)
        return [(p[f"layers.{i}.kernel"], p[f"layers.{i}.bias"]) for i in range(len(self.activations))]

    def forward(self, flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``x`` (M, B, n_features) -> (M, B, n_features) float32."""
        layers = [(W, b, act) for (W, b), act in zip(self.split(flat), self.activations)]
        return dense_chain(x, layers, self.dtype).float()

    def state_dicts(self, flat: torch.Tensor) -> List[Dict[str, np.ndarray]]:
        """Each member's ``FeedForwardAutoEncoder`` state dict, as numpy."""
        return [{k.replace(".kernel", ".weight"): np.ascontiguousarray(v.T) if k.endswith(".kernel") else v
                 for k, v in sd.items()} for sd in super().state_dicts(flat)]

    def from_state_dicts(self, states: Sequence[Dict[str, np.ndarray]]) -> torch.Tensor:
        """Inverse of :meth:`state_dicts`: ``(M, P)`` on the CPU."""
        return super().from_state_dicts([
            {k.replace(".weight", ".kernel"): np.asarray(v).T if k.endswith(".weight") else v
             for k, v in sd.items()} for sd in states])


class StackedLSTM(_NamedStack):
    """An LSTM stack's parameters for ``M`` members, its windowed items and
    its forward.

    Member ``m``'s parameters are row ``m`` of one ``(M, P)`` tensor, piece
    by piece in :class:`~.factories.lstm.LSTMStack`'s state-dict order and
    shapes: per layer ``Wi`` (F_in, 4H), ``Wh`` (H, 4H), ``b`` (4H,), then
    the head's ``kernel`` (H, F) and ``bias`` (F,), the gates concatenated
    in Flax's order i, f, g, o. ``module`` is an ``LSTMStack`` giving the
    widths and activations; an item is a window start, the window ``[i, i +
    lookback)`` trained against row ``i + lookback - 1 + target_offset``."""

    windowed = True

    def __init__(self, module, lookback: int, target_offset: int = 0):
        self.dims = tuple(module.dims)
        self.funcs = tuple(module.funcs)
        self.out_func = module.out_func
        self.dtype = module.compute_dtype
        self.n_features = int(module.n_features)
        self.lookback = int(lookback)
        self.target_offset = int(target_offset)
        # rows before an item's target row, which the rows must carry beyond
        # the last item
        self.warmup = self.lookback - 1 + self.target_offset
        ins = (self.n_features, *self.dims[:-1])
        shapes = {}
        for i, (n_in, H) in enumerate(zip(ins, self.dims)):
            shapes.update({f"layers.{i}.Wi": (n_in, 4 * H), f"layers.{i}.Wh": (H, 4 * H),
                           f"layers.{i}.b": (4 * H,)})
        shapes.update({"head.kernel": (self.dims[-1], self.n_features),
                       "head.bias": (self.n_features,)})
        self._set_shapes(shapes)

    def split(self, flat: torch.Tensor):
        """``(layers, (Wd, bd))`` as ``ops/seq_scan`` takes them: per layer
        ``(Wi (M, F_in, 4H), Wh (M, H, 4H), b (M, 4H))``."""
        p = self.pieces(flat)
        layers = [tuple(p[f"layers.{i}.{k}"] for k in ("Wi", "Wh", "b")) for i in range(len(self.dims))]
        return layers, (p["head.kernel"], p["head.bias"])

    def forward(self, flat: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
        """Windows ``xb`` (M, B, lookback, F) -> (M, B, F): through autograd
        where ``flat`` asks for a gradient, else through the fused step
        kernel (``lstm_time_major_forward``)."""
        forward = (lstm_train_forward if torch.is_grad_enabled() and flat.requires_grad
                   else lstm_time_major_forward)
        return forward(self.split(flat), xb, self.funcs, self.out_func, self.dtype)

    def batch(self, X, Y, idx):
        """The windows of items ``idx`` (M, B) over the raw rows ``X`` (M,
        rows, F), and their targets from ``Y``'s rows: ``(xb, yb)``."""
        return gather_window_batch(X, idx, self.lookback, self.target_offset, Y)

    def init(self, generators: Sequence[torch.Generator]) -> torch.Tensor:
        """Fresh ``(M, P)`` parameters on the CPU, one member per generator,
        drawn as Flax's ``OptimizedLSTMCell`` and ``Dense`` do, gate by gate:
        ``lecun_normal`` input kernels (F_in, H), ``orthogonal`` hidden
        kernels (H, H), zero biases, a ``lecun_normal`` head."""
        flat = torch.zeros(len(generators), self.n_params)
        for m, g in enumerate(generators):
            layers, (Wd, _) = self.split(flat[m:m + 1])
            for Wi, Wh, _ in layers:
                H = Wh.shape[-2]
                for k in range(4):  # ii, if, ig, io
                    Wi[0, :, k * H:(k + 1) * H] = lecun_normal((Wi.shape[1], H), g)
                for k in range(4):  # hi, hf, hg, ho
                    Wh[0, :, k * H:(k + 1) * H] = torch.nn.init.orthogonal_(torch.empty(H, H), generator=g)
            Wd[0] = lecun_normal(Wd.shape[1:], g)
        return flat


class StackedConv(_NamedStack):
    """A conv autoencoder's parameters for ``M`` members, its windowed items
    (as :class:`StackedLSTM`'s) and its forward.

    Member ``m``'s parameters are row ``m`` of one ``(M, P)`` tensor, piece
    by piece in :class:`~.factories.conv.Conv1DAutoEncoder`'s state-dict
    order and Flax's shapes: per layer ``kernel`` (K, F_in, C) and ``bias``
    (C,). The forward runs every member at once, one ``torch.baddbmm`` a
    layer over the taps' strided view (``factories.conv``)."""

    windowed = True

    def __init__(self, module: Conv1DAutoEncoder, lookback: int, target_offset: int = 0):
        self.layer_names = module.layer_names()
        self.n_encoder = len(module.channels)
        self.activation = module.activation
        self.dtype = module.compute_dtype
        self.n_features = int(module.n_features)
        self.lookback = int(lookback)
        self.target_offset = int(target_offset)
        self.warmup = self.lookback - 1 + self.target_offset
        self._set_shapes({k: tuple(v.shape) for k, v in module.state_dict().items()})

    def split(self, flat: torch.Tensor):
        """``(kernel (M, K, F_in, C), bias (M, C))`` of each layer, in the
        forward's order."""
        p = self.pieces(flat)
        return [(p[f"{n}.kernel"], p[f"{n}.bias"]) for n in self.layer_names]

    def forward(self, flat: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
        """Windows ``xb`` (M, B, lookback, F) -> (M, B, F)."""
        return conv_autoencoder_forward(self.split(flat), xb, self.n_encoder, self.activation, self.dtype)

    def batch(self, X, Y, idx):
        """As :meth:`StackedLSTM.batch`."""
        return gather_window_batch(X, idx, self.lookback, self.target_offset, Y)

    init = _NamedStack._init_kernels


class StackedVAE(_NamedStack):
    """A variational autoencoder's parameters for ``M`` members, its items
    (rows) and its two forwards: :meth:`forward` decodes the latent mean
    (scoring, the error scalers), :meth:`elbo_terms` decodes a sample (the
    ``"vae"`` loss). Member ``m``'s parameters are row ``m`` of one ``(M,
    P)`` tensor in :class:`~.factories.variational.VariationalAutoEncoder`'s
    state-dict order and Flax's shapes (``kernel`` (in, out), ``bias``)."""

    batch = staticmethod(_row_batch)
    init = _NamedStack._init_kernels

    def __init__(self, module: VariationalAutoEncoder):
        self.module = module
        self.dtype = module.compute_dtype
        self.latent_dim = module.latent_dim
        self._set_shapes({k: tuple(v.shape) for k, v in module.state_dict().items()})

    def chains(self, flat: torch.Tensor):
        p = self.pieces(flat)
        return self.module.chains(lambda n: (p[f"{n}.kernel"], p[f"{n}.bias"]))

    def forward(self, flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Rows ``x`` (M, B, F) -> the mean decode (M, B, F)."""
        enc, mu, _logvar, dec = self.chains(flat)
        return dense_chain(x, [*enc, mu, *dec], self.dtype).float()

    def elbo_terms(self, flat: torch.Tensor, x: torch.Tensor, noise: torch.Tensor):
        """``(recon (M, B, F), kl (M, B))`` with ``noise`` (M, B, latent)."""
        return vae_elbo_terms(self.chains(flat), x, noise, self.dtype)


# the stack of each model family (``models.register.by_family``)
_STACKS = {"dense": StackedDense, "vae": StackedVAE, "lstm": StackedLSTM, "conv": StackedConv}


def make_stack(module, lookback: int = 1, target_offset: int = 0):
    """The stack that trains ``module``'s architecture, chosen by the
    module's family (never by the estimator class: an ``LSTMAutoEncoder``
    may hold a conv model): windowed modules get ``lookback`` and
    ``target_offset``."""
    stack = by_family(_STACKS, module, "training stack")
    return stack(module, lookback, target_offset) if module.windowed else stack(module)


def resolve_loss(loss: str, stack) -> str:
    """``"auto"`` is ``"vae"`` for a variational stack, else ``"mse"`` (JAX
    ``BaseEstimator._resolved_loss``); other names pass through."""
    if loss != "auto":
        return loss
    return "vae" if hasattr(stack, "elbo_terms") else "mse"


# ---------------------------------------------------------------------- #
# optimizers: optax's formulas, stacked over members
# ---------------------------------------------------------------------- #

# optax's defaults for the reference's five optimizer names
_DEFAULTS = {
    "adam": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0),
    "adamw": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4),
    "sgd": dict(),
    "rmsprop": dict(decay=0.9, eps=1e-8, initial_scale=0.0),
    "adagrad": dict(initial_accumulator_value=0.1, eps=1e-7),
}


class OptState(NamedTuple):
    count: torch.Tensor  # (M,) int32 steps taken, per member
    mu: Optional[torch.Tensor]  # (M, P) first moment (adam, adamw)
    nu: Optional[torch.Tensor]  # (M, P) second moment / sum of squares


class StackedOptimizer:
    """``optax.<name>(learning_rate, **kwargs)`` for ``M`` stacked members.

    ``update(grads, state, params, lr, has_real)`` takes a per-member
    learning-rate vector ``lr`` (M,) and applies the step only to members
    whose ``has_real`` (M,) is set: the others keep their parameters,
    moments and step count exactly. Adam's bias correction uses each
    member's own count."""

    def __init__(self, name: str, learning_rate: float, **kwargs):
        if name not in _DEFAULTS:
            raise ValueError(f"Unknown optimizer {name!r}; known: {sorted(_DEFAULTS)}")
        unknown = set(kwargs) - set(_DEFAULTS[name])
        if unknown:
            raise TypeError(f"optimizer {name!r} takes no {sorted(unknown)} in the port")
        self.name = name
        self.learning_rate = float(learning_rate)
        self.hp = {**_DEFAULTS[name], **kwargs}

    def init(self, params: torch.Tensor) -> OptState:
        count = torch.zeros(params.shape[0], dtype=torch.int32, device=params.device)
        if self.name in ("adam", "adamw"):
            return OptState(count, torch.zeros_like(params), torch.zeros_like(params))
        if self.name == "rmsprop":
            return OptState(count, None, torch.full_like(params, self.hp["initial_scale"]))
        if self.name == "adagrad":
            return OptState(count, None, torch.full_like(params, self.hp["initial_accumulator_value"]))
        return OptState(count, None, None)

    def update(self, grads, state: OptState, params, lr, has_real):
        hp, g = self.hp, grads
        count = state.count + 1
        mu = nu = None
        if self.name in ("adam", "adamw"):
            b1, b2 = hp["b1"], hp["b2"]
            mu = (1 - b1) * g + b1 * state.mu
            nu = (1 - b2) * (g * g) + b2 * state.nu
            c = count.to(g.dtype)[:, None]
            mu_hat = mu / (1 - b1**c)
            nu_hat = nu / (1 - b2**c)
            u = mu_hat / (torch.sqrt(nu_hat + hp["eps_root"]) + hp["eps"])
            if self.name == "adamw":
                u = u + hp["weight_decay"] * params
        elif self.name == "rmsprop":
            nu = (1 - hp["decay"]) * (g * g) + hp["decay"] * state.nu
            u = torch.rsqrt(nu + hp["eps"]) * g
        elif self.name == "adagrad":
            nu = g * g + state.nu
            u = torch.where(nu > 0, torch.rsqrt(nu + hp["eps"]), torch.zeros_like(nu)) * g
        else:
            u = g
        new_params = params + (-lr)[:, None] * u
        keep = has_real[:, None]

        def sel(new, old):
            return None if new is None else torch.where(keep, new, old)

        return sel(new_params, params), OptState(
            torch.where(has_real, count, state.count), sel(mu, state.mu), sel(nu, state.nu)
        )


def make_optimizer(name: str = "adam", learning_rate: float = 1e-3, **kwargs) -> StackedOptimizer:
    """Resolve an optimizer by the reference's name: adam, adamw, sgd,
    rmsprop or adagrad, with optax's defaults."""
    return StackedOptimizer(name.lower(), learning_rate, **kwargs)


# ---------------------------------------------------------------------- #
# data padding, losses, epochs
# ---------------------------------------------------------------------- #


def pad_to_batches(
    X: np.ndarray, Y: np.ndarray, batch_size: int, warmup: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Pad (X, Y) with zero rows so that their items (``len(X) - warmup``:
    rows, or window starts after a ``warmup`` of ``lookback - 1 +
    target_offset`` rows) fill a multiple of ``batch_size``. Returns (X_pad,
    Y_pad, mask, n_batches); mask is 1.0 for real items."""
    n = X.shape[0] - warmup
    if n <= 0:
        raise ValueError("Cannot train on an empty dataset")
    n_batches = max(1, -(-n // batch_size))
    n_pad = n_batches * batch_size
    mask = np.zeros((n_pad,), dtype=np.float32)
    mask[:n] = 1.0
    X_pad = np.zeros((n_pad + warmup,) + X.shape[1:], dtype=np.float32)
    X_pad[:n + warmup] = X
    Y_pad = np.zeros((n_pad + warmup,) + Y.shape[1:], dtype=np.float32)
    Y_pad[:n + warmup] = Y
    return X_pad, Y_pad, mask, n_batches


def make_loss_fn(stack, loss: str = "mse", kl_weight: float = 1.0) -> Callable:
    """``loss_fn(params, xb, yb, maskb, noise=None) -> (M,)`` per-member
    masked losses. ``"mse"`` reconstructs; ``"vae"`` (a :class:`StackedVAE`
    only) is the ELBO of JAX ``make_loss_fn`` (``train_core.py:102-110``):
    the masked MSE of the sampled reconstruction plus ``kl_weight`` times
    the masked mean KL term, the latent drawn with ``noise`` (M, B,
    latent)."""
    if loss == "mse":

        def loss_fn(params, xb, yb, mb, noise=None):
            return mse_loss(stack.forward(params, xb), yb, mb)

    elif loss == "vae":
        if not hasattr(stack, "elbo_terms"):
            raise ValueError(f"loss='vae' needs a variational model, not a {type(stack).__name__}")

        def loss_fn(params, xb, yb, mb, noise=None):
            recon, kl = stack.elbo_terms(params, xb, noise)
            klm = (kl * mb).sum(dim=-1) / torch.clamp(mb.sum(dim=-1), min=1.0)
            return mse_loss(recon, yb, mb) + kl_weight * klm

    else:
        raise ValueError(f"Unknown loss {loss!r} (known: mse, vae)")
    return loss_fn


def draw_noise(generators, n_real, n_pad: int, batch_size: int, width: int, device) -> torch.Tensor:
    """(M, n_pad // batch_size, batch_size, width) reparameterization noise
    for one epoch: member ``m``'s batches that hold real items (the first
    ``ceil(n_real[m] / batch_size)``) drawn from its own generator, standard
    normal, and zeros for its all-padding batches (which are no-ops). The
    draw depends on ``n_real[m]`` and the batch size alone, never on
    ``n_pad``."""
    noise = torch.zeros(len(generators), n_pad // batch_size, batch_size, width)
    for m, (g, n) in enumerate(zip(generators, n_real)):
        k = -(-int(n) // batch_size)
        noise[m, :k] = torch.randn(k, batch_size, width, generator=g)
    if device.type == "cuda":
        return noise.pin_memory().to(device, non_blocking=True)
    return noise


def validation_noise(batch_size: int, width: int) -> torch.Tensor:
    """The fixed (batch_size, width) noise block of every variational
    validation batch: standard normal from a generator seeded 0."""
    return torch.randn(batch_size, width, generator=torch.Generator().manual_seed(0))


class TrainState(NamedTuple):
    params: torch.Tensor  # (M, P) on the training device
    opt_state: OptState
    generators: Tuple[torch.Generator, ...]  # one CPU stream per member


def shuffle_perm(generators, n_real, n_pad: int, device) -> torch.Tensor:
    """(M, n_pad) row order for one epoch: member ``m``'s first
    ``n_real[m]`` rows (its real rows; padding is always a suffix) in a
    random order drawn from its own generator, then its padding rows in
    place. The draw depends on ``n_real[m]`` alone, never on ``n_pad``."""
    perm = torch.arange(n_pad, dtype=torch.int64).repeat(len(generators), 1)
    for m, (g, n) in enumerate(zip(generators, n_real)):
        perm[m, :n] = torch.randperm(int(n), generator=g)
    if device.type == "cuda":
        return perm.pin_memory().to(device, non_blocking=True)
    return perm


def make_step_fn(stack, optimizer: StackedOptimizer, loss: str = "mse", kl_weight: float = 1.0):
    """``step(params, opt_state, xb, yb, mb, lr, noise=None) -> (params,
    opt_state, losses, counts)``: one batch ``xb`` (M, B, .) and targets
    ``yb`` (M, B, F) with item mask ``mb`` (M, B) for every member (and the
    ``"vae"`` loss's noise (M, B, latent)); a member whose batch is all
    padding keeps its parameters and optimizer state."""
    loss_fn = make_loss_fn(stack, loss, kl_weight)

    def step(params, opt_state, xb, yb, mb, lr, noise=None):
        p = params.detach().requires_grad_()
        with torch.enable_grad():
            losses = loss_fn(p, xb, yb, mb, noise)
            (grads,) = torch.autograd.grad(losses.sum(), p)
        counts = mb.sum(dim=1)
        params, opt_state = optimizer.update(grads, opt_state, params, lr, counts > 0)
        return params.detach(), opt_state, losses.detach(), counts

    return step


def make_train_fns(stack, optimizer: StackedOptimizer, batch_size: int, loss: str = "mse",
                   kl_weight: float = 1.0):
    """Returns ``(init_fn, epoch_fn)`` over a stack (:func:`make_stack`).

    - ``init_fn(generators, device, params=None) -> TrainState``: fresh
      parameters drawn from the generators (one per member), or the given
      ``(M, P)`` ``params`` (a warm start); fresh optimizer state.
    - ``epoch_fn(state, X, Y, mask, lr, n_real=None, perm=None,
      noise=None) -> (state, losses)`` over the rows ``X``, ``Y`` (M, rows,
      F) and the item mask ``mask`` (M, n_pad) on the device, ``n_pad`` a
      multiple of ``batch_size``, with learning rates ``lr`` (M,). The item
      order is ``perm`` (M, n_pad) when given, else drawn by
      :func:`shuffle_perm` from the state's generators and the real-item
      counts ``n_real``; each batch's inputs and targets come from
      ``stack.batch``. The ``"vae"`` loss's noise is ``noise`` (M, n_pad //
      batch_size, batch_size, latent) when given, else drawn after the
      shuffle by :func:`draw_noise`. ``losses`` (M,) stays on the device.
    """
    step = make_step_fn(stack, optimizer, loss, kl_weight)

    def init_fn(generators, device, params=None) -> TrainState:
        flat = stack.init(generators) if params is None else params
        flat = flat.to(device)
        return TrainState(flat, optimizer.init(flat), tuple(generators))

    def epoch_fn(state: TrainState, X, Y, mask, lr, n_real=None, perm=None, noise=None):
        M, n_pad = mask.shape
        if perm is None:
            perm = shuffle_perm(state.generators, n_real, n_pad, X.device)
        if loss == "vae" and noise is None:
            noise = draw_noise(state.generators, n_real, n_pad, batch_size, stack.latent_dim, X.device)
        Ms = torch.take_along_dim(mask, perm, dim=1)
        params, opt_state = state.params, state.opt_state
        loss_sum = torch.zeros(M, device=X.device)
        count_sum = torch.zeros(M, device=X.device)
        for s in range(0, n_pad, batch_size):
            xb, yb = stack.batch(X, Y, perm[:, s:s + batch_size])
            params, opt_state, losses, counts = step(
                params, opt_state, xb, yb, Ms[:, s:s + batch_size], lr,
                None if noise is None else noise[:, s // batch_size],
            )
            loss_sum = loss_sum + losses * counts
            count_sum = count_sum + counts
        mean = loss_sum / torch.clamp(count_sum, min=1.0)
        return TrainState(params, opt_state, state.generators), mean

    return init_fn, epoch_fn


def make_eval_fn(stack, batch_size: int, loss: str = "mse", kl_weight: float = 1.0):
    """``eval_fn(params, X, Y, mask, noise=None) -> (M,)`` mean loss over
    the items of ``mask`` (M, n_pad), batch by batch in order, weighted by
    real items, no update (validation loss). The ``"vae"`` loss samples
    every batch with one noise block, ``noise`` (batch_size, latent) or (M,
    batch_size, latent), by default :func:`validation_noise`. It needs no
    gradient, so an LSTM stack's forward runs the fused step kernel on the
    card."""
    loss_fn = make_loss_fn(stack, loss, kl_weight)

    @torch.no_grad()
    def eval_fn(params, X, Y, mask, noise=None):
        M, n_pad = mask.shape
        if loss == "vae":
            if noise is None:
                noise = validation_noise(batch_size, stack.latent_dim)
            noise = noise.to(X.device).expand(M, batch_size, stack.latent_dim)
        total = torch.zeros(M, device=X.device)
        count = torch.zeros_like(total)
        items = torch.arange(n_pad, device=X.device).expand(M, n_pad)
        for s in range(0, n_pad, batch_size):
            mb = mask[:, s:s + batch_size]
            c = mb.sum(dim=1)
            total = total + loss_fn(params, *stack.batch(X, Y, items[:, s:s + batch_size]), mb, noise) * c
            count = count + c
        return total / torch.clamp(count, min=1.0)

    return eval_fn


@torch.no_grad()
def batched_apply(module: torch.nn.Module, X, device, batch_size: int = 4096) -> np.ndarray:
    """``module`` over the leading axis of ``X`` (rows, or windows; an
    array or a tensor) in chunks of ``batch_size`` on ``device``; the result
    as a float32 numpy array."""
    if X.shape[0] == 0:
        raise ValueError("empty input")
    if isinstance(X, np.ndarray):
        X = rows_tensor(X, device)
    x = torch.as_tensor(X, dtype=torch.float32, device=device)
    return torch.cat([module(x[s:s + batch_size]) for s in range(0, len(x), batch_size)]).cpu().numpy()
