"""Training core: stacked members, explicit state, one forward layout.

Counterpart of the dense half of ``gordo_components_tpu/models/train_core.py``.
Every function here works on a stack of ``M`` members (``M = 1`` for a
single estimator), so the single fit and the fleet run the same code:

- :class:`StackedDense` holds a dense autoencoder's parameters for all
  members in one flat ``(M, P)`` tensor and runs the forward in the bank's
  layout, one ``torch.baddbmm`` per layer over ``(M, B, .)`` with Flax's
  ``(in, out)`` kernels;
- :func:`make_optimizer` is a stacked functional update with optax's
  formulas and defaults: per-member step counts and learning rates, and a
  per-member skip of the whole update;
- :func:`make_train_fns` gives ``init_fn`` and ``epoch_fn``. Gradients come
  from the sum of the per-member masked losses, which decouples exactly:
  each member's loss depends on its own parameter row only.

The epoch keeps the reference's semantics (``train_core.py:142-188``):
padding rows sort to the end of every shuffle, a batch that is all padding
is an exact no-op for its member (parameters, moments and step count
unchanged), and the epoch loss is weighted by real rows. Nothing inside the
batch loop reads a device value on the host.

Random draws come from explicit ``torch.Generator`` objects on the CPU, one
per member, seeded from ``(seed, member position)``: a member's
initialization and shuffles do not depend on the gang's width or on its row
padding, and the card and the CPU draw the same numbers.
"""

import hashlib
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gordo_components_torch.ops.losses import mse_loss

# Flax's Dense kernel init, lecun_normal: a normal truncated to two standard
# deviations, rescaled so its variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def member_generator(seed: int, position: int) -> torch.Generator:
    """The random stream of the member at ``position`` of a gang seeded
    with ``seed`` (a CPU generator)."""
    digest = hashlib.sha256(f"{int(seed)}|{int(position)}".encode()).digest()
    return torch.Generator().manual_seed(int.from_bytes(digest[:8], "little"))


class StackedDense:
    """A dense autoencoder's parameters for ``M`` members, and its forward.

    Member ``m``'s parameters are row ``m`` of one ``(M, P)`` tensor: per
    layer the kernel ``(in, out)`` row-major, then the bias ``(out,)``.
    ``module`` is a :class:`~.factories.feedforward.FeedForwardAutoEncoder`
    giving the layer widths and activations."""

    def __init__(self, module):
        self.dims = [module.layers[0].in_features] + [l.out_features for l in module.layers]
        self.activations = list(module.activations)
        self.layers = list(zip(self.dims[:-1], self.dims[1:]))
        self.sizes = [n for i, o in self.layers for n in (i * o, o)]
        self.n_params = sum(self.sizes)

    def split(self, flat: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Views ``(W (M, in, out), b (M, out))`` of each layer."""
        M = flat.shape[0]
        pieces = flat.split(self.sizes, dim=-1)
        return [
            (pieces[2 * k].view(M, i, o), pieces[2 * k + 1])
            for k, (i, o) in enumerate(self.layers)
        ]

    def forward(self, flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``x`` (M, B, n_features) -> (M, B, n_features)."""
        for (W, b), act in zip(self.split(flat), self.activations):
            x = act(torch.baddbmm(b.unsqueeze(1), x, W))
        return x

    def init(self, generators: Sequence[torch.Generator]) -> torch.Tensor:
        """Fresh ``(M, P)`` parameters on the CPU, one member per generator:
        Flax's Dense init (lecun_normal kernels, zero biases)."""
        flat = torch.zeros(len(generators), self.n_params)
        for m, g in enumerate(generators):
            for (W, _), (n_in, _) in zip(self.split(flat[m:m + 1]), self.layers):
                std = (1.0 / n_in) ** 0.5 / _TRUNC_STD
                W.copy_(torch.nn.init.trunc_normal_(torch.empty(W.shape), generator=g) * std)
        return flat

    def state_dicts(self, flat: torch.Tensor) -> List[Dict[str, np.ndarray]]:
        """Each member's ``FeedForwardAutoEncoder`` state dict, as numpy."""
        layers = [(W.detach().cpu().numpy(), b.detach().cpu().numpy()) for W, b in self.split(flat)]
        return [
            {k: v for i, (W, b) in enumerate(layers) for k, v in (
                (f"layers.{i}.weight", np.ascontiguousarray(W[m].T)),
                (f"layers.{i}.bias", np.array(b[m])),
            )}
            for m in range(flat.shape[0])
        ]

    def from_state_dicts(self, states: Sequence[Dict[str, np.ndarray]]) -> torch.Tensor:
        """Inverse of :meth:`state_dicts`: ``(M, P)`` on the CPU."""
        rows = []
        for sd in states:
            row = []
            for i, (n_in, n_out) in enumerate(self.layers):
                W = np.asarray(sd[f"layers.{i}.weight"], np.float32)
                b = np.asarray(sd[f"layers.{i}.bias"], np.float32)
                if W.shape != (n_out, n_in) or b.shape != (n_out,):
                    raise ValueError(
                        f"layer {i}: weight {W.shape}, bias {b.shape}; this "
                        f"architecture wants ({n_out}, {n_in}) and ({n_out},)"
                    )
                row += [W.T.reshape(-1), b]
            rows.append(np.concatenate(row))
        return torch.from_numpy(np.stack(rows).astype(np.float32))


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
    X: np.ndarray, Y: np.ndarray, batch_size: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Pad (X, Y) with zero rows to a multiple of ``batch_size``.
    Returns (X_pad, Y_pad, mask, n_batches); mask is 1.0 for real rows."""
    n = X.shape[0]
    if n == 0:
        raise ValueError("Cannot train on an empty dataset")
    n_batches = max(1, -(-n // batch_size))
    n_pad = n_batches * batch_size
    mask = np.zeros((n_pad,), dtype=np.float32)
    mask[:n] = 1.0
    X_pad = np.zeros((n_pad,) + X.shape[1:], dtype=np.float32)
    X_pad[:n] = X
    Y_pad = np.zeros((n_pad,) + Y.shape[1:], dtype=np.float32)
    Y_pad[:n] = Y
    return X_pad, Y_pad, mask, n_batches


def make_loss_fn(stack: StackedDense, loss: str = "mse") -> Callable:
    """``loss_fn(params, xb, yb, maskb) -> (M,)`` per-member masked losses.
    ``"mse"`` only: the variational ``"vae"`` loss is not ported yet."""
    if loss == "vae":
        raise NotImplementedError("the 'vae' loss (variational models) is not ported yet")
    if loss != "mse":
        raise ValueError(f"Unknown loss {loss!r} (known: mse, vae)")

    def loss_fn(params, xb, yb, mb):
        return mse_loss(stack.forward(params, xb), yb, mb)

    return loss_fn


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


def make_step_fn(stack: StackedDense, optimizer: StackedOptimizer, loss: str = "mse"):
    """``step(params, opt_state, xb, yb, mb, lr) -> (params, opt_state,
    losses, counts)``: one batch ``xb``, ``yb`` (M, B, F) with row mask
    ``mb`` (M, B) for every member; a member whose batch is all padding
    keeps its parameters and optimizer state."""
    loss_fn = make_loss_fn(stack, loss)

    def step(params, opt_state, xb, yb, mb, lr):
        p = params.detach().requires_grad_()
        with torch.enable_grad():
            losses = loss_fn(p, xb, yb, mb)
            (grads,) = torch.autograd.grad(losses.sum(), p)
        counts = mb.sum(dim=1)
        params, opt_state = optimizer.update(grads, opt_state, params, lr, counts > 0)
        return params.detach(), opt_state, losses.detach(), counts

    return step


def make_train_fns(stack: StackedDense, optimizer: StackedOptimizer, batch_size: int,
                   loss: str = "mse"):
    """Returns ``(init_fn, epoch_fn)``.

    - ``init_fn(generators, device, params=None) -> TrainState``: fresh
      parameters drawn from the generators (one per member), or the given
      ``(M, P)`` ``params`` (a warm start); fresh optimizer state.
    - ``epoch_fn(state, X, Y, mask, lr, n_real=None, perm=None) ->
      (state, losses)`` over ``X``, ``Y`` (M, n_pad, F) and ``mask``
      (M, n_pad) on the device, ``n_pad`` a multiple of ``batch_size``,
      with learning rates ``lr`` (M,). The row order is ``perm`` (M, n_pad)
      when given, else drawn by :func:`shuffle_perm` from the state's
      generators and the real-row counts ``n_real``. ``losses`` (M,) stays
      on the device.
    """
    step = make_step_fn(stack, optimizer, loss)

    def init_fn(generators, device, params=None) -> TrainState:
        flat = stack.init(generators) if params is None else params
        flat = flat.to(device)
        return TrainState(flat, optimizer.init(flat), tuple(generators))

    def epoch_fn(state: TrainState, X, Y, mask, lr, n_real=None, perm=None):
        M, n_pad = mask.shape
        if perm is None:
            perm = shuffle_perm(state.generators, n_real, n_pad, X.device)
        Xs = torch.take_along_dim(X, perm[..., None], dim=1)
        Ys = Xs if Y is X else torch.take_along_dim(Y, perm[..., None], dim=1)
        Ms = torch.take_along_dim(mask, perm, dim=1)
        params, opt_state = state.params, state.opt_state
        loss_sum = torch.zeros(M, device=X.device)
        count_sum = torch.zeros(M, device=X.device)
        for s in range(0, n_pad, batch_size):
            params, opt_state, losses, counts = step(
                params, opt_state, Xs[:, s:s + batch_size], Ys[:, s:s + batch_size],
                Ms[:, s:s + batch_size], lr,
            )
            loss_sum = loss_sum + losses * counts
            count_sum = count_sum + counts
        mean = loss_sum / torch.clamp(count_sum, min=1.0)
        return TrainState(params, opt_state, state.generators), mean

    return init_fn, epoch_fn


def make_eval_fn(stack: StackedDense, batch_size: int, loss: str = "mse"):
    """``eval_fn(params, X, Y, mask) -> (M,)`` mean loss over padded data,
    batch by batch, weighted by real rows, no update (validation loss)."""
    loss_fn = make_loss_fn(stack, loss)

    @torch.no_grad()
    def eval_fn(params, X, Y, mask):
        total = torch.zeros(mask.shape[0], device=X.device)
        count = torch.zeros_like(total)
        for s in range(0, mask.shape[1], batch_size):
            mb = mask[:, s:s + batch_size]
            c = mb.sum(dim=1)
            total = total + loss_fn(params, X[:, s:s + batch_size], Y[:, s:s + batch_size], mb) * c
            count = count + c
        return total / torch.clamp(count, min=1.0)

    return eval_fn


@torch.no_grad()
def batched_apply(module: torch.nn.Module, X: np.ndarray, device, batch_size: int = 4096) -> np.ndarray:
    """``module`` over the rows of ``X`` in chunks of ``batch_size`` on
    ``device``; the result as a float32 numpy array."""
    if X.shape[0] == 0:
        raise ValueError("empty input")
    x = torch.as_tensor(np.asarray(X, np.float32), device=device)
    return torch.cat([module(x[s:s + batch_size]) for s in range(0, len(x), batch_size)]).cpu().numpy()
