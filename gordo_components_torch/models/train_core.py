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

Random draws come from explicit ``torch.Generator`` objects on the CPU, one
per member, seeded from ``(seed, member position)``: a member's
initialization and shuffles do not depend on the gang's width or on its item
padding, and the card and the CPU draw the same numbers.
"""

import hashlib
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

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


def lecun_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Flax's ``lecun_normal`` for a kernel whose fan-in is ``shape[-2]``."""
    std = (1.0 / shape[-2]) ** 0.5 / _TRUNC_STD
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


class StackedDense:
    """A dense autoencoder's parameters for ``M`` members, and its forward.

    Member ``m``'s parameters are row ``m`` of one ``(M, P)`` tensor: per
    layer the kernel ``(in, out)`` row-major, then the bias ``(out,)``.
    ``module`` is a :class:`~.factories.feedforward.FeedForwardAutoEncoder`
    giving the layer widths and activations."""

    warmup = 0  # rows before an item's target row: an item is a row

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

    @staticmethod
    def batch(X, Y, idx):
        """The batch of items (rows) ``idx`` (M, B): ``(xb, yb)`` (M, B, F)."""
        xb = torch.take_along_dim(X, idx[..., None], dim=1)
        return xb, xb if Y is X else torch.take_along_dim(Y, idx[..., None], dim=1)

    def init(self, generators: Sequence[torch.Generator]) -> torch.Tensor:
        """Fresh ``(M, P)`` parameters on the CPU, one member per generator:
        Flax's Dense init (lecun_normal kernels, zero biases)."""
        flat = torch.zeros(len(generators), self.n_params)
        for m, g in enumerate(generators):
            for (W, _), (n_in, _) in zip(self.split(flat[m:m + 1]), self.layers):
                W.copy_(lecun_normal(W.shape, g))
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


class StackedLSTM:
    """An LSTM stack's parameters for ``M`` members, its windowed items and
    its forward.

    Member ``m``'s parameters are row ``m`` of one ``(M, P)`` tensor, piece
    by piece in :class:`~.factories.lstm.LSTMStack`'s state-dict order and
    shapes: per layer ``Wi`` (F_in, 4H), ``Wh`` (H, 4H), ``b`` (4H,), then
    the head's ``kernel`` (H, F) and ``bias`` (F,), the gates concatenated
    in Flax's order i, f, g, o. ``module`` is an ``LSTMStack`` giving the
    widths and activations; an item is a window start, the window ``[i, i +
    lookback)`` trained against row ``i + lookback - 1 + target_offset``."""

    def __init__(self, module, lookback: int, target_offset: int = 0):
        self.dims = tuple(module.dims)
        self.funcs = tuple(module.funcs)
        self.out_func = module.out_func
        self.n_features = int(module.n_features)
        self.lookback = int(lookback)
        self.target_offset = int(target_offset)
        # rows before an item's target row, which the rows must carry beyond
        # the last item
        self.warmup = self.lookback - 1 + self.target_offset
        ins =(self.n_features, *self.dims[:-1])
        self.shapes = {}
        for i, (n_in, H) in enumerate(zip(ins, self.dims)):
            self.shapes.update({f"layers.{i}.Wi": (n_in, 4 * H), f"layers.{i}.Wh": (H, 4 * H),
                                f"layers.{i}.b": (4 * H,)})
        self.shapes.update({"head.kernel": (self.dims[-1], self.n_features),
                            "head.bias": (self.n_features,)})
        self.sizes = [int(np.prod(s)) for s in self.shapes.values()]
        self.n_params = sum(self.sizes)

    def pieces(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Views ``(M, *shape)`` of every state-dict key."""
        M = flat.shape[0]
        return {k: p.view(M, *shape) for (k, shape), p in
                zip(self.shapes.items(), flat.split(self.sizes, dim=-1))}

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
        return forward(self.split(flat), xb, self.funcs, self.out_func)

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

    def state_dicts(self, flat: torch.Tensor) -> List[Dict[str, np.ndarray]]:
        """Each member's ``LSTMStack`` state dict, as numpy."""
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


def make_loss_fn(stack, loss: str = "mse") -> Callable:
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


def make_step_fn(stack, optimizer: StackedOptimizer, loss: str = "mse"):
    """``step(params, opt_state, xb, yb, mb, lr) -> (params, opt_state,
    losses, counts)``: one batch ``xb`` (M, B, .) and targets ``yb`` (M, B,
    F) with item mask ``mb`` (M, B) for every member; a member whose batch
    is all padding keeps its parameters and optimizer state."""
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


def make_train_fns(stack, optimizer: StackedOptimizer, batch_size: int, loss: str = "mse"):
    """Returns ``(init_fn, epoch_fn)`` over a :class:`StackedDense` or a
    :class:`StackedLSTM`.

    - ``init_fn(generators, device, params=None) -> TrainState``: fresh
      parameters drawn from the generators (one per member), or the given
      ``(M, P)`` ``params`` (a warm start); fresh optimizer state.
    - ``epoch_fn(state, X, Y, mask, lr, n_real=None, perm=None) ->
      (state, losses)`` over the rows ``X``, ``Y`` (M, rows, F) and the item
      mask ``mask`` (M, n_pad) on the device, ``n_pad`` a multiple of
      ``batch_size``, with learning rates ``lr`` (M,). The item order is
      ``perm`` (M, n_pad) when given, else drawn by :func:`shuffle_perm`
      from the state's generators and the real-item counts ``n_real``; each
      batch's inputs and targets come from ``stack.batch``. ``losses`` (M,)
      stays on the device.
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
        Ms = torch.take_along_dim(mask, perm, dim=1)
        params, opt_state = state.params, state.opt_state
        loss_sum = torch.zeros(M, device=X.device)
        count_sum = torch.zeros(M, device=X.device)
        for s in range(0, n_pad, batch_size):
            xb, yb = stack.batch(X, Y, perm[:, s:s + batch_size])
            params, opt_state, losses, counts = step(
                params, opt_state, xb, yb, Ms[:, s:s + batch_size], lr,
            )
            loss_sum = loss_sum + losses * counts
            count_sum = count_sum + counts
        mean = loss_sum / torch.clamp(count_sum, min=1.0)
        return TrainState(params, opt_state, state.generators), mean

    return init_fn, epoch_fn


def make_eval_fn(stack, batch_size: int, loss: str = "mse"):
    """``eval_fn(params, X, Y, mask) -> (M,)`` mean loss over the items of
    ``mask`` (M, n_pad), batch by batch in order, weighted by real items, no
    update (validation loss). It needs no gradient, so an LSTM stack's
    forward runs the fused step kernel on the card."""
    loss_fn = make_loss_fn(stack, loss)

    @torch.no_grad()
    def eval_fn(params, X, Y, mask):
        M, n_pad = mask.shape
        total = torch.zeros(M, device=X.device)
        count = torch.zeros_like(total)
        items = torch.arange(n_pad, device=X.device).expand(M, n_pad)
        for s in range(0, n_pad, batch_size):
            mb = mask[:, s:s + batch_size]
            c = mb.sum(dim=1)
            total = total + loss_fn(params, *stack.batch(X, Y, items[:, s:s + batch_size]), mb) * c
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
    x = torch.as_tensor(X, dtype=torch.float32, device=device)
    return torch.cat([module(x[s:s + batch_size]) for s in range(0, len(x), batch_size)]).cpu().numpy()
