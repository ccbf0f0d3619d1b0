"""FleetTrainer: train many per-machine autoencoders as one stack.

Counterpart of ``gordo_components_tpu/parallel/fleet.py`` for the dense
family (``AutoEncoder``: feedforward and variational kinds) and the
sequence families (``LSTMAutoEncoder``, ``LSTMForecast`` and
``ConvAutoEncoder``; an ``LSTMAutoEncoder`` may hold the conv kind). The
fleet is the tensor:

- an item is a training unit: a row for the dense family, a window start
  for a sequence family, whose rows carry ``lookback - 1 + offset`` warm-up
  rows beyond the last item. Members are bucketed by (feature count,
  padded items); item counts round up the batch-count ladder
  (:func:`quantize_batch_count`) and member counts up the member ladder
  (:func:`quantize_member_count`), whose dummy slots replicate real members
  and are dropped by name, so neither changes a real member's training;
- each member's input scaler is fitted on the card over its real rows
  (padding is NaN to the fit);
- all members train in one stack (``train_core``): gradients from the sum
  of the per-member masked losses, per-member learning rates, early
  stopping per member with its best parameters restored. A sequence
  stack's windows are gathered from the rows batch by batch; an LSTM
  stack's training forward is PyTorch ops under autograd, as the JAX
  package trains without its fused step kernel, and the validation loss
  runs that kernel. ``loss="auto"`` resolves by the module: a variational
  kind trains and validates with the ELBO (its validation with one fixed
  noise block, ``train_core.validation_noise``), every other with MSE;
- the error scalers and thresholds of the anomaly contract come from the
  training items: for the dense family one stacked pass (max at q = 1,
  exact quantiles below); for a sequence family two streamed passes batch
  by batch (through the fused step kernel for an LSTM): min and max of the
  errors, then the max at q = 1, or 8192-bin histograms below,
  ``histogram-8192``.

Early-stopping state and losses stay on the device; the host reads them
once every ``host_sync_every`` epochs (the JAX package's host loop at 1, its
on-device chunks above), and at each such sync calls ``epoch_callback`` and,
every ``checkpoint_every`` epochs, checkpoints the bucket under
``checkpoint_dir`` (``parallel/checkpoint.py``): its parameters, optimizer
state, every member's random stream and its early-stopping state, so that a
preempted fit resumes the same run. Buckets train one after another on the
one card. Under a build trace (``observability.tracing.current_trace``)
each bucket records a ``fit:f{F}x{items}`` span with its ``checkpoint``
spans and an estimated ``compile`` span (epoch 0's excess over the steady
epochs: the port compiles nothing, so this is its warm-up), and the
process registry carries the ``gordo_fleet_*`` gauges and counters.

``GORDO_FLEET_WIDTH`` (``parallel/autotune.py``) caps a stack's members:
a bucket wider than the cap trains in near-equal chunks no wider than it,
as the JAX trainer splits it. A chunk's members take their positions in
the chunk, which reseeds their initialisation: a capped fit trains valid
models, not bitwise the uncapped ones. ``last_stats["width_cap"]`` records
the cap.

Not ported yet, and raising: ``mesh``.
"""

import inspect
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from gordo_components_torch.device import resolve_device
from gordo_components_torch.models import train_core
from gordo_components_torch.models.register import lookup_factory
from gordo_components_torch.observability.metrics import get_registry
from gordo_components_torch.observability.tracing import current_trace
from gordo_components_torch.parallel.autotune import resolve_fleet_width, split_widths
from gordo_components_torch.ops.scaler import ScalerParams, fit_minmax, fit_standard
from gordo_components_torch.parallel.checkpoint import FleetBucketCheckpoint, bucket_checkpoint_key
from gordo_components_torch.utils import capture_args

logger = logging.getLogger(__name__)

# the engine's base learning rate (BaseEstimator's default too)
DEFAULT_LEARNING_RATE = 1e-3
_MODEL_TYPES = ("AutoEncoder", "LSTMAutoEncoder", "LSTMForecast", "ConvAutoEncoder")
# the sequence error pass's quantile histograms: a threshold within one bin
# (range / 8192) of the exact quantile, with (F + 1) * 8192 int32 counts a
# member; wider gangs stream through the pass in member chunks under a
# budget of 256 MiB of counts
_QUANTILE_BINS = 8192
_QUANTILE_CHUNK_BYTES = 1 << 28


def _family_defaults(model_type: str) -> Tuple[str, int]:
    """(default kind, default lookback) from the estimator class's own
    constructor: one source of truth with the single path."""
    from gordo_components_torch import models as _models

    params = inspect.signature(getattr(_models, model_type).__init__).parameters
    lookback = params.get("lookback_window")
    return params["kind"].default, (int(lookback.default) if lookback is not None else 1)


def quantize_batch_count(n: int) -> int:
    """Round a per-member batch count up the {1, 2, 3, 4, 6, 8, 12, 16, 24,
    32, ...} ladder (powers of two and their 1.5x midpoints): O(log rows)
    buckets per feature count, at most 33% padded rows, and the padding is
    a true no-op (all-padding batches skip the update)."""
    if n <= 2:
        return max(1, n)
    p = 2
    while True:
        if n <= p + p // 2:
            return p + p // 2
        p *= 2
        if n <= p:
            return p


def quantize_member_count(n: int) -> int:
    """Round a gang's member count up the {2^k, 1.25*2^k, 1.5*2^k,
    1.75*2^k} ladder (multiples of 2048 above 16384); counts up to 4 stay
    exact."""
    if n <= 4:
        return n
    if n > 16384:
        return -(-n // 2048) * 2048
    p = 4
    while True:
        for m in (p, p + p // 4, p + p // 2, p + 3 * p // 4):
            if n <= m:
                return m
        p *= 2


def _fit_scalers(X: torch.Tensor, mask: torch.Tensor, kind: str) -> ScalerParams:
    """Per-member input scalers over the real rows of ``X`` (M, rows, F)."""
    Xn = torch.where(mask[..., None] > 0, X, torch.nan)
    return (fit_minmax if kind == "minmax" else fit_standard)(Xn)


def _transform_all(scalers: ScalerParams, X: torch.Tensor) -> torch.Tensor:
    return (X - scalers.shift[:, None]) * scalers.scale[:, None]


@torch.no_grad()
def _error_scalers(stack, params, X, mask, q: float):
    """Each member's error scaler (min-max of |x - output| over its real
    rows) and thresholds: the max scaled error per feature and of the row
    norms at q = 1, else their exact quantiles at q (linear interpolation,
    as ``np.quantile``), one member at a time."""
    diff = (X - stack.forward(params, X)).abs()
    real = mask[..., None] > 0
    diff = torch.where(real, diff, torch.nan)
    es = fit_minmax(diff)
    scaled = _transform_all(es, diff)
    total = torch.sqrt(torch.nansum(scaled**2, dim=-1))
    total = torch.where(mask > 0, total, torch.nan)
    if q >= 1.0:
        feat = torch.where(real, scaled, -torch.inf).amax(dim=1)
        tot = torch.where(mask > 0, total, -torch.inf).amax(dim=1)
    else:
        # per member: torch.nanquantile refuses inputs of ~16M elements
        feat = torch.stack([torch.nanquantile(s, q, dim=0) for s in scaled])
        tot = torch.stack([torch.nanquantile(t, q) for t in total])
    return es, feat, tot


def _hist_quantile(hist, binw, q: float, n):
    """``np.quantile(values, q)`` (linear interpolation between order
    statistics) from int32 histograms ``hist`` (..., bins) of bin width
    ``binw`` over ``n`` (...,) values each: each order statistic is found by
    inverting the empirical CDF, uniform within its bin, so the error is at
    most one bin width (JAX ``_hist_quantile``, ``fleet.py:123-147``)."""
    cum = torch.cumsum(hist, dim=-1, dtype=torch.int32).float()
    hist = hist.float()
    last = hist.shape[-1] - 1

    def order_stat(j):  # j (...,): a float 0-indexed rank
        b = torch.searchsorted(cum, (j + 1.0)[..., None], side="left").clamp(0, last)
        prev = torch.where(b > 0, cum.gather(-1, (b - 1).clamp(min=0)), 0.0)[..., 0]
        frac = ((j + 1.0 - prev) / hist.gather(-1, b)[..., 0].clamp(min=1.0)).clamp(0.0, 1.0)
        return (b[..., 0].float() + frac) * binw

    p = q * (n - 1.0)
    j0 = torch.floor(p)
    g = p - j0
    j1 = torch.minimum(j0 + 1.0, torch.clamp(n - 1.0, min=0.0))
    return (1.0 - g) * order_stat(j0) + g * order_stat(j1)


@torch.no_grad()
def _seq_error_scalers_chunk(stack, params, X, mask, q: float, batch_size: int):
    """One member chunk of :func:`_seq_error_scalers`."""
    M, n_pad = mask.shape
    F = X.shape[-1]
    items = torch.arange(n_pad, device=X.device).expand(M, n_pad)
    inf = torch.full((M, F), torch.inf, device=X.device)

    def diffs():  # (item mask, |target - output| with NaN on padding) a batch
        for s in range(0, n_pad, batch_size):
            mb = mask[:, s:s + batch_size]
            xb, yb = stack.batch(X, X, items[:, s:s + batch_size])
            d = (yb - stack.forward(params, xb)).abs()
            yield mb, torch.where(mb[..., None] > 0, d, torch.nan)

    def nanmax(a, dim):
        return torch.where(torch.isnan(a), -torch.inf, a).amax(dim=dim)

    lo, hi = inf, -inf
    for _, d in diffs():
        lo = torch.fmin(lo, torch.where(torch.isnan(d), torch.inf, d).amin(dim=1))
        hi = torch.fmax(hi, nanmax(d, 1))
    # fit_minmax's (0, 1) affine, its constant guard included
    span = torch.where((hi - lo).abs() < 1e-12, 1.0, hi - lo)
    es = ScalerParams(lo, 1.0 / span)

    if q >= 1.0:
        feat, tot = -inf, torch.full((M,), -torch.inf, device=X.device)
        for _, d in diffs():
            scaled = _transform_all(es, d)
            total = torch.sqrt(torch.nansum(scaled**2, dim=-1))
            total = torch.where(torch.isnan(d).all(dim=-1), torch.nan, total)
            feat = torch.fmax(feat, nanmax(scaled, 1))
            tot = torch.fmax(tot, nanmax(total, 1))
        return es, feat, tot

    # q < 1: histograms of the scaled errors over their known ranges, [0, 1]
    # a feature and [0, sqrt(F)] for the row norm, in int32 counts
    bins = _QUANTILE_BINS
    tmax = torch.sqrt(torch.tensor(float(F), device=X.device))
    hf = torch.zeros((M, F * bins), dtype=torch.int32, device=X.device)
    ht = torch.zeros((M, bins), dtype=torch.int32, device=X.device)
    fcols = torch.arange(F, device=X.device) * bins
    for mb, d in diffs():
        valid = mb > 0
        w = valid.to(torch.int32)
        scaled = torch.where(valid[..., None], _transform_all(es, d), 0.0)
        sb = torch.floor(scaled * bins).clamp(0, bins - 1).long()
        hf.scatter_add_(1, (sb + fcols).view(M, -1), w[..., None].expand(sb.shape).reshape(M, -1))
        total = torch.sqrt(torch.sum(scaled * scaled, dim=-1))
        ht.scatter_add_(1, torch.floor(total / tmax * bins).clamp(0, bins - 1).long(), w)
    n = mask.sum(dim=1)
    feat = _hist_quantile(hf.view(M, F, bins), 1.0 / bins, q, n[:, None].expand(M, F))
    return es, feat, _hist_quantile(ht, tmax / bins, q, n)


def _seq_error_scalers(stack, params, X, mask, q: float, batch_size: int):
    """Each sequence member's error scaler and thresholds over its training
    items (item mask ``mask`` over the rows ``X``), in two passes batch by
    batch under ``no_grad`` (so an LSTM's through the fused step kernel on
    the card):
    the min and max of ``|target - output|`` give the min-max error scaler;
    then the max scaled error per feature and of the row norms at q = 1, or
    their q-quantiles from 8192-bin histograms below (JAX
    ``_make_seq_error_scalers``, ``fleet.py:310-428``). At q < 1 members go
    through in chunks that keep the histograms under
    ``_QUANTILE_CHUNK_BYTES`` (``run_error_scalers``, ``fleet.py:260-281``)."""
    M, F = X.shape[0], X.shape[-1]
    ch = M if q >= 1.0 else max(1, _QUANTILE_CHUNK_BYTES // ((F + 1) * _QUANTILE_BINS * 4))
    outs = [_seq_error_scalers_chunk(stack, params[i:i + ch], X[i:i + ch], mask[i:i + ch], q,
                                     batch_size) for i in range(0, M, ch)]
    if len(outs) == 1:
        return outs[0]
    es = ScalerParams(*(torch.cat([o[0][k] for o in outs]) for k in range(2)))
    return es, torch.cat([o[1] for o in outs]), torch.cat([o[2] for o in outs])


def _threshold_method(stack, q: float) -> str:
    """Provenance of the thresholds the trainer computes, from the predicate
    that picks the error pass (JAX ``threshold_method``,
    ``fleet.py:250-258``)."""
    return "exact" if not stack.windowed or q >= 1.0 else f"histogram-{_QUANTILE_BINS}"


def _restore_bucket(resumed: Dict[str, Any], state, M: int, es_enabled: bool, device):
    """``(state, best_params, es, histories, histories_val)`` of a bucket
    from its checkpoint (``FleetBucketCheckpoint.restore``), every piece on
    the bucket's device, with fresh generators carrying the saved streams;
    ``es`` holds ``active`` and, with early stopping, ``best`` and
    ``patience``. Raises on any mismatch with the fresh ``state`` before it
    has replaced anything."""
    saved = resumed["state"]

    def like(a, ref):
        t = torch.from_numpy(np.asarray(a))
        if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype:
            raise ValueError(f"saved {tuple(t.shape)} {t.dtype}, the bucket wants {tuple(ref.shape)} {ref.dtype}")
        return t.to(device)

    params = like(saved["params"], state.params)
    fields = state.opt_state._asdict()
    if set(saved["opt"]) != {k for k, v in fields.items() if v is not None}:
        raise ValueError(f"optimizer state {sorted(saved['opt'])} does not match {sorted(fields)}")
    opt = train_core.OptState(**{k: None if v is None else like(saved["opt"][k], v) for k, v in fields.items()})
    gen_states = np.asarray(saved["generators"])
    if gen_states.shape[0] != M or gen_states.dtype != np.uint8:
        raise ValueError(f"generator states {gen_states.shape} {gen_states.dtype} for {M} members")
    generators = []
    for row in gen_states:
        g = torch.Generator()
        g.set_state(torch.from_numpy(row.copy()))
        generators.append(g)
    es = {"active": like(saved["active"], torch.ones(M, dtype=torch.bool))}
    if es_enabled:
        es["best"] = like(saved["best"], torch.zeros(M))
        es["patience"] = like(saved["patience"], torch.zeros(M, dtype=torch.int32))
    best_params = like(saved["best_params"], state.params) if "best_params" in saved else None
    histories = [list(h) for h in resumed["histories"]]
    histories_val = [list(h) for h in resumed["histories_val"]]
    if len(histories) != M or len(histories_val) != M:
        raise ValueError(f"histories of {len(histories)} members for {M}")
    return (train_core.TrainState(params, opt, tuple(generators)), best_params, es, histories,
            histories_val)


@dataclass
class FleetMemberModel:
    """One trained fleet member, unstacked."""

    name: str
    kind: str
    factory_kwargs: Dict[str, Any]
    n_features: int
    params: Dict[str, np.ndarray]  # the factory module's state dict
    scaler: ScalerParams  # numpy; input scaling fitted on the training rows
    error_scaler: ScalerParams  # numpy; per-feature |err| scaling
    history: Dict[str, List[float]] = field(default_factory=dict)
    tags: Optional[List[str]] = None
    feature_thresholds: Optional[np.ndarray] = None
    total_threshold: Optional[float] = None
    scaler_kind: str = "minmax"
    model_type: str = "AutoEncoder"
    lookback_window: int = 10  # sequence families only
    loss: str = "auto"
    kl_weight: float = 1.0
    threshold_quantile: float = 1.0
    require_thresholds: bool = False
    threshold_method: str = "exact"
    device: Any = "cuda"

    def predict(self, X) -> np.ndarray:
        """The model's output in input space (scaled in, scaled back out).
        A sequence member windows X: output row i belongs to input row
        ``i + lookback_window - 1 + offset``."""
        pipeline = self.to_estimator().base_estimator
        return pipeline.steps[0][1].inverse_transform(pipeline.predict(X))

    def to_estimator(self):
        """A fitted ``DiffBasedAnomalyDetector(Pipeline(scaler, estimator))``,
        the scaler the class the trainer fitted (min-max or z-score)."""
        from gordo_components_torch import models as _models
        from gordo_components_torch.models import DiffBasedAnomalyDetector
        from gordo_components_torch.models.transformers import MinMaxScaler, Pipeline, StandardScaler

        window = {} if self.model_type == "AutoEncoder" else {"lookback_window": self.lookback_window}
        est = getattr(_models, self.model_type)(
            kind=self.kind, loss=self.loss, kl_weight=self.kl_weight, device=self.device,
            **window, **self.factory_kwargs,
        )
        est.params_ = dict(self.params)
        est.n_features_ = self.n_features
        est.history = dict(self.history)
        scaler = StandardScaler() if self.scaler_kind == "standard" else MinMaxScaler()
        scaler.set_fitted(self.scaler, self.n_features)
        det = DiffBasedAnomalyDetector(
            base_estimator=Pipeline([("scale", scaler), ("model", est)]),
            threshold_quantile=self.threshold_quantile,
            require_thresholds=self.require_thresholds,
        )
        det.error_scaler_ = ScalerParams(*(np.asarray(a) for a in self.error_scaler))
        det.tags_ = list(self.tags) if self.tags else [f"feature-{i}" for i in range(self.n_features)]
        if self.feature_thresholds is not None:
            det.feature_thresholds_ = np.asarray(self.feature_thresholds)
            det.total_threshold_ = float(self.total_threshold)
            det.threshold_method_ = self.threshold_method
        return det

    def to_entry(self):
        """The member as a bank entry (``server/bank._BankEntry``)."""
        return self.to_estimator().to_entry(self.name)


class FleetTrainer:
    """Train one architecture (``model_type``: ``AutoEncoder``,
    ``LSTMAutoEncoder``, ``LSTMForecast`` or ``ConvAutoEncoder``) across
    many machines' datasets on one device. Members may differ in feature and
    row counts; they are bucketed by feature count and padded item count."""

    @capture_args
    def __init__(
        self,
        kind: Optional[str] = None,
        epochs: int = 10,
        batch_size: int = 100,
        learning_rate: float = DEFAULT_LEARNING_RATE,
        optimizer: str = "adam",
        early_stopping_patience: Optional[int] = None,
        early_stopping_min_delta: float = 0.0,
        validation_split: float = 0.0,
        seed: int = 0,
        mesh=None,
        compute_dtype: str = "float32",
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 1,
        epoch_callback=None,
        host_sync_every: int = 1,
        quantize_rows: bool = True,
        input_scaler: str = "minmax",
        model_type: str = "AutoEncoder",
        lookback_window: Optional[int] = None,
        loss: str = "auto",
        kl_weight: float = 1.0,
        threshold_quantile: float = 1.0,
        require_thresholds: bool = False,
        device="cuda",
        **factory_kwargs,
    ):
        if model_type not in _MODEL_TYPES:
            raise ValueError(f"model_type must be one of {sorted(_MODEL_TYPES)}, got {model_type!r}")
        if mesh is not None:
            raise NotImplementedError("mesh: multi-device fleet training is not ported yet")
        if input_scaler not in ("minmax", "standard"):
            raise ValueError(f"input_scaler must be minmax|standard, got {input_scaler!r}")
        self.threshold_quantile = float(threshold_quantile)
        if not 0.0 <= self.threshold_quantile <= 1.0:
            raise ValueError(f"threshold_quantile must be in [0, 1], got {threshold_quantile}")
        self.model_type = model_type
        default_kind, default_lookback = _family_defaults(model_type)
        self.kind = default_kind if kind is None else kind
        self.lookback_window = int(default_lookback if lookback_window is None else lookback_window)
        lookup_factory(model_type, self.kind)  # fail fast on a bad kind
        self.epochs = int(epochs)
        self.batch_size = int(batch_size)
        self.learning_rate = float(learning_rate)
        self.optimizer = optimizer
        self.early_stopping_patience = early_stopping_patience
        self.early_stopping_min_delta = float(early_stopping_min_delta)
        self.validation_split = float(validation_split)
        self.seed = int(seed)
        self.compute_dtype = compute_dtype
        self.host_sync_every = max(1, int(host_sync_every))
        # preemption recovery: the bucket's state every checkpoint_every
        # epochs (at host syncs), and a matching interrupted run resumed
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = max(1, int(checkpoint_every))
        # epoch_callback(info) at every host sync, with the sync's last epoch
        self.epoch_callback = epoch_callback
        self.quantize_rows = bool(quantize_rows)
        self.input_scaler = input_scaler
        self.loss = loss
        self.kl_weight = float(kl_weight)
        self.require_thresholds = bool(require_thresholds)
        self.device = device
        self.factory_kwargs = factory_kwargs
        self.last_stats: Dict[str, Any] = {}
        # (trace, open fit span) of the bucket in training: its checkpoint
        # spans nest there; and the bucket's checkpoint, which fit() flushes
        # and closes when the bucket raises
        self._trace_span = None
        self._active_ckpt = None

    def _trace_checkpoint(self, start: float, epoch: int, error: bool = False, **seconds) -> None:
        """One checkpoint save as a span under the bucket's ``fit`` span,
        its pieces' seconds as attributes."""
        if self._trace_span is not None:
            trace, fit_span = self._trace_span
            trace.add_span("checkpoint", start, time.monotonic(), parent=fit_span, epoch=int(epoch),
                           error=error, **seconds)

    def fit(
        self,
        members: Dict[str, Any],
        member_hparams: Optional[Dict[str, Dict[str, Any]]] = None,
        initial_params: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
    ) -> Dict[str, FleetMemberModel]:
        """``members``: name -> (rows, features) array or frame (a frame's
        ``columns`` become the tags). Returns name -> FleetMemberModel.

        ``member_hparams``: name -> {"learning_rate", "early_stopping_patience"}
        overrides, stacked as (M,) vectors in the one program (a patience
        override needs early stopping on). ``initial_params``: name -> the
        factory module's state dict, a warm start (the optimizer starts
        fresh); a shape mismatch raises naming the member."""
        device = resolve_device(self.device)
        t0 = time.time()
        self._member_hparams = {}
        for name, hp in (member_hparams or {}).items():
            if name not in members:
                raise ValueError(f"member_hparams for unknown member {name!r}")
            unknown = set(hp) - {"learning_rate", "early_stopping_patience"}
            if unknown:
                raise ValueError(f"member_hparams[{name!r}]: unsupported keys {sorted(unknown)}")
            if hp.get("early_stopping_patience") is not None and self.early_stopping_patience is None:
                raise ValueError(
                    f"member_hparams[{name!r}] sets early_stopping_patience but the trainer has ES disabled"
                )
            self._member_hparams[name] = dict(hp)
        for name in initial_params or {}:
            if name not in members:
                raise ValueError(f"initial_params for unknown member {name!r}")
        self._initial_params = dict(initial_params or {})
        self._tags = {k: [str(c) for c in v.columns] if hasattr(v, "columns") else None
                      for k, v in members.items()}
        arrays = {k: np.asarray(v.values if hasattr(v, "values") else v, dtype=np.float32)
                  for k, v in members.items()}
        # items: rows for the dense family, window starts for a sequence
        # family, whose rows carry the warm-up beyond the last item
        stacks: Dict[int, Any] = {}  # feature count -> the stack that trains it
        buckets: Dict[Tuple[int, int], List[str]] = {}
        for name, X in arrays.items():
            if X.ndim != 2 or X.shape[0] < 1:
                raise ValueError(f"Member {name!r}: need (rows, features), got {X.shape}")
            if X.shape[1] not in stacks:
                stacks[X.shape[1]] = self._stack(X.shape[1])
            warmup = stacks[X.shape[1]].warmup
            n_items = X.shape[0] - warmup
            if n_items < 1:
                raise ValueError(f"Member {name!r}: need at least lookback_window+offset="
                                 f"{warmup + 1} rows, got {X.shape[0]}")
            n_batches = -(-n_items // self.batch_size)
            if self.quantize_rows:
                n_batches = quantize_batch_count(n_batches)
            buckets.setdefault((X.shape[1], n_batches * self.batch_size), []).append(name)

        # progress in the process registry: one set() a bucket or a sync
        reg = get_registry()
        self._g_members_active = reg.gauge(
            "gordo_fleet_members_active", "Members still training (not early-stopped) in the current bucket"
        ).labels()
        g_trained = reg.gauge(
            "gordo_fleet_members_trained", "Members whose bucket finished training in the current fit"
        ).labels()
        reg.gauge("gordo_fleet_members_total", "Members in the current fleet fit").labels().set(len(members))
        g_trained.set(0)
        width_cap = resolve_fleet_width(f"{self.model_type}:{self.kind}", device=device)
        work = [(key, chunk) for key, names in sorted(buckets.items()) for chunk in split_widths(names, width_cap)]
        trace = current_trace()
        out: Dict[str, FleetMemberModel] = {}
        bucket_stats = []
        for (n_features, padded_items), names in work:
            tb = time.time()
            blabel = f"f{n_features}x{padded_items}"
            fit_span = None
            if trace is not None:
                fit_span = trace.start_span(f"fit:{blabel}", bucket=blabel, members=len(names))
                self._trace_span = (trace, fit_span)
            try:
                res, epoch_seconds, padded_m = self._fit_bucket(
                    stacks[n_features], n_features, padded_items, names, arrays, device
                )
            except BaseException:
                # the pending save is whole training state: commit it if it
                # can be, and stop its writer before a retry reuses the key
                ckpt = self._active_ckpt
                if ckpt is not None:
                    try:
                        ckpt.flush()
                    except Exception:
                        logger.warning("checkpoint flush failed", exc_info=True)
                    finally:
                        ckpt.close()
                if fit_span is not None:
                    fit_span.close(error=True)
                raise
            finally:
                self._active_ckpt = None
                self._trace_span = None
            out.update(res)
            g_trained.set(len(out))
            # epoch 0's excess over the steady epochs: the warm-up (the
            # JAX package's compile)
            compile_s = 0.0
            if epoch_seconds:
                steady = min(epoch_seconds[1:]) if len(epoch_seconds) > 1 else 0.0
                compile_s = max(0.0, epoch_seconds[0] - steady)
            if fit_span is not None:
                fit_span.attributes["epochs"] = len(epoch_seconds)
                fit_span.close()
                if compile_s > 0:
                    trace.add_span("compile", fit_span.start, fit_span.start + compile_s, parent=fit_span,
                                   bucket=blabel, estimated=True)
            reg.counter("gordo_fleet_bucket_builds_total", "Bucket training runs", ("bucket",)).labels(blabel).inc()
            reg.counter("gordo_fleet_bucket_epochs_total", "Epochs trained per bucket",
                        ("bucket",)).labels(blabel).inc(len(epoch_seconds))
            reg.gauge("gordo_fleet_bucket_compile_seconds",
                      "Estimated warm-up seconds (epoch 0 minus the steady epochs)",
                      ("bucket",)).labels(blabel).set(round(compile_s, 3))
            bucket_stats.append({
                "n_features": n_features,
                "padded_items": padded_items,
                "padded_rows": padded_items + stacks[n_features].warmup,
                "n_members": len(names),
                "padded_members": padded_m,
                "seconds": time.time() - tb,
                "epoch_seconds": epoch_seconds,
            })
        self.last_stats = {
            "total_seconds": time.time() - t0,
            "n_members": len(members),
            "buckets": bucket_stats,
            "width_cap": width_cap,
            "device": str(device),
        }
        return out

    def _stack(self, n_features: int):
        """The stack that trains this model at ``n_features``, chosen by the
        factory's module (``train_core.make_stack``): a windowed one over
        windows of ``lookback_window`` rows and the estimator class's target
        offset."""
        from gordo_components_torch import models as _models

        module = lookup_factory(self.model_type, self.kind)(
            n_features, compute_dtype=self.compute_dtype, **self.factory_kwargs
        )
        offset = getattr(_models, self.model_type)._target_offset
        return train_core.make_stack(module, self.lookback_window, offset)

    def _fit_bucket(self, stack, n_features, padded_items, names, arrays, device):
        M_real = len(names)
        M = quantize_member_count(M_real)
        src = [names[i % M_real] for i in range(M)]  # dummies replicate real members
        warmup = stack.warmup
        padded_rows = padded_items + warmup

        # ---- stack + pad on the host, then one copy to the device ----
        n_rows = np.array([arrays[n].shape[0] for n in src])
        Xs = np.zeros((M, padded_rows, n_features), np.float32)
        for i, n in enumerate(src):
            Xs[i, : n_rows[i]] = arrays[n]
        row_mask = (np.arange(padded_rows)[None, :] < n_rows[:, None]).astype(np.float32)
        # validation in item space: the LAST int(items * split) real items of
        # each member are held out; input scalers fit on all real rows, and
        # error scalers on all real items, as the single pipeline's scaler
        # fits before the estimator's own split
        n_items = n_rows - warmup
        item_idx = np.arange(padded_items)[None, :]
        item_mask = (item_idx < n_items[:, None]).astype(np.float32)
        n_val = (n_items * self.validation_split).astype(np.int64)
        n_train = n_items - n_val
        has_val = n_val > 0
        use_val = self.validation_split > 0.0
        train_mask = (item_idx < n_train[:, None]).astype(np.float32)
        val_mask = ((item_idx >= n_train[:, None]) & (item_idx < n_items[:, None])).astype(np.float32)

        def dev(a):
            return torch.from_numpy(a).to(device)

        X, mask = dev(Xs), dev(row_mask)
        train_maskd = dev(train_mask)

        # ---- per-member input scalers over the real rows ----
        scalers = _fit_scalers(X, mask, self.input_scaler)
        Xd = torch.where(mask[..., None] > 0, _transform_all(scalers, X), 0.0)

        # "auto" per module: never a variational kind with plain MSE
        loss = train_core.resolve_loss(self.loss, stack)
        bs = min(self.batch_size, padded_items)
        init_fn, epoch_fn = train_core.make_train_fns(
            stack, train_core.make_optimizer(self.optimizer, self.learning_rate), bs, loss=loss,
            kl_weight=self.kl_weight,
        )
        eval_fn = train_core.make_eval_fn(stack, bs, loss=loss, kl_weight=self.kl_weight) if use_val else None
        val_maskd = dev(val_mask) if use_val else None

        # ---- stacked init (a member's draws depend on its position among
        # the real members only), then the warm starts ----
        positions = [i % M_real for i in range(M)]
        generators = [train_core.member_generator(self.seed, p) for p in positions]
        params = stack.init(generators)
        for i, n in enumerate(src):
            if n in self._initial_params:
                try:
                    params[i] = stack.from_state_dicts([self._initial_params[n]])[0]
                except (KeyError, ValueError) as exc:
                    raise ValueError(f"initial_params[{n!r}]: {exc}") from None
        state = init_fn(generators, device, params=params)

        hp = self._member_hparams

        def mvec(key, base):
            return [hp.get(n, {}).get(key, base) for n in src]

        lr = torch.tensor(mvec("learning_rate", self.learning_rate), dtype=torch.float32, device=device)
        es_enabled = self.early_stopping_patience is not None
        p0 = patience = best = best_params = None
        if es_enabled:
            p0 = torch.tensor(mvec("early_stopping_patience", self.early_stopping_patience),
                              dtype=torch.int32, device=device)
            patience = p0.clone()
            best = torch.full((M,), torch.inf, device=device)
        active = torch.ones(M, dtype=torch.bool, device=device)
        has_val_d = torch.from_numpy(has_val).to(device)
        delta = self.early_stopping_min_delta

        histories: List[List[float]] = [[] for _ in range(M)]
        histories_val: List[List[float]] = [[] for _ in range(M)]

        # ---- preemption recovery: resume a matching interrupted run ----
        ckpt = None
        start_epoch = 0
        if self.checkpoint_dir:
            key = bucket_checkpoint_key(
                [
                    self.model_type,
                    # lookback shapes only the sequence families' training
                    self.lookback_window if stack.windowed else None,
                    self.kind, sorted(self.factory_kwargs.items()), self.compute_dtype,
                    self.input_scaler, loss, self.kl_weight, n_features, padded_items, list(names),
                    self.epochs, self.batch_size, self.learning_rate,
                    sorted((n, sorted(h.items())) for n, h in hp.items() if n in names),
                    sorted(n for n in self._initial_params if n in names),
                    self.optimizer, self.early_stopping_patience, self.early_stopping_min_delta,
                    self.validation_split, self.seed,
                    1,  # the member axis' width: one card
                    self.host_sync_every,
                ],
                data=(arrays[n] for n in names),
            )
            # the archive is written while the next epochs train; a
            # preemption loses at most the one uncommitted save
            ckpt = FleetBucketCheckpoint(self.checkpoint_dir, key)
            self._active_ckpt = ckpt
            resumed = ckpt.restore()
            if resumed is not None:
                try:
                    state, best_params, es, histories, histories_val = _restore_bucket(
                        resumed, state, M, es_enabled, device)
                    active = es["active"]
                    if es_enabled:
                        best, patience = es["best"], es["patience"]
                    start_epoch = int(resumed["epoch"]) + 1
                    if es_enabled and not bool(active.any()):
                        # every member had stopped at the save: nothing to run
                        start_epoch = self.epochs
                except Exception:
                    # a checkpoint of another layout: nothing was replaced
                    # (the restore checks every piece before it returns)
                    logger.warning("Fleet checkpoint structure mismatch; training from scratch",
                                   exc_info=True)

        def save_checkpoint(epoch: int) -> None:
            t_ck = time.monotonic()
            try:
                generators = torch.stack([g.get_state() for g in state.generators])
                generators_s = time.monotonic() - t_ck
                tosave = {
                    "params": state.params,
                    "opt": {k: v for k, v in state.opt_state._asdict().items() if v is not None},
                    "generators": generators,
                    "active": active,
                }
                if es_enabled:
                    tosave.update(best=best, patience=patience)
                if best_params is not None:
                    tosave["best_params"] = best_params
                ckpt.save(epoch, tosave, {"histories": histories, "histories_val": histories_val})
            except Exception:
                # best effort: a full volume (or a checkpoint.write fault)
                # costs resumability, not the training it protects
                logger.warning("fleet checkpoint save failed at epoch %d; training continues without it",
                               epoch, exc_info=True)
                self._trace_checkpoint(t_ck, epoch, error=True)
            else:
                self._trace_checkpoint(t_ck, epoch, generators_s=generators_s, **ckpt.last_save_seconds)

        pending: List[Tuple[torch.Tensor, ...]] = []  # per epoch: (loss, val, active before)
        epoch_times: List[float] = []
        t_sync = time.time()

        def sync(last: int) -> None:
            """Read the pending epochs' rows on the host into the histories,
            then the callback and, on its cadence, the checkpoint (JAX
            ``after_epochs``, ``fleet.py:1475-1500``)."""
            nonlocal t_sync
            first = last + 1 - len(pending)
            rows = torch.stack([torch.stack([l, v, a.float()]) for l, v, a in pending]).cpu().numpy()
            now = time.time()
            epoch_times.extend([(now - t_sync) / len(pending)] * len(pending))
            t_sync = now
            for loss_row, val_row, act_row in rows:
                for i in range(M):
                    if act_row[i] > 0:
                        histories[i].append(float(loss_row[i]))
                        if use_val and has_val[i]:
                            histories_val[i].append(float(val_row[i]))
            pending.clear()
            n_active = int(active.sum())
            self._g_members_active.set(n_active)
            if self.epoch_callback is not None:
                self.epoch_callback({
                    # "padded_rows" names the bucket's padded items, as in JAX
                    "n_features": n_features, "padded_rows": padded_items, "epoch": last,
                    "losses": rows[-1][0][:M_real], "n_active": n_active,
                })
            crossed = (last + 1) // self.checkpoint_every > first // self.checkpoint_every
            if ckpt is not None and crossed and last + 1 < self.epochs:
                save_checkpoint(last)

        for epoch in range(start_epoch, self.epochs):
            active_pre = active
            new_state, losses = epoch_fn(state, Xd, Xd, train_maskd, lr, n_real=n_train)
            if es_enabled:  # stopped members keep their parameters and optimizer state
                keep = active[:, None]
                state = train_core.TrainState(
                    torch.where(keep, new_state.params, state.params),
                    train_core.OptState(*(
                        None if n is None else torch.where(keep if n.dim() == 2 else active, n, o)
                        for n, o in zip(new_state.opt_state, state.opt_state)
                    )),
                    state.generators,
                )
            else:
                state = new_state
            losses = torch.where(active_pre, losses, torch.nan)
            vals = torch.full_like(losses, torch.nan)
            monitored = losses
            if use_val:
                vals = torch.where(active_pre, eval_fn(state.params, Xd, Xd, val_maskd), torch.nan)
                monitored = torch.where(has_val_d, vals, losses)
            if es_enabled:
                improved = (monitored < best - delta) & active
                best = torch.where(improved, monitored, best)
                best_params = (state.params.clone() if best_params is None
                               else torch.where(improved[:, None], state.params, best_params))
                patience = torch.where(improved, p0, patience - active.int())
                # a member stops only after a non-improving epoch exhausts
                # its patience (patience 0 included)
                active = active & ~((patience <= 0) & ~improved)
            pending.append((losses, vals, active_pre))
            last = epoch + 1 == self.epochs
            if last or len(pending) >= self.host_sync_every:
                sync(epoch)
                if es_enabled and not bool(active.any()):
                    logger.info("All %d models early-stopped by epoch %d", M, epoch + 1)
                    break

        if ckpt is not None:
            # commit the save in flight: a preemption in the error pass
            # below resumes from it
            ckpt.flush()

        final = best_params if es_enabled else state.params
        if stack.windowed:
            err, feat, tot = _seq_error_scalers(stack, final, Xd, dev(item_mask),
                                                self.threshold_quantile, bs)
        else:
            err, feat, tot = _error_scalers(stack, final, Xd, mask, self.threshold_quantile)
        states = stack.state_dicts(final[:M_real])
        scalers_np = [a[:M_real].cpu().numpy() for a in scalers]
        err_np = [a[:M_real].cpu().numpy() for a in err]
        feat, tot = feat[:M_real].cpu().numpy(), tot[:M_real].cpu().numpy()
        out = {}
        for i, name in enumerate(names):
            history = {"loss": histories[i]}
            if use_val and has_val[i]:
                history["val_loss"] = histories_val[i]
            out[name] = FleetMemberModel(
                name=name, kind=self.kind,
                factory_kwargs=dict(self.factory_kwargs, compute_dtype=self.compute_dtype),
                n_features=n_features, params=states[i],
                scaler=ScalerParams(scalers_np[0][i], scalers_np[1][i]),
                error_scaler=ScalerParams(err_np[0][i], err_np[1][i]),
                history=history, tags=self._tags.get(name),
                feature_thresholds=feat[i], total_threshold=float(tot[i]),
                scaler_kind=self.input_scaler, model_type=self.model_type,
                lookback_window=self.lookback_window, loss=self.loss,
                kl_weight=self.kl_weight, threshold_quantile=self.threshold_quantile,
                require_thresholds=self.require_thresholds,
                threshold_method=_threshold_method(stack, self.threshold_quantile),
                device=self.device,
            )
        # cleared only once the results are on the host: a preemption in
        # the error pass above resumes from the last save
        if ckpt is not None:
            ckpt.clear()
        return out, [round(t, 4) for t in epoch_times], M
