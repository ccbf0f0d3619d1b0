"""Card-resident model bank: many detectors, one batched program per bucket.

Counterpart of ``gordo_components_tpu/server/bank.py`` (single device). Every
detector in the collection is stacked into a bucket keyed by (registry type,
kind, n_features, lookback, target offset, factory kwargs, compute
dtype): per-layer
weights with a leading member axis (the Flax layout) and the four scaler
stacks ``(M, F)`` live on the card. A coalesced batch of requests for any
members of a bucket becomes one pass. For a dense bucket (a feedforward
autoencoder, or a variational one's mean decode ``enc_i -> mu -> dec_j ->
out``):

    gather by idx -> input affine -> one torch.bmm per Dense layer
    -> banked_anomaly_score_packed (the anomaly-score CUDA kernel)

for an LSTM bucket, with the batch slots as the member axis:

    gather by idx -> input affine -> sliding windows
    -> lstm_time_major_forward (one fused-LSTM-step kernel launch per layer)
    -> banked_anomaly_score_packed on the targets from row ``offset`` on

and for a conv bucket the same with the conv autoencoder's layers (one
``torch.baddbmm`` a layer over the taps of every window) in place of the
LSTM.

Models the bank cannot hold (anything but a fitted
``DiffBasedAnomalyDetector`` over one of the bankable estimator classes
with affine scaler steps) are left out of :meth:`ModelBank.from_models`
with a reason in ``bank.fallback``, and the server scores them through
their own ``predict``/``anomaly`` (the per-model path). A bucket whose
build fails is left out the same way, its members under ``fallback`` and
its error under ``finalize_failures``.

The kernel writes the batch's whole result (reconstruction, diff, scaled
and the two norms of every slot) into one buffer, which goes to the host in
one copy.

Request shapes are padded to powers of two in batch (B) and rows (T), as in
the JAX bank; long requests are chunked at ``max_rows_per_call``, and
sequence chunks overlap by the warm-up ``offset`` so no output row is lost.

Precision: a bucket computes in its entries' ``compute_dtype``. A float32
bucket computes in full float32 like the JAX reference —
:func:`~gordo_components_torch.device.resolve_device` turns TF32 off for
matmul and cuDNN on the card — and a bfloat16 bucket as Flax's
``dtype=bfloat16`` does, its products reduced in float32 (the same call
turns off cuBLAS's reduced-precision bfloat16 reduction). A bfloat16 bucket
casts its stacked weights to bfloat16 once, at build: the values Flax's
cast gives on every forward, at half the bytes a batch gathers. The
network's output is float32 in both, and so is the score.

Metrics (``observability/metrics.py``, the app's registry): per bucket
its calls, requests and coalesced batch sizes, and the gauges of members
and buckets, as the JAX bank names them. :meth:`ModelBank.score_many`
checks a batch's deadline between bucket groups and, for the batching
engine, returns a failed group's errors in place of its results.

Not in this slice: the device mesh, quantized banks, the goodput ledger,
access heat, the buffer arena, the in-flight pipeline and the placement
planner's per-model row counts, and with them the JAX bank's shard,
arena, in-flight, quantize, weight-bytes and generation series.
"""

import hashlib
import json
import logging
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from gordo_components_torch.device import resolve_device
from gordo_components_torch.models import lookup_factory
from gordo_components_torch.models.factories.conv import conv_autoencoder_forward
from gordo_components_torch.models.register import by_family
from gordo_components_torch.observability.metrics import get_registry
from gordo_components_torch.ops.dense import dense_chain
from gordo_components_torch.ops.score import banked_anomaly_score_packed
from gordo_components_torch.ops.seq_scan import lstm_time_major_forward
from gordo_components_torch.ops.windows import sliding_windows
from gordo_components_torch.resilience.deadline import Deadline, DeadlineExceeded

logger = logging.getLogger(__name__)


@dataclass
class _BankEntry:
    """One detector's bankable pieces, as numpy arrays.

    ``params`` is the ``nn.Module`` state dict of the registry's factory
    (dense: ``layers.{i}.weight`` (out, in), ``layers.{i}.bias`` (out,);
    LSTM, conv, variational: see ``convert``); ``in_shift``/``in_scale`` compose
    the input affine scalers, ``err_shift``/``err_scale`` are the error
    scaler. Sequence models score windows of ``lookback`` rows, and
    ``target_offset`` is 1 for a t+1 forecast. ``compute_dtype`` is the
    model's (float32 or bfloat16); it keys the bucket."""

    name: str
    registry_type: str
    kind: str
    factory_kwargs: Dict[str, Any]
    n_features: int
    params: Dict[str, np.ndarray]
    in_shift: np.ndarray
    in_scale: np.ndarray
    err_shift: np.ndarray
    err_scale: np.ndarray
    tags: List[str] = field(default_factory=list)
    thresholds: Optional[Dict[str, Any]] = None
    lookback: int = 1
    target_offset: int = 0
    compute_dtype: str = "float32"

    @property
    def offset(self) -> int:
        """Output row i belongs to input row ``i + offset``."""
        return self.lookback - 1 + self.target_offset

    def bucket_key(self) -> str:
        return json.dumps(
            [self.registry_type, self.kind, self.n_features, self.lookback,
             self.target_offset, sorted(self.factory_kwargs.items()), self.compute_dtype],
            default=str,
        )

    def bucket_label(self) -> str:
        """The bucket's name in logs and ``finalize_failures``."""
        label = f"{self.registry_type}:{self.kind}:f{self.n_features}:l{self.lookback}"
        if self.target_offset:
            label += f":o{self.target_offset}"
        if self.compute_dtype != "float32":
            # JAX bank.py:293-298: a bfloat16 bucket is another program and
            # another metric series than a float32 one of the same kwargs
            extra = json.dumps([sorted(self.factory_kwargs.items()), self.compute_dtype], default=str)
            label += ":" + hashlib.sha1(extra.encode()).hexdigest()[:6]
        return label


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _prev_pow2(n: int) -> int:
    return 1 << (int(n).bit_length() - 1)


def _stack(arrays, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.stack(arrays), np.float32)).to(device, dtype)


class _Bucket:
    """All members sharing (type, kind, n_features, lookback, target offset,
    factory kwargs, compute dtype): the stacked weights (in the compute
    dtype) and scalers (float32) on the card, and the batched forward. This
    base holds the scalers and the epilogue; the subclasses the network."""

    def __init__(self, entries: Sequence[_BankEntry], module, device: torch.device):
        first = entries[0]
        self.n_features = first.n_features
        self.lookback, self.target_offset = first.lookback, first.target_offset
        self.offset = first.offset
        self.label = first.bucket_label()
        self.dtype = module.compute_dtype
        self.in_shift, self.in_scale, self.err_shift, self.err_scale = (
            _stack([getattr(e, f) for e in entries], device)
            for f in ("in_shift", "in_scale", "err_shift", "err_scale")
        )
        want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        got = {k: np.shape(v) for k, v in first.params.items()}
        if got != want:
            raise ValueError(f"bucket {self.label}: params {got}, factory wants {want}")

    def forward(self, idx: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
        """idx (B,); xs (B, T, F) input-scaled -> (B, T - offset, F)."""
        raise NotImplementedError

    @torch.no_grad()
    def score_batch(self, idx: torch.Tensor, X: torch.Tensor, Y: torch.Tensor):
        """idx (B,) int32; X, Y (B, T, F) raw-space, on the bank's device.
        Returns the packed (B, 3*n*F + 2*n) result for the n = T - offset
        output rows of each slot: recon, diff, scaled, tot_u, tot_s back to
        back in each slot's row (``ops.score.unpack_banked`` views them)."""
        sh = self.in_shift.index_select(0, idx)[:, None, :]
        sc = self.in_scale.index_select(0, idx)[:, None, :]
        recon = self.forward(idx, (X - sh) * sc)
        off = self.offset
        target = ((Y[:, off:] - sh) * sc).contiguous()
        return banked_anomaly_score_packed(
            target, recon.contiguous(), self.err_shift, self.err_scale, idx
        )


class _DenseBucket(_Bucket):
    """Dense chains over the stacked ``(M, in, out)`` kernels (the Flax
    layout), the layers and activations from the module's
    ``serving_chain`` (a feedforward autoencoder's layers, or a variational
    one's mean decode); a batch gathers its slots' layers and runs
    ``ops.dense.dense_chain`` with the slots as the member axis."""

    def __init__(self, entries: Sequence[_BankEntry], module, device: torch.device):
        super().__init__(entries, module, device)
        chains = [module.serving_chain(e.params) for e in entries]
        dt = self.dtype
        self.layers = [
            (_stack([c[i][0] for c in chains], device, dt), _stack([c[i][1] for c in chains], device, dt), act)
            for i, (_W, _b, act) in enumerate(chains[0])
        ]

    def forward(self, idx, h):
        return dense_chain(h, [(W.index_select(0, idx), b.index_select(0, idx), act)
                               for W, b, act in self.layers], self.dtype).float()


class _LSTMBucket(_Bucket):
    """LSTM stacks: each layer's ``Wi``/``Wh``/``b`` and the head stacked
    ``(M, ...)``; a batch gathers its slots' members and runs the time-major
    forward with the slots as the member axis and the windows as the batch."""

    def __init__(self, entries: Sequence[_BankEntry], module, device: torch.device):
        super().__init__(entries, module, device)
        self.funcs, self.out_func = module.funcs, module.out_func
        self.layers = [
            tuple(_stack([e.params[f"layers.{i}.{p}"] for e in entries], device, self.dtype)
                  for p in ("Wi", "Wh", "b"))
            for i in range(len(module.layers))
        ]
        self.head = tuple(
            _stack([e.params[f"head.{p}"] for e in entries], device, self.dtype) for p in ("kernel", "bias")
        )

    def forward(self, idx, xs):
        W = sliding_windows(xs, self.lookback)  # (B, T - lookback + 1, L, F)
        W = W[:, : W.shape[1] - self.target_offset]
        weights = (
            [tuple(a.index_select(0, idx) for a in layer) for layer in self.layers],
            tuple(a.index_select(0, idx) for a in self.head),
        )
        return lstm_time_major_forward(weights, W, self.funcs, self.out_func, self.dtype)


class _ConvBucket(_Bucket):
    """Conv autoencoders: each layer's kernel ``(M, K, F_in, C)`` and bias
    stacked; a batch gathers its slots' members and runs every window of
    every slot through ``conv_autoencoder_forward`` with the slots as the
    member axis."""

    def __init__(self, entries: Sequence[_BankEntry], module, device: torch.device):
        super().__init__(entries, module, device)
        self.n_encoder, self.activation = len(module.channels), module.activation
        self.layers = [
            tuple(_stack([e.params[f"{name}.{p}"] for e in entries], device, self.dtype)
                  for p in ("kernel", "bias"))
            for name in module.layer_names()
        ]

    def forward(self, idx, xs):
        W = sliding_windows(xs, self.lookback)  # (B, T - lookback + 1, L, F), a view
        W = W[:, : W.shape[1] - self.target_offset]
        weights = [tuple(a.index_select(0, idx) for a in layer) for layer in self.layers]
        return conv_autoencoder_forward(weights, W, self.n_encoder, self.activation, self.dtype)


# the bucket of each model family (``models.register.by_family``)
_BUCKETS = {"dense": _DenseBucket, "vae": _DenseBucket, "lstm": _LSTMBucket, "conv": _ConvBucket}


def _make_bucket(entries: Sequence[_BankEntry], device: torch.device) -> _Bucket:
    first = entries[0]
    module = lookup_factory(first.registry_type, first.kind)(
        first.n_features, compute_dtype=first.compute_dtype, **first.factory_kwargs
    )
    return by_family(_BUCKETS, module, "bank bucket")(entries, module, device)


@dataclass
class ScoreResult:
    """Raw-space arrays for one request, sliced back to its true length.

    ``offset`` is the sequence warm-up: output row i belongs to input row
    ``i + offset`` (0 for feedforward). ``model_input`` holds the whole
    request; :meth:`to_arrays` trims it to the output rows."""

    tags: List[str]
    model_input: np.ndarray
    model_output: np.ndarray
    diff: np.ndarray
    scaled: np.ndarray
    total_unscaled: np.ndarray
    total_scaled: np.ndarray
    offset: int = 0

    def to_arrays(self) -> Dict[str, np.ndarray]:
        """The six anomaly column groups keyed like the reference frame."""
        n_out = len(self.model_output)
        return {
            "model-input": self.model_input[self.offset:][:n_out],
            "model-output": self.model_output,
            "tag-anomaly-unscaled": self.diff,
            "tag-anomaly-scaled": self.scaled,
            "total-anomaly-unscaled": self.total_unscaled,
            "total-anomaly-scaled": self.total_scaled,
        }


Request = Tuple[str, np.ndarray, Optional[np.ndarray]]


# estimator classes whose scoring the bank reproduces (JAX bank.py
# _BANKABLE_TYPES); the registry type is also the factory namespace
_BANKABLE_TYPES = {"AutoEncoder", "LSTMAutoEncoder", "LSTMForecast", "ConvAutoEncoder"}


def _extract_entry(name: str, model) -> Tuple[Optional[_BankEntry], Optional[str]]:
    """``(entry, None)`` for a model the bank can hold, else ``(None,
    reason)``, the reason worded as the JAX bank's ``_extract_entry``
    words it; :meth:`ModelBank.coverage` reports it."""
    from gordo_components_torch.models.anomaly.diff import DiffBasedAnomalyDetector

    if not isinstance(model, DiffBasedAnomalyDetector):
        return None, f"not a DiffBasedAnomalyDetector ({type(model).__name__})"
    if model.error_scaler_ is None:
        return None, "detector is unfitted (no error scaler)"
    if model.base_estimator is not None:  # a fitted detector, not a loaded one
        est = model._final_estimator
        if type(est).__name__ not in _BANKABLE_TYPES:
            return None, f"unsupported estimator class {type(est).__name__}"
        if getattr(est, "params_", None) is None:
            return None, "estimator is unfitted"
        step_name = model.non_affine_step
        if step_name is not None:
            return None, f"non-affine preprocessing step {step_name!r}"
    entry = model.to_entry(name)
    if entry.registry_type not in _BANKABLE_TYPES:
        return None, f"unsupported estimator class {entry.registry_type}"
    return entry, None


class ModelBank:
    """Stacked scoring bank over a collection of detectors, on one device.

    ``device`` defaults to ``"cuda"`` and raises without CUDA unless
    ``"cpu"`` is passed. On the card, float32 matrix products run in full
    float32 (TF32 off for matmul and cuDNN), like the JAX reference."""

    def __init__(self, max_rows_per_call: int = 8192, device="cuda", registry=None):
        self.device = resolve_device(device)
        self.max_rows = int(max_rows_per_call)
        self._buckets: Dict[str, _Bucket] = {}
        self._index: Dict[str, Tuple[str, int]] = {}  # name -> (bucket key, i)
        self._tags: Dict[str, List[str]] = {}
        # name -> why the model is scored on the per-model path
        self.fallback: Dict[str, str] = {}
        # bucket label -> error, for buckets whose build failed: their
        # members serve on the per-model path, and /healthz is "degraded"
        self.finalize_failures: Dict[str, str] = {}
        # 0 for the bank a server starts with; server/swap.py gives each
        # bank it swaps in the generation after the one it replaces
        self.generation = 0
        # metrics registry: None = the process default, False = none (the
        # uninstrumented control); a /reload's bank gets the app's, so the
        # counters go on across the swap
        if registry is None:
            registry = get_registry()
        elif registry is False:
            registry = None
        self.registry = registry
        self._m_bucket_calls = self._m_bucket_reqs = self._m_bucket_batch = None
        if registry is not None:
            self._m_bucket_calls = registry.counter(
                "gordo_bank_bucket_calls_total", "Batched XLA scoring dispatches per bucket", ("bucket",))
            self._m_bucket_reqs = registry.counter(
                "gordo_bank_bucket_requests_total", "Requests scored per bucket", ("bucket",))
            self._m_bucket_batch = registry.histogram(
                "gordo_bank_bucket_batch_size", "Coalesced chunks per batched XLA call, per bucket",
                ("bucket",), lo=1.0, hi=1e5)
            # through a weak reference: the registry outlives a swapped-out
            # bank, and must not pin its stacked weights on the card
            ref = weakref.ref(self)
            registry.gauge("gordo_bank_models", "Models resident in the HBM bank").labels().set_function(
                lambda: len(b._index) if (b := ref()) is not None else 0)
            registry.gauge("gordo_bank_buckets", "Compiled bucket programs in the bank").labels().set_function(
                lambda: len(b._buckets) if (b := ref()) is not None else 0)

    @classmethod
    def from_entries(cls, entries: Sequence[_BankEntry], **kwargs) -> "ModelBank":
        """A bank of bank entries; raises if a bucket cannot be built."""
        bank = cls(**kwargs)
        for key, group in bank._group(entries).items():
            bank._buckets[key] = _make_bucket(group, bank.device)
        logger.info("Model bank: %d models in %d bucket(s) on %s", len(bank), bank.n_buckets, bank.device)
        return bank

    @classmethod
    def from_models(cls, models: Mapping[str, Any], **kwargs) -> "ModelBank":
        """A bank of every model in ``models`` (name -> model) that it can
        hold; the others land in ``fallback`` with the reason. A bucket
        whose build fails is left out, its members under ``fallback`` and
        its error under ``finalize_failures``: every other bucket serves."""
        bank = cls(**kwargs)
        entries = []
        for name, model in models.items():
            try:
                entry, reason = _extract_entry(name, model)
            except Exception as exc:
                # one malformed model must not stop the bank's build
                logger.warning("Model %r: bank extraction failed; per-model path", name, exc_info=True)
                bank.fallback[name] = f"extraction error: {type(exc).__name__}: {exc}"
                continue
            if entry is None:
                bank.fallback[name] = reason or "not bankable"
            else:
                entries.append(entry)
        for key, group in bank._group(entries).items():
            try:
                bank._buckets[key] = _make_bucket(group, bank.device)
            except Exception as exc:
                label = group[0].bucket_label()
                logger.error("Bucket %s build FAILED (%d member(s) fall back to the per-model "
                             "path): %s", label, len(group), exc, exc_info=True)
                reason = f"bucket finalize failed: {type(exc).__name__}: {exc}"
                bank.finalize_failures[label] = reason
                for e in group:
                    del bank._index[e.name]
                    del bank._tags[e.name]
                    bank.fallback[e.name] = reason
        logger.info("Model bank: %d models in %d bucket(s) on %s", len(bank), bank.n_buckets, bank.device)
        if bank.fallback:
            logger.warning(
                "Model bank: %d/%d model(s) NOT banked (per-model path): %s",
                len(bank.fallback), len(bank.fallback) + len(bank._index),
                ", ".join(f"{n} ({r})" for n, r in sorted(bank.fallback.items())[:10])
                + (" ..." if len(bank.fallback) > 10 else ""),
            )
        return bank

    def _group(self, entries: Sequence[_BankEntry]) -> Dict[str, List[_BankEntry]]:
        """Index ``entries`` by name and group them by bucket key."""
        grouped: Dict[str, List[_BankEntry]] = {}
        for e in entries:
            if e.name in self._index:
                raise ValueError(f"duplicate model name {e.name!r}")
            group = grouped.setdefault(e.bucket_key(), [])
            self._index[e.name] = (e.bucket_key(), len(group))
            self._tags[e.name] = (
                list(e.tags) if e.tags else [f"feature-{i}" for i in range(e.n_features)]
            )
            group.append(e)
        return grouped

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def __len__(self) -> int:
        return len(self._index)

    @property
    def n_buckets(self) -> int:
        return len(self._buckets)

    def coverage(self) -> Dict[str, Any]:
        """The JAX bank's coverage keys (``banked`` a count here, as there),
        and the device the bank is on."""
        return {
            "banked": len(self._index),
            "fallback": dict(self.fallback),
            "n_buckets": len(self._buckets),
            "devices": 1,
            "device": str(self.device),
        }

    def score(self, name: str, X: np.ndarray, y: Optional[np.ndarray] = None) -> ScoreResult:
        return self.score_many([(name, X, y)])[0]

    def score_many(self, requests: Sequence[Request], deadline: Optional[Deadline] = None,
                   return_exceptions: bool = False) -> List[Any]:
        """Score a heterogeneous batch of (name, X, y) requests: one batched
        pass per bucket group. Raises on the first invalid request (unknown
        model, wrong width, empty input, y of another shape).

        ``deadline`` (the batch's earliest) is checked between bucket
        groups: once it has passed, no further group runs and
        :class:`DeadlineExceeded` is raised. With ``return_exceptions`` a
        failed group's requests (and those of the groups a deadline cut
        off) get their exception as their entry, while every other group's
        results stand."""
        results: List[Any] = [None] * len(requests)
        errors: Dict[int, Exception] = {}
        by_bucket: Dict[str, List[int]] = {}
        for ri, (name, _X, _y) in enumerate(requests):
            entry = self._index.get(name)
            if entry is None:
                exc = KeyError(f"Model {name!r} not in bank")
                if not return_exceptions:
                    raise exc
                errors[ri] = exc
                continue
            by_bucket.setdefault(entry[0], []).append(ri)
        groups = list(by_bucket.items())
        for gi, (key, req_ids) in enumerate(groups):
            if deadline is not None and deadline.expired():
                # the next group's device work would answer nobody
                exc = DeadlineExceeded(
                    f"batch deadline expired before all {len(groups)} bucket group(s) dispatched "
                    f"(budget {deadline.budget_s * 1e3:.0f}ms)")
                if not return_exceptions:
                    raise exc
                for _key, rids in groups[gi:]:
                    for ri in rids:
                        errors[ri] = exc
                break
            try:
                self._score_group(self._buckets[key], req_ids, requests, results)
            except Exception as exc:
                if not return_exceptions:
                    raise
                for ri in req_ids:
                    errors[ri] = exc
        for ri, exc in errors.items():
            results[ri] = exc
        return results

    def _score_group(self, bucket: _Bucket, req_ids, requests, results) -> None:
        F, off = bucket.n_features, bucket.offset
        rows, ys = [], []
        for ri in req_ids:
            name, X, y = requests[ri]
            X = np.asarray(X, np.float32)
            if X.ndim != 2 or X.shape[1] != F:
                raise ValueError(f"Request for {name!r}: expected (rows, {F}), got {X.shape}")
            if X.shape[0] == 0:
                raise ValueError(f"Request for {name!r}: empty input")
            if X.shape[0] <= off:
                raise ValueError(
                    f"Request for {name!r}: need more than {off} rows "
                    f"(sequence warm-up), got {X.shape[0]}"
                )
            Y = X if y is None else np.asarray(y, np.float32)
            if Y.shape != X.shape:
                raise ValueError(
                    f"Request for {name!r}: y shape {Y.shape} must match X shape {X.shape}"
                )
            rows.append(X)
            ys.append(Y)
        # rows per call: a power of two, at most max_rows but always at
        # least one window and one output row; longer requests are chunked,
        # each chunk overlapping the last by the warm-up, and chunk
        # [start, start + T) yields the output rows [start + off, start + T)
        T = min(_next_pow2(max(x.shape[0] for x in rows)), _prev_pow2(self.max_rows))
        T = max(T, _next_pow2(off + 1))
        step = T - off
        chunks = []  # (request position, member index, start)
        for pos, (ri, X) in enumerate(zip(req_ids, rows)):
            member = self._index[requests[ri][0]][1]
            for start in range(0, X.shape[0] - off, step):
                chunks.append((pos, member, start))
        B = _next_pow2(len(chunks))
        Xb = np.zeros((B, T, F), np.float32)
        Yb = np.zeros((B, T, F), np.float32)
        idx = np.zeros((B,), np.int32)
        for ci, (pos, member, start) in enumerate(chunks):
            xc = rows[pos][start:start + T]
            Xb[ci, : len(xc)] = xc
            Yb[ci, : len(xc)] = ys[pos][start:start + T]
            idx[ci] = member
        if self._m_bucket_calls is not None:
            self._m_bucket_calls.labels(bucket.label).inc()
            self._m_bucket_reqs.labels(bucket.label).inc(len(req_ids))
            self._m_bucket_batch.labels(bucket.label).record(float(len(chunks)))
        dev = self.device
        # one device-to-host copy of the packed result
        flat = bucket.score_batch(
            torch.from_numpy(idx).to(dev),
            torch.from_numpy(Xb).to(dev),
            torch.from_numpy(Yb).to(dev),
        ).cpu().numpy()
        n = T - off  # output rows per chunk
        shapes = [(B, n, F)] * 3 + [(B, n)] * 2
        widths = np.cumsum([0] + [int(np.prod(sh[1:])) for sh in shapes])
        recon, diff, scaled, tu, ts = (
            flat[:, a:b].reshape(sh) for a, b, sh in zip(widths[:-1], widths[1:], shapes)
        )
        per_req: Dict[int, List[int]] = {}
        for ci, (pos, _m, _s) in enumerate(chunks):
            per_req.setdefault(pos, []).append(ci)
        for pos, ri in enumerate(req_ids):
            n_out = rows[pos].shape[0] - off
            cis = per_req[pos]

            def take(a):
                return np.concatenate([a[ci] for ci in cis], axis=0)[:n_out].copy()

            results[ri] = ScoreResult(
                tags=self._tags[requests[ri][0]],
                model_input=rows[pos],
                model_output=take(recon),
                diff=take(diff),
                scaled=take(scaled),
                total_unscaled=take(tu),
                total_scaled=take(ts),
                offset=off,
            )
