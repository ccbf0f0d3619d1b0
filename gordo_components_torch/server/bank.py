"""Card-resident model bank: many detectors, one batched program per bucket.

Counterpart of ``gordo_components_tpu/server/bank.py`` (single device). Every
detector in the collection is stacked into a bucket keyed by (registry type,
kind, n_features, lookback, target offset, factory kwargs): per-layer
weights with a leading member axis (the Flax layout) and the four scaler
stacks ``(M, F)`` live on the card. A coalesced batch of requests for any
members of a bucket becomes one pass. For a dense bucket:

    gather by idx -> input affine -> one torch.bmm per Dense layer
    -> banked_anomaly_score_packed (the anomaly-score CUDA kernel)

and for an LSTM bucket, with the batch slots as the member axis:

    gather by idx -> input affine -> sliding windows
    -> lstm_time_major_forward (one fused-LSTM-step kernel launch per layer)
    -> banked_anomaly_score_packed on the targets from row ``offset`` on

The kernel writes the batch's whole result (reconstruction, diff, scaled
and the two norms of every slot) into one buffer, which goes to the host in
one copy.

Request shapes are padded to powers of two in batch (B) and rows (T), as in
the JAX bank; long requests are chunked at ``max_rows_per_call``, and
sequence chunks overlap by the warm-up ``offset`` so no output row is lost.

Precision: on the card the bank computes in full float32 like the JAX
reference — :func:`~gordo_components_torch.device.resolve_device` sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``.

Not in this slice: the device mesh, quantized banks, the goodput ledger,
access heat, the buffer arena and the in-flight pipeline.
"""

import json
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gordo_components_torch.device import resolve_device
from gordo_components_torch.models import lookup_factory
from gordo_components_torch.models.factories.lstm import LSTMStack
from gordo_components_torch.ops.score import banked_anomaly_score_packed
from gordo_components_torch.ops.seq_scan import lstm_time_major_forward
from gordo_components_torch.ops.windows import sliding_windows

logger = logging.getLogger(__name__)


@dataclass
class _BankEntry:
    """One detector's bankable pieces, as numpy arrays.

    ``params`` is the ``nn.Module`` state dict of the registry's factory
    (dense: ``layers.{i}.weight`` (out, in), ``layers.{i}.bias`` (out,);
    LSTM: see ``convert.lstm_from_flax``); ``in_shift``/``in_scale`` compose
    the input affine scalers, ``err_shift``/``err_scale`` are the error
    scaler. Sequence models score windows of ``lookback`` rows, and
    ``target_offset`` is 1 for a t+1 forecast."""

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

    @property
    def offset(self) -> int:
        """Output row i belongs to input row ``i + offset``."""
        return self.lookback - 1 + self.target_offset

    def bucket_key(self) -> str:
        return json.dumps(
            [self.registry_type, self.kind, self.n_features, self.lookback,
             self.target_offset, sorted(self.factory_kwargs.items())],
            default=str,
        )


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _prev_pow2(n: int) -> int:
    return 1 << (int(n).bit_length() - 1)


def _stack(arrays, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.stack(arrays), np.float32)).to(device)


class _Bucket:
    """All members sharing (type, kind, n_features, lookback, target offset,
    factory kwargs): the stacked weights and scalers on the card, and the
    batched forward. This base holds the scalers and the epilogue; the
    subclasses the network."""

    def __init__(self, entries: Sequence[_BankEntry], module, device: torch.device):
        first = entries[0]
        self.n_features = first.n_features
        self.lookback, self.target_offset = first.lookback, first.target_offset
        self.offset = first.offset
        self.label = f"{first.registry_type}:{first.kind}:f{first.n_features}:l{first.lookback}"
        if first.target_offset:
            self.label += f":o{first.target_offset}"
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
    """Dense autoencoders: one ``torch.bmm`` per layer over the stacked
    ``(M, in, out)`` weights (the Flax layout)."""

    def __init__(self, entries: Sequence[_BankEntry], module, device: torch.device):
        super().__init__(entries, module, device)
        self.activations = module.activations
        n_layers = len(module.layers)
        self.weights = [
            _stack([e.params[f"layers.{i}.weight"].T for e in entries], device)
            for i in range(n_layers)
        ]
        self.biases = [
            _stack([e.params[f"layers.{i}.bias"] for e in entries], device)
            for i in range(n_layers)
        ]

    def forward(self, idx, h):
        for W, b, act in zip(self.weights, self.biases, self.activations):
            h = act(torch.bmm(h, W.index_select(0, idx)) + b.index_select(0, idx)[:, None, :])
        return h


class _LSTMBucket(_Bucket):
    """LSTM stacks: each layer's ``Wi``/``Wh``/``b`` and the head stacked
    ``(M, ...)``; a batch gathers its slots' members and runs the time-major
    forward with the slots as the member axis and the windows as the batch."""

    def __init__(self, entries: Sequence[_BankEntry], module, device: torch.device):
        super().__init__(entries, module, device)
        self.funcs, self.out_func = module.funcs, module.out_func
        self.layers = [
            tuple(_stack([e.params[f"layers.{i}.{p}"] for e in entries], device)
                  for p in ("Wi", "Wh", "b"))
            for i in range(len(module.layers))
        ]
        self.head = tuple(
            _stack([e.params[f"head.{p}"] for e in entries], device) for p in ("kernel", "bias")
        )

    def forward(self, idx, xs):
        W = sliding_windows(xs, self.lookback)  # (B, T - lookback + 1, L, F)
        W = W[:, : W.shape[1] - self.target_offset]
        weights = (
            [tuple(a.index_select(0, idx) for a in layer) for layer in self.layers],
            tuple(a.index_select(0, idx) for a in self.head),
        )
        return lstm_time_major_forward(weights, W, self.funcs, self.out_func)


def _make_bucket(entries: Sequence[_BankEntry], device: torch.device) -> _Bucket:
    first = entries[0]
    module = lookup_factory(first.registry_type, first.kind)(
        first.n_features, **first.factory_kwargs
    )
    cls = _LSTMBucket if isinstance(module, LSTMStack) else _DenseBucket
    return cls(entries, module, device)


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


class ModelBank:
    """Stacked scoring bank over a collection of detectors, on one device.

    ``device`` defaults to ``"cuda"`` and raises without CUDA unless
    ``"cpu"`` is passed. On the card, float32 matrix products run in full
    float32 (TF32 off for matmul and cuDNN), like the JAX reference."""

    def __init__(self, max_rows_per_call: int = 8192, device="cuda"):
        self.device = resolve_device(device)
        self.max_rows = int(max_rows_per_call)
        self._buckets: Dict[str, _Bucket] = {}
        self._index: Dict[str, Tuple[str, int]] = {}  # name -> (bucket key, i)
        self._tags: Dict[str, List[str]] = {}

    @classmethod
    def from_entries(cls, entries: Sequence[_BankEntry], **kwargs) -> "ModelBank":
        bank = cls(**kwargs)
        grouped: Dict[str, List[_BankEntry]] = {}
        for e in entries:
            if e.name in bank._index:
                raise ValueError(f"duplicate model name {e.name!r}")
            group = grouped.setdefault(e.bucket_key(), [])
            bank._index[e.name] = (e.bucket_key(), len(group))
            bank._tags[e.name] = (
                list(e.tags) if e.tags else [f"feature-{i}" for i in range(e.n_features)]
            )
            group.append(e)
        for key, group in grouped.items():
            bank._buckets[key] = _make_bucket(group, bank.device)
        logger.info("Model bank: %d models in %d bucket(s) on %s",
                    len(bank._index), len(bank._buckets), bank.device)
        return bank

    def __contains__(self, name: str) -> bool:
        return name in self._index

    @property
    def n_buckets(self) -> int:
        return len(self._buckets)

    def coverage(self) -> Dict[str, Any]:
        return {
            "banked": len(self._index),
            "n_buckets": len(self._buckets),
            "device": str(self.device),
        }

    def score(self, name: str, X: np.ndarray, y: Optional[np.ndarray] = None) -> ScoreResult:
        return self.score_many([(name, X, y)])[0]

    def score_many(self, requests: Sequence[Request]) -> List[ScoreResult]:
        """Score a heterogeneous batch of (name, X, y) requests: one batched
        pass per bucket. Raises on the first invalid request (unknown
        model, wrong width, empty input, y of another shape)."""
        by_bucket: Dict[str, List[int]] = {}
        for ri, (name, _X, _y) in enumerate(requests):
            entry = self._index.get(name)
            if entry is None:
                raise KeyError(f"Model {name!r} not in bank")
            by_bucket.setdefault(entry[0], []).append(ri)
        results: List[Any] = [None] * len(requests)
        for key, req_ids in by_bucket.items():
            self._score_group(self._buckets[key], req_ids, requests, results)
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
