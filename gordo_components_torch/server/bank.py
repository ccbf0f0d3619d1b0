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

Scoring is a three-stage pipeline over the bucket groups of a batch
(:meth:`ModelBank.score_many`, as the JAX bank's): pad a group into
buffers of a shape-keyed arena (``server/arena.py``; page-locked on the
card), enqueue its copies, forward, K2 and the copy back without
waiting, and slice its result once its event has completed, with up to
``GORDO_BANK_INFLIGHT`` groups in flight. A buffer goes back to the
arena only after the event recorded behind the copy that uses it.

Metrics (``observability/metrics.py``, the app's registry): per bucket
its calls, requests and coalesced batch sizes, the gauges of members
and buckets, and the arena's hits, misses and bytes and the groups in
flight, as the JAX bank names them. With a goodput ledger
(``observability/goodput.py``) each group's device window is split into
useful and padded seconds and each result carries its share
(``ScoreResult.device_s``); :meth:`ModelBank.flops_stats` feeds the cost
model (``observability/cost.py``). With the app's heat accountant
(``observability/heat.py``) each request's rows go to its mailbox.
:meth:`ModelBank.score_many` checks a batch's deadline between bucket
groups and, for the batching engine, returns a failed group's errors in
place of its results. Under ``GORDO_PROFILE_DIR`` a traced group is
captured by the profiler (``utils/profiling.py``) as
``serve-<trace id>``, waiting for its work inside the capture, and its
``device_execute`` span carries the capture's directory as ``profile``.

Storage (``bank_dtype``, ``GORDO_BANK_DTYPE``; ``ops/quantize.py``): a
bucket keeps its stacked weights in float32 (the identity: stacked in the
compute dtype, as above), bfloat16 or int8 codes with per-member scales,
quantized from the float32 parameters. A forward gathers its slots' codes
and scales and dequantizes them to float32, then to the compute dtype: the
stack is never expanded whole, and K2 and K3 see the dequantized weights.
A quantization that fails (the ``bank.quantize`` fault point fires before
it) leaves that bucket in float32 storage, named in
``quantize_fallbacks`` and counted by
``gordo_bank_quantize_fallback_total``; :meth:`ModelBank.capacity_stats`
and the ``gordo_bank_weight_bytes``/``gordo_bank_models_per_gb`` gauges
report the bytes stored.

With a ``mesh`` (``parallel/mesh.py``, more than one shard) every bucket's
stacks are split over the mesh's devices in contiguous blocks, padded to a
multiple of its size by repeating the last member (:class:`_ShardedBucket`),
and requests are routed: the host puts each chunk in the batch of the shard
that owns its member, at the member's shard-local index, pads every shard
to the largest shard's load, and each shard runs its forward and K2 on its
own device against its own stacks. A shard whose device is missing raises
when the mesh is built. The results are those of the unsharded bank at the
same batch composition. ``model_rows`` (member -> routed rows) is the
placement planner's load signal, :meth:`ModelBank.placement` the live
member -> shard assignment, and the ``gordo_bank_shard_*`` counters count
each shard's routed rows, pad rows and chunks (label ``"0"`` unsharded, as
the JAX bank's).
"""

import contextlib
import hashlib
import json
import logging
import os
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from gordo_components_torch.device import resolve_device
from gordo_components_torch.models import lookup_factory
from gordo_components_torch.models.factories.conv import conv_autoencoder_forward
from gordo_components_torch.models.register import by_family
from gordo_components_torch.observability.cost import estimate_flops_per_row
from gordo_components_torch.observability.metrics import get_registry
from gordo_components_torch.ops.dense import dense_chain
from gordo_components_torch.ops.quantize import (
    normalize_bank_dtype,
    quantize_stack,
    storage_dtype,
    take,
    tree_weight_bytes,
)
from gordo_components_torch.ops.score import banked_anomaly_score_packed
from gordo_components_torch.ops.seq_scan import lstm_time_major_forward
from gordo_components_torch.ops.windows import sliding_windows
from gordo_components_torch.parallel.mesh import pad_count_to_mesh, shard_blocks
from gordo_components_torch.resilience.deadline import Deadline, DeadlineExceeded
from gordo_components_torch.resilience.faults import faultpoint
from gordo_components_torch.server.arena import PaddedArena
from gordo_components_torch.utils.profiling import PROFILE_DIR_ENV, maybe_profile, profile_path

logger = logging.getLogger(__name__)

# a bucket whose build fails serves its members on the per-model path; a
# dispatch that fails counts toward its models' quarantine
_FP_FINALIZE = faultpoint("bank.finalize")
_FP_SCORE = faultpoint("bank.score")
# a bucket whose quantization fails serves from float32 storage
_FP_QUANTIZE = faultpoint("bank.quantize")

# the storage dtype's tag in a bucket label (JAX bank.py _DTYPE_TAGS)
_DTYPE_TAGS = {"bfloat16": "bf16", "int8": "int8"}


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

    def bucket_label(self, bank_dtype: str = "float32") -> str:
        """The bucket's name in logs, metrics and ``finalize_failures``;
        a bank below float32 storage tags it ``:qbf16`` or ``:qint8``, even
        where the quantization falls back (JAX bank.py:286-291)."""
        label = f"{self.registry_type}:{self.kind}:f{self.n_features}:l{self.lookback}"
        if self.target_offset:
            label += f":o{self.target_offset}"
        if bank_dtype != "float32":
            label += f":q{_DTYPE_TAGS.get(bank_dtype, bank_dtype)}"
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
    return torch.from_numpy(_np_stack(arrays)).to(device, dtype)


def _np_stack(arrays) -> np.ndarray:
    return np.ascontiguousarray(np.stack(arrays), np.float32)


class _Bucket:
    """All members sharing (type, kind, n_features, lookback, target offset,
    factory kwargs, compute dtype): the stacked weights (stored in the
    bank's dtype, ``ops/quantize.py``) and scalers (float32) on the card,
    and the batched forward. This base holds the scalers, the weights'
    storage and the epilogue; the subclasses name their weight stacks
    (:meth:`_stacks`) and run the network on the gathered ones."""

    def __init__(self, entries: Sequence[_BankEntry], module, device: torch.device,
                 bank_dtype: str = "float32"):
        first = entries[0]
        self.device = device
        # the members in stack order; an unsharded bucket is its own one shard
        self.names = [e.name for e in entries]
        self.n_shards, self.shard_size = 1, len(entries)
        self.n_features = first.n_features
        self.lookback, self.target_offset = first.lookback, first.target_offset
        self.offset = first.offset
        self.label = first.bucket_label(bank_dtype)
        self.dtype = module.compute_dtype
        self.bank_dtype = bank_dtype
        self.in_shift, self.in_scale, self.err_shift, self.err_scale = (
            _stack([getattr(e, f) for e in entries], device)
            for f in ("in_shift", "in_scale", "err_shift", "err_scale")
        )
        want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        got = {k: np.shape(v) for k, v in first.params.items()}
        if got != want:
            raise ValueError(f"bucket {self.label}: params {got}, factory wants {want}")
        # the cost model's static numbers, once a bucket
        self.registry_type, self.kind, self.members = first.registry_type, first.kind, len(entries)
        self.params_per_member = int(sum(np.size(v) for v in first.params.values()))
        self.flops_per_row, self.flops_method = estimate_flops_per_row(
            module, self.n_features, self.lookback, self.params_per_member)
        self._store(self._stacks(entries, module), device)

    def _stacks(self, entries: Sequence[_BankEntry], module) -> Dict[str, Tuple[np.ndarray, int]]:
        """name -> (the float32 stack (M, ...), its int8 segments: the JAX
        leaves its last axis concatenates)."""
        raise NotImplementedError

    def _store(self, stacks: Dict[str, Tuple[np.ndarray, int]], device: torch.device) -> None:
        """Store the stacks in the bank's dtype (JAX ``_Bucket.finalize``'s
        quantization): ``weights`` name -> the stored stack,
        ``weight_bytes_fp32`` the float32 stacks' bytes, ``weight_bytes``
        the stored ones', ``effective_dtype`` the storage dtype; a failed
        quantization stores float32, its error in ``quantize_error``."""
        self.weight_bytes_fp32 = int(sum(a.nbytes for a, _ in stacks.values()))
        self.quantize_error: Optional[str] = None
        weights = None
        if self.bank_dtype != "float32":
            try:
                _FP_QUANTIZE.fire()
                weights = {k: quantize_stack(a, self.bank_dtype, device, self.dtype, seg)
                           for k, (a, seg) in stacks.items()}
            except Exception as exc:
                self.quantize_error = f"{type(exc).__name__}: {exc}"
                logger.warning("Bucket %s: %s quantization failed (%s); storing float32 for this bucket",
                               self.label, self.bank_dtype, exc)
        if weights is None:
            weights = {k: quantize_stack(a, "float32", device, self.dtype) for k, (a, _) in stacks.items()}
        self.weights = weights
        self.effective_dtype = storage_dtype(list(weights.values()))
        self.weight_bytes = tree_weight_bytes(weights.values())

    @property
    def shards(self) -> Tuple["_Bucket"]:
        return (self,)  # a property: an attribute would make a reference cycle

    def input_scaler(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Member ``i``'s composed input affine ``(shift, scale)``."""
        return self.in_shift[i].cpu().numpy(), self.in_scale[i].cpu().numpy()

    def _take(self, name: str, idx: torch.Tensor) -> torch.Tensor:
        """The members ``idx`` of stack ``name`` in the compute dtype."""
        return take(self.weights[name], idx, self.dtype)

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

    def _stacks(self, entries, module):
        chains = [module.serving_chain(e.params) for e in entries]
        self.acts = [act for _W, _b, act in chains[0]]
        out = {}
        for i in range(len(self.acts)):
            out[f"{i}.kernel"] = (_np_stack([c[i][0] for c in chains]), 1)
            out[f"{i}.bias"] = (_np_stack([c[i][1] for c in chains]), 1)
        return out

    def forward(self, idx, h):
        layers = [(self._take(f"{i}.kernel", idx), self._take(f"{i}.bias", idx), act)
                  for i, act in enumerate(self.acts)]
        return dense_chain(h, layers, self.dtype).float()


class _LSTMBucket(_Bucket):
    """LSTM stacks: each layer's ``Wi``/``Wh``/``b`` and the head stacked
    ``(M, ...)``; a batch gathers its slots' members and runs the time-major
    forward with the slots as the member axis and the windows as the batch.
    ``Wi``, ``Wh`` and ``b`` concatenate the four gate leaves of a Flax
    cell, so int8 storage scales each gate on its own."""

    def __init__(self, entries: Sequence[_BankEntry], module, device: torch.device,
                 bank_dtype: str = "float32"):
        self.funcs, self.out_func = module.funcs, module.out_func
        self.n_layers = len(module.layers)
        super().__init__(entries, module, device, bank_dtype)
        self.flops_method += f":time_major(T={self.lookback})"  # as the JAX bank tags its scan

    def _stacks(self, entries, module):
        out = {}
        for i in range(self.n_layers):
            for p in ("Wi", "Wh", "b"):
                key = f"layers.{i}.{p}"
                out[key] = (_np_stack([e.params[key] for e in entries]), 4)
        for p in ("kernel", "bias"):
            out[f"head.{p}"] = (_np_stack([e.params[f"head.{p}"] for e in entries]), 1)
        return out

    def forward(self, idx, xs):
        W = sliding_windows(xs, self.lookback)  # (B, T - lookback + 1, L, F)
        W = W[:, : W.shape[1] - self.target_offset]
        weights = (
            [tuple(self._take(f"layers.{i}.{p}", idx) for p in ("Wi", "Wh", "b")) for i in range(self.n_layers)],
            tuple(self._take(f"head.{p}", idx) for p in ("kernel", "bias")),
        )
        return lstm_time_major_forward(weights, W, self.funcs, self.out_func, self.dtype)


class _ConvBucket(_Bucket):
    """Conv autoencoders: each layer's kernel ``(M, K, F_in, C)`` and bias
    stacked; a batch gathers its slots' members and runs every window of
    every slot through ``conv_autoencoder_forward`` with the slots as the
    member axis."""

    def __init__(self, entries: Sequence[_BankEntry], module, device: torch.device,
                 bank_dtype: str = "float32"):
        self.n_encoder, self.activation = len(module.channels), module.activation
        self.layer_names = list(module.layer_names())
        super().__init__(entries, module, device, bank_dtype)

    def _stacks(self, entries, module):
        return {f"{name}.{p}": (_np_stack([e.params[f"{name}.{p}"] for e in entries]), 1)
                for name in self.layer_names for p in ("kernel", "bias")}

    def forward(self, idx, xs):
        W = sliding_windows(xs, self.lookback)  # (B, T - lookback + 1, L, F), a view
        W = W[:, : W.shape[1] - self.target_offset]
        weights = [tuple(self._take(f"{name}.{p}", idx) for p in ("kernel", "bias")) for name in self.layer_names]
        return conv_autoencoder_forward(weights, W, self.n_encoder, self.activation, self.dtype)


# the bucket of each model family (``models.register.by_family``)
_BUCKETS = {"dense": _DenseBucket, "vae": _DenseBucket, "lstm": _LSTMBucket, "conv": _ConvBucket}


def _make_bucket(entries: Sequence[_BankEntry], device: torch.device, bank_dtype: str = "float32"):
    first = entries[0]
    module = lookup_factory(first.registry_type, first.kind)(
        first.n_features, compute_dtype=first.compute_dtype, **first.factory_kwargs
    )
    return by_family(_BUCKETS, module, "bank bucket")(entries, module, device, bank_dtype)


class _ShardedBucket:
    """A bucket's stacks split over a mesh (JAX ``_Bucket.finalize`` under a
    mesh): the stack is padded to a multiple of the mesh's D shards by
    repeating its last member (real parameters no routed slot points at),
    and shard d is a whole bucket of the ``shard_size`` members
    ``[d * shard_size, (d + 1) * shard_size)`` on the mesh's device d. Member
    i lives on shard ``i // shard_size`` at local index ``i % shard_size``;
    each shard scores its own sub-batch against its own stacks and scalers,
    launching its own forward and K2. The static numbers are the bucket's:
    ``members`` the real members, ``weight_bytes`` the stored stacks'
    bytes with the padding, as the JAX bank counts them."""

    def __init__(self, entries: Sequence[_BankEntry], mesh, bank_dtype: str = "float32"):
        n_pad = pad_count_to_mesh(len(entries), mesh)
        padded = list(entries) + [entries[-1]] * (n_pad - len(entries))
        self.shards = tuple(_make_bucket(padded[a:b], dev, bank_dtype)
                            for (a, b), dev in zip(shard_blocks(n_pad, mesh), mesh.devices))
        first = self.shards[0]
        for attr in ("n_features", "lookback", "target_offset", "offset", "label", "dtype", "bank_dtype",
                     "registry_type", "kind", "params_per_member", "flops_per_row", "flops_method"):
            setattr(self, attr, getattr(first, attr))
        self.device = first.device
        self.names = [e.name for e in entries]
        self.members = len(entries)
        self.n_shards, self.shard_size = mesh.size, n_pad // mesh.size
        self.weight_bytes = sum(b.weight_bytes for b in self.shards)
        self.weight_bytes_fp32 = sum(b.weight_bytes_fp32 for b in self.shards)
        self.quantize_error = next((b.quantize_error for b in self.shards if b.quantize_error), None)
        self.effective_dtype = storage_dtype([w for b in self.shards for w in b.weights.values()])

    def input_scaler(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.shards[i // self.shard_size].input_scaler(i % self.shard_size)


def _is_lstm(bucket) -> bool:
    return isinstance(bucket.shards[0], _LSTMBucket)


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
    # the request's share of its group's useful device window (seconds),
    # set when the bank has a goodput ledger
    device_s: float = 0.0

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


class _GroupRun:
    """One bucket group's trip through the scoring pipeline: built by
    ``_host_prep`` (the padded buffers), handed to ``_dispatch`` (the work
    enqueued on the card, ``event`` recorded behind it), finished by
    ``_postprocess`` (wait, slice, release). One object a group is what
    lets ``score_many`` hold several in flight."""

    __slots__ = ("bucket", "req_ids", "req_plans", "group_traces", "n_chunks", "shape", "Xb", "Yb", "idx",
                 "out", "bufs", "dev_refs", "events", "event_s", "t_group", "t_chunks", "t_pad",
                 "t_dispatch", "t_ready", "t_device_done", "t_post", "routed_rows", "total_rows", "shard_rows",
                 "profile_dir")

    def __init__(self, bucket: _Bucket, req_ids: List[int]):
        self.bucket, self.req_ids = bucket, req_ids
        # (request index, its rows as float32, its chunks' slots, its output
        # rows); slot d * B + j is shard d's j-th row of the batch
        self.req_plans: List[Tuple[int, np.ndarray, List[int], int]] = []
        self.group_traces = None
        self.n_chunks = 0
        self.shape = (0, 0)  # (B, T) a shard
        # (D, B, T, F) inputs, (D, B) shard-local indices, (D, B, width) result
        self.Xb = self.Yb = self.idx = self.out = None
        self.bufs: List[np.ndarray] = []  # the arena buffers this group holds
        self.dev_refs = None  # the device tensors its enqueued work uses
        # on the card: (start, done) CUDA events of each device's run of shards
        self.events: List[Tuple[Any, Any]] = []
        self.event_s = 0.0
        self.t_group = self.t_chunks = self.t_pad = self.t_dispatch = 0.0
        # t_device_done: the earliest time the result was seen ready, at a
        # host stage boundary; t_ready: when the host stopped waiting
        self.t_ready = self.t_device_done = self.t_post = 0.0
        self.routed_rows = self.total_rows = 0
        self.shard_rows: Tuple[Tuple[str, int, int], ...] = ()  # (shard, routed, padded)
        self.profile_dir = None  # the capture of this group, under GORDO_PROFILE_DIR

    def poll_ready(self, now: float) -> None:
        """Stamp ``t_device_done`` if the group's events have completed."""
        if self.t_device_done or not self.events:
            return
        try:
            if all(done.query() for _start, done in self.events):
                self.t_device_done = now
        except Exception:
            # a device error surfaces at the group's wait, in its own handler
            pass

    def release(self, arena: PaddedArena) -> None:
        """Give the group's buffers back to the arena (idempotent)."""
        bufs, self.bufs = self.bufs, []
        for buf in bufs:
            arena.release(buf)


def _pipeline_collector(ref, prev):
    """The arena and in-flight series of the bank behind ``ref``, read at
    render time. A /reload's bank replaces its predecessor's collector
    (``prev``) and carries its values, so the counters never step back:
    while the old bank lives its values are re-read, and once it is gone
    its counters freeze as a baseline and its gauges drop out."""
    base = {"hits": 0, "misses": 0, "bytes": 0, "inflight": 0, "prev": prev}

    def refresh_base():
        prev = base["prev"]
        if prev is None:
            return
        rows = ()
        with contextlib.suppress(Exception):
            rows = tuple(prev())
        if not rows:
            base["prev"] = None
            base["bytes"] = base["inflight"] = 0
            return
        for name, _t, _h, _l, value in rows:
            key = _PIPELINE_KEYS.get(name)
            if key is not None:
                base[key] = int(value)

    refresh_base()

    def collect():
        bank = ref()
        if bank is None:
            return ()
        refresh_base()
        arena = bank.arena
        return (
            ("gordo_bank_arena_hits_total", "counter", "Padded-buffer arena reuses on the coalesced loop",
             {}, base["hits"] + arena.hits),
            ("gordo_bank_arena_misses_total", "counter", "Padded-buffer arena allocations (pool miss)",
             {}, base["misses"] + arena.misses),
            ("gordo_bank_arena_bytes", "gauge", "Bytes held in the padded-buffer arena pool",
             {}, base["bytes"] + arena.pooled_bytes),
            ("gordo_bank_inflight_groups", "gauge", "Bucket groups currently in flight in the scoring pipeline",
             {}, base["inflight"] + bank._inflight_now),
        )

    return collect


def _capacity_collector(ref):
    """The stored weight bytes by dtype and the members a GiB of the bank
    behind ``ref``, read at render time from one :meth:`ModelBank.capacity_stats`
    (JAX ``_capacity_collect``); a /reload's bank replaces it under its key."""

    def collect():
        bank = ref()
        if bank is None:
            return ()
        cap = bank.capacity_stats()
        rows = [("gordo_bank_weight_bytes", "gauge", "Stacked bank weight bytes resident in HBM, by storage dtype",
                 {"dtype": d}, nbytes) for d, nbytes in sorted(cap["weight_bytes_by_dtype"].items())]
        if cap["models_per_gb"] is not None:
            rows.append(("gordo_bank_models_per_gb", "gauge",
                         "Bank members per GB of stacked-weight HBM at the current dtype mix", {},
                         cap["models_per_gb"]))
        return tuple(rows)

    return collect


_PIPELINE_KEYS = {"gordo_bank_arena_hits_total": "hits", "gordo_bank_arena_misses_total": "misses",
                  "gordo_bank_arena_bytes": "bytes", "gordo_bank_inflight_groups": "inflight"}


class ModelBank:
    """Stacked scoring bank over a collection of detectors.

    It lives on one device, or with ``mesh=`` (``parallel/mesh.py``, more
    than one shard) every bucket is split over the mesh's devices, each
    shard scored on its own device and the bank's device the mesh's first.

    ``device`` defaults to ``"cuda"`` and raises without CUDA unless
    ``"cpu"`` is passed. On the card, float32 matrix products run in full
    float32 (TF32 off for matmul and cuDNN), like the JAX reference.
    ``inflight`` (``GORDO_BANK_INFLIGHT``, default 2) bounds the groups in
    flight, 1 being the serial order; ``arena_max_mb``
    (``GORDO_ARENA_MAX_MB``) bounds the padded-buffer arena; ``ledger`` is
    the app's goodput ledger and ``heat`` its access-heat accountant, or
    None. ``bank_dtype`` (``GORDO_BANK_DTYPE``, default ``"float32"``) is
    the weights' storage: ``float32``, ``bfloat16`` or ``int8``
    (``ops/quantize.py``; aliases as there, anything else raises)."""

    def __init__(self, max_rows_per_call: int = 8192, device="cuda", registry=None,
                 inflight: Optional[int] = None, arena_max_mb: Optional[float] = None, ledger=None,
                 heat=None, bank_dtype: Optional[str] = None, mesh=None):
        # a mesh of more than one shard splits every bucket over its devices
        # (the bank's device is then its first); one shard is no mesh
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = self.mesh.devices[0] if self.mesh is not None else resolve_device(device)
        self.max_rows = int(max_rows_per_call)
        if bank_dtype is None:
            bank_dtype = os.environ.get("GORDO_BANK_DTYPE", "float32")
        self.bank_dtype = normalize_bank_dtype(bank_dtype)
        # bucket label -> error, for buckets whose quantization failed: they
        # serve from float32 storage (a loss of capacity, not of correctness)
        self.quantize_fallbacks: Dict[str, str] = {}
        if inflight is None:
            raw = os.environ.get("GORDO_BANK_INFLIGHT", "2")
            try:
                inflight = int(raw)
            except ValueError:
                raise ValueError(f"GORDO_BANK_INFLIGHT must be an integer, got {raw!r}") from None
        self._inflight_window = max(1, int(inflight))
        self._inflight_now = 0
        self.inflight_peak = 0  # the most groups in flight at once
        self.arena = PaddedArena(None if arena_max_mb is None else int(arena_max_mb * 1024 * 1024),
                                 pinned=self.device.type == "cuda")
        self.ledger = ledger
        # the app's heat accountant: every generation feeds it, and its
        # bucket attribution follows this bank
        self.heat = heat
        if heat is not None:
            heat.bind_bank(self)
        # host/device overlap over multi-group calls: device_busy sums the
        # groups' non-overlapping windows, wall the calls'
        self._pipe_lock = threading.Lock()
        self._pipe = {"calls": 0, "multi_group_calls": 0, "wall_s": 0.0, "device_busy_s": 0.0}
        # on the card: CUDA-event seconds of every finished group (first
        # copy in to last copy out), beside the host-observed windows
        self.event_s = 0.0
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
        # member -> rows routed to it, the placement planner's load signal
        # (placement/planner.py); a swap carries it to the next generation.
        # None turns it off
        self.model_rows: Optional[Dict[str, int]] = {}
        # shard -> its forward and K2 dispatches (each a K2 launch on the card)
        self.shard_launches: Dict[int, int] = {}
        # a reload's build and warm-up seconds (server/swap.build_bank)
        self.build_s = self.warmup_s = 0.0
        # metrics registry: None = the process default, False = none (the
        # uninstrumented control); a /reload's bank gets the app's, so the
        # counters go on across the swap
        if registry is None:
            registry = get_registry()
        elif registry is False:
            registry = None
        self.registry = registry
        self._m_bucket_calls = self._m_bucket_reqs = self._m_bucket_batch = self._m_quant_fallback = None
        self._m_shard_rows = self._m_shard_pad = self._m_shard_reqs = None
        if registry is not None:
            # per shard, labelled "0" on an unsharded bank as in the JAX bank
            self._m_shard_rows = registry.counter(
                "gordo_bank_shard_routed_rows_total", "Input rows routed to each model-axis shard", ("shard",))
            self._m_shard_pad = registry.counter(
                "gordo_bank_shard_padded_rows_total",
                "Pad rows dispatched to each shard (batch padded to the max per-shard load; high on one shard = "
                "skewed routing)", ("shard",))
            self._m_shard_reqs = registry.counter(
                "gordo_bank_shard_requests_total", "Request chunks routed to each shard", ("shard",))
            self._m_bucket_calls = registry.counter(
                "gordo_bank_bucket_calls_total", "Batched XLA scoring dispatches per bucket", ("bucket",))
            self._m_bucket_reqs = registry.counter(
                "gordo_bank_bucket_requests_total", "Requests scored per bucket", ("bucket",))
            self._m_bucket_batch = registry.histogram(
                "gordo_bank_bucket_batch_size", "Coalesced chunks per batched XLA call, per bucket",
                ("bucket",), lo=1.0, hi=1e5)
            self._m_quant_fallback = registry.counter(
                "gordo_bank_quantize_fallback_total",
                "Bucket quantizations that failed and fell back to fp32 storage (capacity impairment, not a "
                "correctness one)", ("bucket",))
            # through a weak reference: the registry outlives a swapped-out
            # bank, and must not pin its stacked weights on the card
            ref = weakref.ref(self)
            registry.gauge("gordo_bank_models", "Models resident in the HBM bank").labels().set_function(
                lambda: len(b._index) if (b := ref()) is not None else 0)
            registry.gauge("gordo_bank_buckets", "Compiled bucket programs in the bank").labels().set_function(
                lambda: len(b._buckets) if (b := ref()) is not None else 0)
            registry.collector(_pipeline_collector(ref, registry.get_collector("bank_pipeline")),
                               key="bank_pipeline")
            registry.collector(_capacity_collector(ref), key="bank_capacity")

    @classmethod
    def from_entries(cls, entries: Sequence[_BankEntry], **kwargs) -> "ModelBank":
        """A bank of bank entries; raises if a bucket cannot be built."""
        bank = cls(**kwargs)
        for key, group in bank._group(entries).items():
            bank._add_bucket(key, group)
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
                _FP_FINALIZE.fire()
                bank._add_bucket(key, group)
            except Exception as exc:
                label = group[0].bucket_label(bank.bank_dtype)
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

    def _add_bucket(self, key: str, group: List[_BankEntry]) -> None:
        """Build and add one bucket; a quantization that fell back is
        recorded in ``quantize_fallbacks`` and counted."""
        if self.mesh is not None:
            bucket = _ShardedBucket(group, self.mesh, self.bank_dtype)
        else:
            bucket = _make_bucket(group, self.device, self.bank_dtype)
        self._buckets[key] = bucket
        if bucket.quantize_error is not None:
            self.quantize_fallbacks[bucket.label] = bucket.quantize_error
            if self._m_quant_fallback is not None:
                self._m_quant_fallback.labels(bucket.label).inc()

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
            # the shards the stacks are split over (1 unsharded)
            "devices": self.mesh.size if self.mesh is not None else 1,
            "device": str(self.device),
        }

    def placement(self) -> Dict[str, Any]:
        """The live member -> shard assignment (JAX ``ModelBank.placement``):
        per bucket, its members in stack order, member i on shard
        ``i // shard_size``; an unsharded bank is one shard holding all."""
        return {
            "bank_generation": int(self.generation),
            "devices": self.mesh.size if self.mesh is not None else 1,
            "buckets": [{"bucket": b.label, "key": key, "n_shards": int(b.n_shards),
                         "shard_size": int(b.shard_size or len(b.names)), "members": list(b.names)}
                        for key, b in self._buckets.items()],
        }

    def capacity_stats(self) -> Dict[str, Any]:
        """The weights' storage at a glance (``/stats`` ``bank_capacity``,
        the JAX bank's keys): bytes stored and at float32, their ratio, the
        bytes a member and members a GiB, and the buckets whose quantization
        fell back. ``kernel`` names the K2 route: ``"cuda"`` on the card,
        ``"plain"`` on the CPU."""
        buckets = list(self._buckets.values())
        total = sum(b.weight_bytes for b in buckets)
        fp32 = sum(b.weight_bytes_fp32 for b in buckets)
        by_dtype: Dict[str, int] = {}
        for b in buckets:
            by_dtype[b.effective_dtype] = by_dtype.get(b.effective_dtype, 0) + b.weight_bytes
        members = len(self._index)
        bpm = total / members if members else None
        return {
            "dtype": self.bank_dtype,
            "kernel": "cuda" if self.device.type == "cuda" else "plain",
            "members": members,
            "weight_bytes": total,
            "weight_bytes_by_dtype": by_dtype,
            "fp32_bytes": fp32,
            "capacity_ratio": round(fp32 / total, 3) if total else None,
            "bytes_per_member": round(bpm, 1) if bpm is not None else None,
            "models_per_gb": round(1024**3 / bpm, 1) if bpm else None,
            "quantize_fallbacks": dict(self.quantize_fallbacks),
        }

    def flops_stats(self) -> Dict[str, Any]:
        """Per bucket, the static numbers the cost model joins to the
        ledger's device seconds (the JAX bank's keys): ``weight_bytes`` the
        stored weight stacks' bytes, without the scalers, and
        ``effective_dtype`` their storage dtype."""
        out: Dict[str, Any] = {}
        for b in self._buckets.values():
            out[b.label] = {
                "flops_per_row": float(b.flops_per_row),
                "flops_method": b.flops_method,
                "params_per_member": int(b.params_per_member),
                "members": int(b.members),
                "kind": b.kind,
                "registry_type": b.registry_type,
                "n_features": int(b.n_features),
                "lookback": int(b.lookback),
                "weight_bytes": int(b.weight_bytes),
                "effective_dtype": b.effective_dtype,
                "seq_layout": "time_major" if _is_lstm(b) else "legacy",
                "seq_kernel": ("cuda" if self.device.type == "cuda" else "plain") if _is_lstm(b) else "none",
            }
        return out

    def pipeline_stats(self) -> Dict[str, Any]:
        """The pipeline and arena at a glance (``/stats`` ``bank_pipeline``)."""
        with self._pipe_lock:
            pipe = dict(self._pipe)
        wall = pipe["wall_s"]
        return {
            "inflight_window": self._inflight_window,
            "arena": self.arena.stats(),
            "overlap": {
                "calls": pipe["calls"],
                "multi_group_calls": pipe["multi_group_calls"],
                "device_busy_s": round(pipe["device_busy_s"], 6),
                "wall_s": round(wall, 6),
                "overlap_ratio": round(pipe["device_busy_s"] / wall, 4) if wall > 0 else None,
            },
        }

    @staticmethod
    def _warmup_grid_env(name: str, default: Tuple[int, ...]) -> Tuple[int, ...]:
        raw = os.environ.get(name)
        if not raw:
            return default
        try:
            vals = tuple(int(v) for v in raw.split(",") if v.strip())
        except ValueError:
            logger.warning("%s must be comma-separated integers, got %r; using %s", name, raw, default)
            return default
        return vals or default

    def warmup_shapes(self, bucket: _Bucket, rows, batch_sizes) -> List[Tuple[int, int]]:
        """The (T, B) grid of ``rows`` x ``batch_sizes``, each rounded as
        :meth:`_host_prep` rounds what it dispatches."""
        batches = sorted({_next_pow2(max(1, int(b))) for b in batch_sizes})
        return sorted({
            (max(min(_next_pow2(max(1, int(r))), _prev_pow2(self.max_rows)), _next_pow2(bucket.offset + 1)), B)
            for r in rows for B in batches
        })

    def warmup(self, rows=None, batch_sizes=None) -> int:
        """Run each bucket once at every (B, T) of a grid, off the request
        path (the server's start, unless ``GORDO_SERVER_WARMUP=0``): on the
        card this builds the kernels, fills the arena with the page-locked
        buffers of those shapes and grows the allocator's pool. ``rows``
        (``GORDO_WARMUP_ROWS``, else 256) and ``batch_sizes``
        (``GORDO_WARMUP_BATCHES``, else 1) are rounded to the shapes
        :meth:`score_many` dispatches. Returns the buckets warmed."""
        if rows is None:
            row_list = self._warmup_grid_env("GORDO_WARMUP_ROWS", (256,))
        elif isinstance(rows, int):
            row_list = (rows,)
        else:
            row_list = tuple(rows)
        if batch_sizes is None:
            batch_sizes = self._warmup_grid_env("GORDO_WARMUP_BATCHES", (1,))
        warmed = total_shapes = 0
        for bucket in list(self._buckets.values()):
            shapes = self.warmup_shapes(bucket, row_list, batch_sizes)
            try:
                for T, B in shapes:
                    self._warm(bucket, B, T)
                warmed += 1
                total_shapes += len(shapes)
            except Exception:
                logger.warning("bank warmup failed for bucket %s", bucket.label, exc_info=True)
        if warmed:
            logger.info("Model bank warmed: %d bucket(s) over %d (rows, batch) shape(s)", warmed, total_shapes)
        return warmed

    def _warm(self, bucket: _Bucket, B: int, T: int) -> None:
        """One zero batch of shape (B, T) a shard through the pipeline's
        buffers."""
        run = _GroupRun(bucket, [])
        run.shape = (B, T)
        try:
            D, F, n = bucket.n_shards, bucket.n_features, T - bucket.offset
            for attr, shape, dtype in (("Xb", (D, B, T, F), np.float32), ("Yb", (D, B, T, F), np.float32),
                                       ("idx", (D, B), np.int32)):
                buf, _ = self._acquire(run, shape, dtype)
                buf[...] = 0
                setattr(run, attr, buf)
            if self.device.type == "cuda":
                run.out, _ = self._acquire(run, (D, B, 3 * n * F + 2 * n), np.float32)
            self._dispatch(run)
        finally:
            self._drain(run)

    def score(self, name: str, X: np.ndarray, y: Optional[np.ndarray] = None, trace=None) -> ScoreResult:
        return self.score_many([(name, X, y)], traces=None if trace is None else [trace])[0]

    def score_many(self, requests: Sequence[Request], deadline: Optional[Deadline] = None,
                   return_exceptions: bool = False, traces: Optional[Sequence[Any]] = None) -> List[Any]:
        """Score a heterogeneous batch of (name, X, y) requests.

        Requests are grouped by bucket and each group runs through three
        stages: :meth:`_host_prep` (coalesce and pad into arena buffers),
        :meth:`_dispatch` (the copies to the card, the forward and K2, and
        the copy of K2's packed result back into a page-locked buffer, all
        enqueued without waiting, then one event) and :meth:`_postprocess`
        (wait on the event, slice, copy out, release the buffers), with up
        to ``GORDO_BANK_INFLIGHT`` (default 2) groups in flight: while
        group k runs on the card, group k+1 is padded on the host and group
        k-1's result is sliced. Results are bitwise those of window 1.

        ``deadline`` (the batch's earliest) is checked between group
        dispatches: once it has passed, no further group is dispatched and
        :class:`DeadlineExceeded` is raised. ``traces`` (request-aligned,
        entries may be None) receive the ``coalesce``, ``pad``,
        ``device_execute`` and ``postprocess`` spans, and a multi-group
        call's ``pipeline_overlap``. With ``return_exceptions`` a failed
        group's requests (and those a deadline cut off) get their
        exception as their entry, while every other group's results stand.
        An invalid request (unknown model, wrong width, empty input, y of
        another shape) fails its group."""
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
        n_groups = len(groups)
        window = self._inflight_window
        inflight: "deque[_GroupRun]" = deque()
        t_call = time.monotonic()
        device_busy = 0.0
        last_ready = t_call

        def poll_inflight() -> None:
            # stamp completions at host stage boundaries, so a group's
            # window closes near when the card finished, not at its wait
            if inflight:
                now = time.monotonic()
                for r in inflight:
                    r.poll_ready(now)

        def finish(run: _GroupRun) -> None:
            nonlocal device_busy, last_ready
            poll_inflight()
            ok = True
            try:
                self._postprocess(run, requests, results, traces)
            except Exception as exc:
                ok = False
                if not return_exceptions:
                    raise
                for ri in run.req_ids:
                    errors[ri] = exc
            # the window ends at the earliest observed completion and never
            # overlaps the previous group's
            t_done = run.t_device_done or run.t_ready
            window_s = max(0.0, t_done - max(run.t_dispatch, last_ready))
            device_busy += window_s
            last_ready = max(last_ready, t_done)
            with self._pipe_lock:
                self.event_s += run.event_s
            if self.ledger is not None:
                self._account_group(run, results, window_s, ok)

        try:
            for gi, (key, req_ids) in enumerate(groups):
                if deadline is not None and deadline.expired():
                    # the next group's device work would answer nobody
                    exc = DeadlineExceeded(
                        f"batch deadline expired before all {n_groups} bucket group(s) dispatched "
                        f"(budget {deadline.budget_s * 1e3:.0f}ms)")
                    if not return_exceptions:
                        raise exc
                    for _key, rids in groups[gi:]:
                        for ri in rids:
                            errors[ri] = exc
                    break
                run = None
                try:
                    run = self._host_prep(key, req_ids, requests, traces)
                    self._dispatch(run)
                except Exception as exc:
                    if run is not None:
                        self._drain(run)
                    if not return_exceptions:
                        raise
                    for ri in req_ids:
                        errors[ri] = exc
                    continue
                inflight.append(run)
                self._set_inflight(len(inflight))
                poll_inflight()
                if len(inflight) >= window:
                    finish(inflight.popleft())
                    self._set_inflight(len(inflight))
            while inflight:
                finish(inflight.popleft())
                self._set_inflight(len(inflight))
        except BaseException:
            # an aborted call leaks no buffer: wait on every group still in
            # flight, then release its buffers, before the error propagates
            for run in inflight:
                self._drain(run)
            self._set_inflight(0)
            raise
        self._set_inflight(0)
        with self._pipe_lock:
            self._pipe["calls"] += 1
            if n_groups > 1:
                t_end = time.monotonic()
                wall = t_end - t_call
                self._pipe["multi_group_calls"] += 1
                self._pipe["wall_s"] += wall
                self._pipe["device_busy_s"] += device_busy
        if n_groups > 1 and traces is not None:
            ratio = device_busy / wall if wall > 0 else 0.0
            for ri, tr in enumerate(traces):
                # only requests that rode the pipeline
                if tr is None or ri in errors:
                    continue
                tr.add_span("pipeline_overlap", t_call, t_end, groups=n_groups, window=window,
                            device_busy_ms=round(device_busy * 1e3, 3), overlap_ratio=round(ratio, 4))
        for ri, exc in errors.items():
            results[ri] = exc
        return results

    def _set_inflight(self, n: int) -> None:
        self._inflight_now = n
        if n > self.inflight_peak:
            self.inflight_peak = n

    def _drain(self, run: "_GroupRun") -> None:
        """Wait for whatever the card may still do with ``run``'s buffers,
        then give them back to the arena."""
        if run.events:
            for _start, done in run.events:
                with contextlib.suppress(Exception):
                    done.synchronize()
        elif run.dev_refs is not None and self.device.type == "cuda":
            # a dispatch that failed before its events: its copies may be queued
            for dev in {shard.device for shard in run.bucket.shards}:
                with contextlib.suppress(Exception):
                    torch.cuda.current_stream(dev).synchronize()
        run.dev_refs = None
        run.release(self.arena)

    def _host_prep(self, key: str, req_ids: List[int], requests: Sequence[Request],
                   traces: Optional[Sequence[Any]]) -> "_GroupRun":
        """Stage 1, host work: validate the group's requests, chunk long
        ones (sequence chunks overlap by the warm-up, so no output row is
        lost) and pad the batch into arena buffers, zeroing only the pad
        tail of a reused one."""
        bucket = self._buckets[key]
        run = _GroupRun(bucket, req_ids)
        if traces is not None:
            run.group_traces = [t for t in (traces[ri] for ri in req_ids) if t is not None] or None
        # stage times serve tracing and the ledger; with neither they stay 0
        timed = run.group_traces is not None or self.ledger is not None
        run.t_group = time.monotonic() if timed else 0.0
        F, off = bucket.n_features, bucket.offset
        rows = [np.asarray(requests[ri][1], np.float32) for ri in req_ids]
        # heat's mailbox and the planner's rows: one dict get and set each a
        # request; the decay runs on the accountant's cadence
        pend = self.heat.pending if self.heat is not None else None
        mrows = self.model_rows
        for ri, X in zip(req_ids, rows):
            name = requests[ri][0]
            if X.ndim != 2 or X.shape[1] != F:
                raise ValueError(f"Request for {name!r}: expected (rows, {F}), got {X.shape}")
            if X.shape[0] == 0:
                raise ValueError(f"Request for {name!r}: empty input")
            if X.shape[0] <= off:
                raise ValueError(f"Request for {name!r}: need more than {off} rows (sequence warm-up), "
                                 f"got {X.shape[0]}")
            if mrows is not None:
                mrows[name] = mrows.get(name, 0) + X.shape[0]
            if pend is not None:
                pend[name] = pend.get(name, 0.0) + X.shape[0]
        # rows per call: a power of two, at most max_rows but always at
        # least one window and one output row; chunk [start, start + T)
        # yields the output rows [start + off, start + T)
        T = min(_next_pow2(max(x.shape[0] for x in rows)), _prev_pow2(self.max_rows))
        T = max(T, _next_pow2(off + 1))
        step = T - off
        # the router (JAX bank.py:1640-1688): each chunk goes to the shard
        # owning its member, at the member's shard-local index
        D, size = bucket.n_shards, bucket.shard_size
        per_shard: List[List[Tuple[int, np.ndarray, np.ndarray]]] = [[] for _ in range(D)]
        chunk_at: List[Tuple[int, int]] = []  # chunk -> (shard, its place there)
        for ri, X in zip(req_ids, rows):
            name, _X, yv = requests[ri]
            Y = X if yv is None else np.asarray(yv, np.float32)
            if Y.shape != X.shape:
                raise ValueError(f"Request for {name!r}: y shape {Y.shape} must match X shape {X.shape}")
            d, local = divmod(self._index[name][1], size)
            cis = []
            for start in range(0, X.shape[0] - off, step):
                cis.append(len(chunk_at))
                chunk_at.append((d, len(per_shard[d])))
                per_shard[d].append((local, X[start:start + T], Y[start:start + T]))
            run.req_plans.append((ri, X, cis, X.shape[0] - off))
        run.n_chunks = len(chunk_at)
        run.t_chunks = time.monotonic() if timed else 0.0
        if self._m_bucket_calls is not None:
            self._m_bucket_calls.labels(bucket.label).inc()
            self._m_bucket_reqs.labels(bucket.label).inc(len(req_ids))
            self._m_bucket_batch.labels(bucket.label).record(float(run.n_chunks))
        # every shard is padded to the largest shard's load
        B = _next_pow2(max(1, max(len(c) for c in per_shard)))
        run.shape = (B, T)
        run.req_plans = [(ri, X, [chunk_at[ci][0] * B + chunk_at[ci][1] for ci in cis], n_out)
                         for ri, X, cis, n_out in run.req_plans]
        try:
            run.Xb, x_clean = self._acquire(run, (D, B, T, F), np.float32)
            run.Yb, y_clean = self._acquire(run, (D, B, T, F), np.float32)
            run.idx, idx_clean = self._acquire(run, (D, B), np.int32)
            if self.device.type == "cuda":
                # the page-locked buffer K2's packed results are copied into
                n = T - off
                run.out, _ = self._acquire(run, (D, B, 3 * n * F + 2 * n), np.float32)
            shard_rows = []
            for d, chunks in enumerate(per_shard):
                Xb, Yb, idx = run.Xb[d], run.Yb[d], run.idx[d]
                routed = 0
                for j, (local, xc, yc) in enumerate(chunks):
                    n_rows = xc.shape[0]
                    Xb[j, :n_rows] = xc
                    Yb[j, :n_rows] = yc
                    if n_rows < T:
                        if not x_clean:
                            Xb[j, n_rows:] = 0.0
                        if not y_clean:
                            Yb[j, n_rows:] = 0.0
                    idx[j] = local
                    routed += n_rows
                if not x_clean:
                    Xb[len(chunks):] = 0.0
                if not y_clean:
                    Yb[len(chunks):] = 0.0
                if not idx_clean:
                    idx[len(chunks):] = 0
                if self._m_shard_rows is not None:
                    # every shard runs B * T rows whatever its load: the
                    # routed/padded split is the skew the planner reads
                    label = str(d)
                    self._m_shard_rows.labels(label).inc(routed)
                    self._m_shard_pad.labels(label).inc(B * T - routed)
                    self._m_shard_reqs.labels(label).inc(len(chunks))
                shard_rows.append((str(d), routed, B * T - routed))
        except BaseException:
            run.release(self.arena)
            raise
        run.shard_rows = tuple(shard_rows)
        run.routed_rows, run.total_rows = sum(r for _s, r, _p in shard_rows), D * B * T
        run.t_pad = time.monotonic() if timed else 0.0
        return run

    def _acquire(self, run: "_GroupRun", shape, dtype):
        """An arena buffer of ``shape`` (D, B, ...), pooled under the shape
        (D * B, ...): an unsharded bank's buffers are the (B, ...) ones."""
        buf, clean = self.arena.acquire((shape[0] * shape[1],) + tuple(shape[2:]), dtype)
        run.bufs.append(buf)  # attached at once: a later failure releases it
        return buf.reshape(shape), clean

    def _dispatch(self, run: "_GroupRun") -> None:
        """Stage 2: on the card, the copies in, the forward and K2, and the
        copy of K2's packed result into its page-locked buffer, all
        enqueued on the current stream without waiting, then one event
        recorded behind them; the device tensors stay referenced until
        that event. On the CPU the forward runs here, to its end."""
        _FP_SCORE.fire()
        run.t_dispatch = time.monotonic()
        prof_root = os.environ.get(PROFILE_DIR_ENV) if run.group_traces else None
        if prof_root:
            # a profiler capture of exactly this group, named by its first
            # request's trace id (the device_execute span's ``profile``
            # links the two); it must see the work, so it waits for the
            # group's event inside the capture
            prof_name = f"serve-{run.group_traces[0].trace_id}"
            run.profile_dir = profile_path(prof_name, prof_root)
            with maybe_profile(prof_name, prof_root):
                self._enqueue(run)
                for _start, done in run.events:
                    done.synchronize()
            run.t_ready = run.t_device_done = time.monotonic()
        else:
            self._enqueue(run)

    def _enqueue(self, run: "_GroupRun") -> None:
        """Each shard's copies in, forward, K2 and copy back, on its own
        device (its current stream); on the card one event pair brackets
        each device's run of consecutive shards."""
        shards = run.bucket.shards
        if self.device.type == "cuda":
            refs: List[Any] = []
            run.dev_refs = refs
            start = None
            for d, shard in enumerate(shards):
                dev = shard.device
                with torch.cuda.device(dev):
                    if start is None:
                        start = torch.cuda.Event(enable_timing=True)
                        start.record()
                    idx = torch.from_numpy(run.idx[d]).to(dev, non_blocking=True)
                    X = torch.from_numpy(run.Xb[d]).to(dev, non_blocking=True)
                    Y = torch.from_numpy(run.Yb[d]).to(dev, non_blocking=True)
                    refs.append((idx, X, Y))
                    flat = shard.score_batch(idx, X, Y)
                    refs.append(flat)
                    torch.from_numpy(run.out[d]).copy_(flat, non_blocking=True)
                    if d + 1 == len(shards) or shards[d + 1].device != dev:
                        done = torch.cuda.Event(enable_timing=True)
                        done.record()
                        run.events.append((start, done))
                        start = None
                self._count_launch(d)
        else:
            outs = []
            for d, shard in enumerate(shards):
                outs.append(shard.score_batch(torch.from_numpy(run.idx[d]), torch.from_numpy(run.Xb[d]),
                                              torch.from_numpy(run.Yb[d])).numpy())
                self._count_launch(d)
            run.out = outs[0][None] if len(outs) == 1 else np.stack(outs)
            run.t_ready = run.t_device_done = time.monotonic()

    def _count_launch(self, d: int) -> None:
        with self._pipe_lock:
            self.shard_launches[d] = self.shard_launches.get(d, 0) + 1

    def _postprocess(self, run: "_GroupRun", requests: Sequence[Request], results: List[Any],
                     traces: Optional[Sequence[Any]]) -> None:
        """Stage 3: wait on the group's event, slice each request's rows out
        of the packed result as copies, record the spans, release."""
        try:
            if not run.t_ready:
                try:
                    # the group's window ends here when the host waited
                    for _start, done in run.events:
                        done.synchronize()
                finally:
                    run.t_ready = time.monotonic()
            if run.events:
                run.event_s = max(start.elapsed_time(done) for start, done in run.events) / 1e3
            bucket = run.bucket
            F, off = bucket.n_features, bucket.offset
            B, T = run.shape
            n = T - off  # output rows a chunk
            B = bucket.n_shards * B  # the shards' slots back to back
            flat = run.out.reshape(B, -1)
            shapes = [(B, n, F)] * 3 + [(B, n)] * 2
            widths = np.cumsum([0] + [int(np.prod(sh[1:])) for sh in shapes])
            outs = [flat[:, a:b].reshape(sh) for a, b, sh in zip(widths[:-1], widths[1:], shapes)]
            for ri, X, cis, n_out in run.req_plans:
                # copies, never views into a pooled buffer
                if len(cis) == 1:
                    vals = [a[cis[0]][:n_out].copy() for a in outs]
                else:
                    vals = [np.concatenate([a[ci] for ci in cis], axis=0)[:n_out] for a in outs]
                results[ri] = ScoreResult(
                    tags=self._tags[requests[ri][0]], model_input=X, model_output=vals[0], diff=vals[1],
                    scaled=vals[2], total_unscaled=vals[3], total_scaled=vals[4], offset=off)
            if run.group_traces or self.ledger is not None:
                run.t_post = time.monotonic()
            if run.group_traces:
                # the stage boundaries are the group's: every traced request
                # in it gets the same timestamps
                label = bucket.label
                for ri in run.req_ids:
                    tr = traces[ri]
                    if tr is None:
                        continue
                    tr.add_span("coalesce", run.t_group, run.t_chunks, bucket=label,
                                requests=len(run.req_ids), chunks=run.n_chunks)
                    tr.add_span("pad", run.t_chunks, run.t_pad)
                    exec_attrs = {"bucket": label}
                    if run.profile_dir is not None:
                        exec_attrs["profile"] = run.profile_dir
                    tr.add_span("device_execute", run.t_dispatch, run.t_ready, **exec_attrs)
                    tr.add_span("postprocess", run.t_ready, run.t_post)
        finally:
            run.dev_refs = None
            run.release(self.arena)

    def _account_group(self, run: "_GroupRun", results: List[Any], window_s: float, ok: bool) -> None:
        """The goodput ledger's share of one finished group: its device
        window split by real and pad rows, the useful share apportioned to
        its requests by their rows (``ScoreResult.device_s``); a failed
        group's useful share is wasted outright."""
        total = run.total_rows
        pad_frac = (1.0 - run.routed_rows / total) if total else 0.0
        padded_s = window_s * pad_frac
        useful_s = window_s - padded_s
        self.ledger.account_group(
            bucket=run.bucket.label, window_s=window_s, useful_s=useful_s, padded_s=padded_s, ok=ok,
            coalesce_s=max(0.0, run.t_chunks - run.t_group) if run.t_group else 0.0,
            pad_s=max(0.0, run.t_pad - run.t_chunks) if run.t_chunks else 0.0,
            postprocess_s=max(0.0, run.t_post - run.t_ready) if run.t_post else 0.0,
            shard_rows=run.shard_rows,
        )
        if ok and useful_s > 0.0:
            req_rows = sum(plan[1].shape[0] for plan in run.req_plans)
            if req_rows:
                per_row = useful_s / req_rows
                for ri, X, _cis, _n_out in run.req_plans:
                    r = results[ri]
                    if isinstance(r, ScoreResult):
                        r.device_s = per_row * X.shape[0]
