"""sklearn-style autoencoder estimators.

Counterpart of ``BaseEstimator``, ``AutoEncoder``, ``SequenceBaseEstimator``,
``LSTMAutoEncoder`` and ``LSTMForecast`` in
``gordo_components_tpu/models/models.py``: ``kind`` selects a registered
factory, ``fit`` reconstructs X (the train core's epochs over one stacked
member, on ``device``), ``score`` is explained variance, and the per-epoch
history lands in the metadata. Fitted parameters are the factory module's
state dict as numpy arrays, which the serializer writes.

A sequence estimator trains on windows of ``lookback_window`` rows: item
``i`` is the window ``[i, i + lookback_window)`` against row ``i +
lookback_window - 1 + offset`` (offset 1 for ``LSTMForecast``), gathered
from the rows batch by batch. ``ConvAutoEncoder`` is not ported: it raises.
"""

import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from gordo_components_torch.device import resolve_device
from gordo_components_torch.models import train_core
from gordo_components_torch.models.base import GordoBase
from gordo_components_torch.models.register import lookup_factory
from gordo_components_torch.ops.losses import explained_variance, regression_metrics
from gordo_components_torch.ops.windows import sliding_windows
from gordo_components_torch.utils import capture_args

logger = logging.getLogger(__name__)


def _as_float32(X) -> np.ndarray:
    """Frame or array -> 2-D float32 ndarray (a frame's values copied: they
    may be read-only, and torch wants to own what it wraps)."""
    X = np.array(X.values, np.float32) if hasattr(X, "values") else np.asarray(X, np.float32)
    return X[:, None] if X.ndim == 1 else X


class BaseEstimator(GordoBase):
    """Shared engine for the autoencoder estimators.

    ``kind`` names a factory registered for this estimator's type (its
    class name); the remaining ``**factory_kwargs`` flow to the factory.
    ``device`` is where ``fit`` and ``predict`` run: the card unless
    ``"cpu"`` is asked for."""

    @property
    def _registry_type(self) -> str:
        return type(self).__name__

    @capture_args
    def __init__(
        self,
        kind: str = "feedforward_hourglass",
        batch_size: int = 100,
        epochs: int = 10,
        learning_rate: float = 1e-3,
        optimizer: str = "adam",
        loss: str = "auto",
        kl_weight: float = 1.0,
        validation_split: float = 0.0,
        early_stopping_patience: Optional[int] = None,
        early_stopping_min_delta: float = 0.0,
        seed: int = 0,
        compute_dtype: str = "float32",
        data_parallel: bool = False,
        device="cuda",
        **factory_kwargs,
    ):
        self.kind = kind
        self.batch_size = int(batch_size)
        self.epochs = int(epochs)
        self.learning_rate = float(learning_rate)
        self.optimizer = optimizer
        self.loss = loss
        self.kl_weight = float(kl_weight)
        self.validation_split = float(validation_split)
        self.early_stopping_patience = early_stopping_patience
        self.early_stopping_min_delta = float(early_stopping_min_delta)
        self.seed = int(seed)
        self.compute_dtype = compute_dtype
        self.data_parallel = bool(data_parallel)
        self.device = device
        self.factory_kwargs = factory_kwargs
        # fitted state
        self.params_: Optional[Dict[str, np.ndarray]] = None
        self.n_features_: Optional[int] = None
        self.history: Dict[str, list] = {}
        self.epoch_seconds_: List[float] = []  # wall time of each epoch of the last fit
        self._module = None
        lookup_factory(self._registry_type, kind)  # fail fast on a bad kind

    def _build_module(self, n_features: int):
        factory = lookup_factory(self._registry_type, self.kind)
        return factory(n_features, compute_dtype=self.compute_dtype, **self.factory_kwargs)

    @property
    def module(self):
        """The factory's module with the fitted weights, on ``device``."""
        if self._module is None:
            if self.params_ is None:
                raise RuntimeError(f"{type(self).__name__} has not been fitted")
            module = self._build_module(self.n_features_)
            module.load_state_dict({k: torch.as_tensor(v) for k, v in self.params_.items()})
            self._module = module.to(resolve_device(self.device)).eval()
        return self._module

    def _stack(self, module):
        return train_core.StackedDense(module)

    def _check_rows(self, n_rows: int) -> None:
        if n_rows == 0:
            raise ValueError("Cannot fit on empty data")

    def fit(self, X, y=None, **kwargs):
        """Fit on the rows of X (targets y, default X): the last
        ``int(items * validation_split)`` items are held out, early stopping
        watches the validation loss (else the training loss) and restores
        the best epoch's parameters."""
        device = resolve_device(self.device)
        X = _as_float32(X)
        Y = X if y is None else _as_float32(y)
        self._check_rows(len(X))
        stack = self._stack(self._build_module(int(X.shape[-1])))
        warmup = stack.warmup
        n = X.shape[0] - warmup  # items: rows, or window starts
        bs = min(self.batch_size, n)
        if self.data_parallel:
            if device.type == "cuda" and torch.cuda.device_count() > 1:
                raise NotImplementedError(
                    "data_parallel over several cards is not ported yet (the mesh slice)"
                )
            logger.info("data_parallel requested but one device is visible; single-device fit")

        # host-side split: the last items are the validation set, each block
        # with the warm-up rows its items need
        n_val = int(n * self.validation_split)
        n_train = n - n_val

        opt = train_core.make_optimizer(self.optimizer, self.learning_rate)
        loss = "mse" if self.loss == "auto" else self.loss
        init_fn, epoch_fn = train_core.make_train_fns(stack, opt, bs, loss=loss)

        def on_device(X, Y):
            return [torch.as_tensor(a, device=device)[None]
                    for a in train_core.pad_to_batches(X, Y, bs, warmup)[:3]]

        Xp, Yp, mask = on_device(X[:n_train + warmup], Y[:n_train + warmup])
        state = init_fn([train_core.member_generator(self.seed, 0)], device)
        lr = torch.full((1,), self.learning_rate, device=device)

        eval_fn = None
        if n_val > 0:
            eval_fn = train_core.make_eval_fn(stack, bs, loss=loss)
            Xvp, Yvp, vmask = on_device(X[n_train:], Y[n_train:])

        self.history = {"loss": []}
        if eval_fn is not None:
            self.history["val_loss"] = []
        best, patience_left = np.inf, self.early_stopping_patience
        best_params = None
        self.epoch_seconds_ = []
        for epoch in range(self.epochs):
            t0 = time.perf_counter()
            state, loss_val = epoch_fn(state, Xp, Yp, mask, lr, n_real=[n_train])
            loss_f = float(loss_val[0])
            self.history["loss"].append(loss_f)
            monitored = loss_f
            if eval_fn is not None:
                val = float(eval_fn(state.params, Xvp, Yvp, vmask)[0])
                self.history["val_loss"].append(val)
                monitored = val
            self.epoch_seconds_.append(time.perf_counter() - t0)
            if self.early_stopping_patience is not None:
                if monitored < best - self.early_stopping_min_delta:
                    best, patience_left = monitored, self.early_stopping_patience
                    best_params = state.params.clone()
                else:
                    patience_left -= 1
                    if patience_left <= 0:
                        logger.info("Early stopping at epoch %d", epoch + 1)
                        break

        final = best_params if best_params is not None else state.params
        self.params_ = stack.state_dicts(final)[0]
        self.n_features_ = int(X.shape[-1])
        self._module = None
        return self

    def predict(self, X) -> np.ndarray:
        """Reconstruction of X."""
        return train_core.batched_apply(self.module, _as_float32(X), resolve_device(self.device))

    def transform(self, X) -> np.ndarray:
        return self.predict(X)

    def _scoring_pair(self, X, y):
        X = _as_float32(X)
        target = X if y is None else _as_float32(y)
        return torch.from_numpy(target), torch.from_numpy(self.predict(X))

    def score(self, X, y=None) -> float:
        """Explained variance of the reconstruction."""
        return float(explained_variance(*self._scoring_pair(X, y)))

    def score_metrics(self, X, y=None) -> Dict[str, float]:
        """Explained variance, r2, MSE and MAE from one prediction pass."""
        return regression_metrics(*self._scoring_pair(X, y))

    def get_metadata(self) -> Dict[str, Any]:
        md: Dict[str, Any] = {
            "type": type(self).__name__,
            "kind": self.kind,
            "params": _jsonable(self.get_params()),
        }
        if self.params_ is not None:
            md["n_features"] = self.n_features_
            md["history"] = self.history
            md["parameter_count"] = int(sum(np.size(p) for p in self.params_.values()))
        return md


class AutoEncoder(BaseEstimator):
    """Feedforward autoencoder over flat feature vectors
    (reference: ``KerasAutoEncoder``)."""


class _SequenceEstimator(BaseEstimator):
    """Shared windowing of the sequence estimators (JAX
    ``SequenceBaseEstimator``): output row i belongs to input row ``i +
    lookback_window - 1 + offset``."""

    _target_offset = 0

    @capture_args
    def __init__(self, kind: str = "lstm_hourglass", lookback_window: int = 10, **kwargs):
        self.lookback_window = int(lookback_window)
        super().__init__(kind=kind, **kwargs)
        self._params = {"kind": kind, "lookback_window": lookback_window, **kwargs}

    def _stack(self, module):
        return train_core.StackedLSTM(module, self.lookback_window, self._target_offset)

    def _check_rows(self, n_rows: int) -> None:
        need = self.lookback_window + self._target_offset
        if n_rows < need:
            raise ValueError(
                f"Need at least lookback_window+{self._target_offset}={need} rows, got {n_rows}"
            )

    def predict(self, X) -> np.ndarray:
        """One output row per window: row i is the model value for input
        row ``i + lookback_window - 1 + offset``."""
        X = _as_float32(X)
        self._check_rows(len(X))
        device = resolve_device(self.device)
        W = sliding_windows(torch.as_tensor(X, device=device), self.lookback_window)
        return train_core.batched_apply(self.module, W[: len(W) - self._target_offset], device)

    def _scoring_pair(self, X, y):
        X = _as_float32(X)
        target = X if y is None else _as_float32(y)
        pred = self.predict(X)  # the rows after the warm-up
        return torch.from_numpy(target[len(X) - len(pred):]), torch.from_numpy(pred)


class LSTMAutoEncoder(_SequenceEstimator):
    """Windowed LSTM autoencoder reconstructing the window's last row
    (reference: ``KerasLSTMAutoEncoder``)."""


class LSTMForecast(_SequenceEstimator):
    """Windowed LSTM forecasting t+1 (reference: ``KerasLSTMForecast``)."""

    _target_offset = 1


class ConvAutoEncoder(_SequenceEstimator):
    """Conv1D window autoencoder: the conv family is not ported, so
    constructing one raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("ConvAutoEncoder: the conv family is not ported yet")


def _jsonable(obj):
    """Best-effort conversion of captured params to JSON-safe values."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)
