"""PyTorch + CUDA port of gordo-components-tpu for NVIDIA Hopper.

It serves banked feedforward and LSTM anomaly detectors: port artifacts
(``serializer``) are stacked into a :class:`~.server.bank.ModelBank` on the
card and scored through a batching engine behind the gordo HTTP routes
(``server``). The anomaly-score epilogue (``ops/csrc/anomaly_score.cu``)
and the fused LSTM step (``ops/csrc/lstm_step.cu``) run as hand-written
CUDA kernels.

The package imports torch, numpy and the standard library only. Every entry
point takes a ``device`` that defaults to ``"cuda"`` and raises when CUDA is
missing, unless ``"cpu"`` is passed explicitly.
"""

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]


def __getattr__(name):
    # torch is imported on first use of ``resolve_device``, so that a
    # process that needs only the dataset modules (a spawned staging
    # worker, ``utils/staging.py``) never imports it
    if name == "resolve_device":
        from gordo_components_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
