"""Where the port runs, and in which precision it computes."""

import numpy as np
import torch

# compute_dtype names the port accepts, as the JAX package spells them
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def full_precision_products() -> None:
    """Matrix products as the JAX reference computes them: TF32 off for
    matmul and cuDNN, so float32 stays full float32, and bfloat16 products
    reduced in float32 (no reduced-precision reduction), as XLA's are."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, defaulting to the card.

    Raises when a CUDA device is asked for (the default) and CUDA is not
    available: the port never moves to the CPU on its own. Only an
    explicit ``"cpu"`` runs there, which is how the CPU tests run it.

    On the card, products run in full precision
    (:func:`full_precision_products`), like the JAX reference.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but CUDA is not available; pass "
                "device='cpu' to run the port on the CPU"
            )
        full_precision_products()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev


def resolve_compute_dtype(name) -> torch.dtype:
    """The torch dtype a model computes in, from its ``compute_dtype``:
    ``"float32"`` or ``"bfloat16"`` (Flax's ``dtype=bfloat16`` with float32
    parameters). Any other value raises ``NotImplementedError``."""
    try:
        return COMPUTE_DTYPES[name]
    except (KeyError, TypeError):
        raise NotImplementedError(
            f"compute_dtype={name!r}: the port computes in 'float32' or 'bfloat16'"
        ) from None


def rows_tensor(a: np.ndarray, device=None) -> torch.Tensor:
    """``torch.as_tensor(a, device=device)`` for rows that may be
    read-only (a tensor request body's ``np.frombuffer`` views). A
    read-only array goes through ``torch.tensor``, which copies it: on the
    card that is the one host-to-device copy ``as_tensor`` makes too, on
    the CPU a host copy, so no tensor is a view torch could write through
    (``as_tensor`` would share it and warn)."""
    if a.flags.writeable:
        return torch.as_tensor(a, device=device)
    return torch.tensor(a, device=device)
