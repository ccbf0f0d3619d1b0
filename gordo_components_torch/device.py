"""Where the port runs: the card unless the caller asks for the CPU."""

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, defaulting to the card.

    Raises when a CUDA device is asked for (the default) and CUDA is not
    available: the port never moves to the CPU on its own. Only an
    explicit ``"cpu"`` runs there, which is how the CPU tests run it.

    On the card, TF32 is switched off for matrix products and cuDNN, so
    float32 stays full float32 like the JAX reference.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but CUDA is not available; pass "
                "device='cpu' to run the port on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev
