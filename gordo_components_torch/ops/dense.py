"""The stacked dense chain: every member's dense layers at once.

One forward for the port's dense layers wherever they run: the training
stacks of the feedforward and variational autoencoders
(``models/train_core``), the variational module itself, and the bank's
dense buckets (``server/bank``), which gather their slots' kernels first.
"""

import torch


def dense_chain(x: torch.Tensor, layers) -> torch.Tensor:
    """``x`` (M, B, in) through ``(kernel (M, in, out), bias (M, out),
    activation)`` layers, one ``torch.baddbmm`` each."""
    for W, b, act in layers:
        x = act(torch.baddbmm(b.unsqueeze(1), x, W))
    return x
