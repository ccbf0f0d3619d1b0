"""The stacked dense chain: every member's dense layers at once.

One forward for the port's dense layers wherever they run: the training
stacks of the feedforward and variational autoencoders
(``models/train_core``), the variational module itself, and the bank's
dense buckets (``server/bank``), which gather their slots' kernels first.

In bfloat16 a layer rounds as Flax's ``Dense(dtype=bfloat16)`` with float32
parameters does: input, kernel and bias cast to bfloat16, the product
accumulated in float32 and rounded to bfloat16, then the bias added in
bfloat16 (``torch.bmm`` then ``+``; ``torch.baddbmm`` would round once).
"""

import torch


def dense(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x`` (M, B, in) @ ``W`` (M, in, out) + ``b`` (M, out) in ``x``'s
    dtype: one ``torch.baddbmm`` in float32; in bfloat16 the product
    rounded, then the bias added."""
    if x.dtype == torch.float32:
        return torch.baddbmm(b.unsqueeze(1), x, W)
    return torch.bmm(x, W.to(x.dtype)) + b.to(x.dtype).unsqueeze(1)


def dense_chain(x: torch.Tensor, layers, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x`` (M, B, in) through ``(kernel (M, in, out), bias (M, out),
    activation)`` layers computed in ``dtype`` (the result is in
    ``dtype``; a module casts its output to float32)."""
    x = x.to(dtype)
    for W, b, act in layers:
        x = act(dense(x, W, b))
    return x
