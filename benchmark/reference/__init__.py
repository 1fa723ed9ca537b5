"""A frozen plain-PyTorch reference of the model the benchmark measures.

Copied once from the port's plain route and cut to what the benchmark's
configurations run: the VITS prior (text encoder, posterior encoder, the
UNet and stochastic duration predictors, the residual-coupling flow, MAS),
the diffusion denoiser (prompt encoder, conditional UNet) with its 30-step
UniPC sampler, the training loss and step, and Vocos. No kernel, no
routing, no sharding, no remat: every product is a plain ``torch`` call,
and ``plain_math()`` turns TF32 off so that float32 is float32 on the card.

Parameter names match the port's state dict, so one state dict loads into
both. Nothing here imports the port, JAX or the JAX package.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def plain_math():
    """float32 products in float32: TF32 off for matmuls and cuDNN convs
    inside the block, the previous settings restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
