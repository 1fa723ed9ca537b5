"""Gradients of the kernel routes of K1-K4.

The JAX package gives each Pallas kernel a ``custom_vjp`` whose backward
is the VJP of its XLA twin (``diff_vits_tpu/ops/fused_resnet.py:189-190``,
``ops/fused_transformer.py:131-134``). The port's counterpart: the forward
runs the CUDA kernels, which fill buffers through ctypes and so leave no
autograd graph; the backward recomputes the plain PyTorch version on the
saved inputs and differentiates it. Weights reach the kernels as views of
the modules' parameters (``linear.weight.t()``,
``conv.weight.permute(2, 1, 0)``); they are the Function's inputs, so their
gradients flow on to the parameters. Launch counters see forwards only.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


class KernelFunction(torch.autograd.Function):
    """forward: ``kernels(*args)``; backward: autograd of ``plain(*args)``,
    recomputed."""

    @staticmethod
    def forward(ctx, kernels: Callable, plain: Callable,
                *args: Optional[torch.Tensor]) -> torch.Tensor:
        ctx.plain = plain
        ctx.save_for_backward(*args)
        return kernels(*args)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [None if a is None else a.detach().requires_grad_(n)
                      for a, n in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(*leaves)
        wanted = [a for a in leaves if a is not None and a.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad_out,
                                         allow_unused=True))
        return (None, None, *(next(grads) if a is not None and a.requires_grad
                              else None for a in leaves))


def run_kernels(kernels: Callable, plain: Callable,
                *args: Optional[torch.Tensor]) -> torch.Tensor:
    """``kernels(*args)``, through :class:`KernelFunction` when autograd
    records and an input needs a gradient."""
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad for a in args):
        return KernelFunction.apply(kernels, plain, *args)
    return kernels(*args)
