"""Kernel ops: plain PyTorch on the CPU, hand-written CUDA on the card.

Each op's wrapper counts the times it launched its kernels in an integer
attribute ``launches``; :func:`launch_counts` and :func:`reset_launches`
read and zero them all. ``attention`` counts the launches of the attention
core (``_cuda.attention``, csrc/attention.cu) that K2 and K3 share, one for
each of their launches. K8's launchers and K5's wrapper also count their
launches by route (tensor-core or FMA kernels;
``flash_attention.route_counts``, ``rel_attention.route_counts``), and
:func:`reset_launches` zeroes those too.
"""
from __future__ import annotations

from typing import Dict

from diff_vits_tpu_torch.ops import _cuda
from diff_vits_tpu_torch.ops.flash_attention import (
    flash_attention_backward, flash_attention_forward, reset_route_counts)
from diff_vits_tpu_torch.ops.fused_resnet import fused_resnet_block
from diff_vits_tpu_torch.ops.fused_transformer import (
    fused_cross_attention, fused_geglu_ff, fused_self_attention)
from diff_vits_tpu_torch.ops.mas import maximum_path
from diff_vits_tpu_torch.ops import rel_attention
from diff_vits_tpu_torch.ops.rel_attention import fused_rel_self_attention
from diff_vits_tpu_torch.ops.spline import unconstrained_rqs

KERNEL_OPS = (fused_resnet_block, fused_self_attention,
              fused_cross_attention, fused_geglu_ff, fused_rel_self_attention,
              maximum_path, unconstrained_rqs, flash_attention_forward,
              flash_attention_backward, _cuda.attention)


def launch_counts() -> Dict[str, int]:
    return {op.__name__: op.launches for op in KERNEL_OPS}


def reset_launches() -> None:
    for op in KERNEL_OPS:
        op.launches = 0
    reset_route_counts()
    rel_attention.reset_route_counts()
