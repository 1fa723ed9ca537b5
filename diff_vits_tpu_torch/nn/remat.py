"""Rematerialisation of the training step (``train.remat_policy``).

Port of the policies of ``diff_vits_tpu/train/trainer.py:84-113``
(``make_loss_fn``). JAX wraps the whole loss in ``jax.checkpoint``; in
PyTorch a checkpoint around the whole loss saves almost nothing, since
its recompute holds every activation again, so here the unit is the block
that holds activations: each ``ResnetBlock1D`` and ``BasicTransformerBlock``
of the denoiser and duration-predictor UNets, each layer of the VITS
``Encoder`` (the TextEncoder) and of the ``PromptEncoder`` (``EncSALayer``),
each layer of the posterior encoder's ``WN``. A module with a ``remat``
attribute routes its forward through :func:`remat_call`;
:func:`set_remat` sets the policy of every such module of a model.

* ``"none"``: no checkpoint.
* ``"full"``: ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``:
  the block keeps its inputs and recomputes the rest in the backward.
* ``"dots"``: the same regions under a selective-checkpoint policy that
  saves the outputs of ``mm``, ``addmm``, ``bmm`` and ``baddbmm`` and
  recomputes everything else (JAX's ``checkpoint_dots``: products saved;
  convolutions and elementwise chains recomputed).

The kernels launched through ``ctypes`` (K6 MAS and K8 flash attention,
``ops/_cuda.py``) are invisible to the dispatcher, so no policy can save
their outputs: a K8 forward inside a region runs again in the recompute,
as a Pallas call is recomputed under ``checkpoint_dots``. A step under
``dots`` or ``full`` therefore launches the K8 forward twice for each call
through the flash gate (once in the forward, once in the recompute) and
its backward once.

Randomness: ``torch.utils.checkpoint`` restores only the global CPU and
CUDA random states, never a ``torch.Generator`` that the caller passes
down, and every dropout mask of the port comes from such a generator. A
plain checkpoint would recompute other masks in the backward and give
wrong gradients. :func:`remat_call` therefore sets the region's generator
back to its state at the region's start for the recompute and afterwards
returns it to where the backward found it (the end of the forward).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
    noop_context_fn)

POLICIES = ("none", "dots", "full")

_aten = torch.ops.aten
# the products whose outputs "dots" keeps (jax.checkpoint_policies.
# checkpoint_dots keeps every dot_general)
SAVED_PRODUCTS = frozenset((_aten.mm.default, _aten.addmm.default,
                            _aten.bmm.default, _aten.baddbmm.default))


def check_policy(policy: str) -> str:
    """``policy`` if it is one of :data:`POLICIES`; ValueError otherwise,
    as JAX raises on an unknown policy (trainer.py:110-112)."""
    if policy not in POLICIES:
        raise ValueError(f"unknown train.remat_policy {policy!r}")
    return policy


def set_remat(module: torch.nn.Module, policy: str) -> None:
    """Set the rematerialisation policy of every checkpointable block under
    ``module``."""
    check_policy(policy)
    for m in module.modules():
        if hasattr(m, "remat"):
            m.remat = policy


def _save_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_contexts():
    return create_selective_checkpoint_contexts(_save_products)


def _replaying(fn: Callable, generator: torch.Generator) -> Callable:
    """``fn`` that draws, in every call after its first (the recompute), from
    ``generator`` as it stood at the first call's start, and leaves the
    generator where that later call found it."""
    start = generator.get_state()
    calls = [0]

    @functools.wraps(fn)
    def run(*args, **kwargs):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*args, **kwargs)
        resume = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*args, **kwargs)
        finally:
            generator.set_state(resume)
    return run


def remat_call(policy: str, fn: Callable, *args,
               generator: Optional[torch.Generator] = None, **kwargs):
    """``fn(*args, generator=generator, **kwargs)`` (without the generator
    keyword when it is None) checkpointed under ``policy`` while autograd
    records; a plain call otherwise. ``generator`` is the explicit
    generator that ``fn`` draws from, replayed in the recompute."""
    if generator is not None:
        kwargs["generator"] = generator
    if policy == "none" or not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    if generator is not None:
        fn = _replaying(fn, generator)
    # every draw of the port comes from an explicit generator, replayed
    # above: the global random states need no stash
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=(_dots_contexts if policy == "dots"
                                  else noop_context_fn), **kwargs)
