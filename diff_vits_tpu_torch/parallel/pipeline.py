"""GPipe pipeline parallelism over a mesh axis.

Port of ``diff_vits_tpu/parallel/pipeline.py`` (``_stage_body`` :35,
``make_pipeline`` :88) on ``torch.distributed``: for a stack of identical,
shape-preserving layers (the PromptEncoder's ``EncSALayer`` stack, a
transformer trunk) each rank of the ``stage`` axis runs one contiguous
group of layers; micro-batches stream through the ranks and activations
hop one stage a tick (``sharding.Group.shift_many``, through the host
under gloo). JAX's schedule: ``n_micro + n_stage - 1`` ticks, stage 0
ingests micro-batch t at tick t, stage s works on micro-batch ``t - s``,
the last stage emits it; the bubble is ``(n_stage - 1) / (n_micro +
n_stage - 1)`` of the ticks. Where JAX computes on the bubble's zeros and
drops the result, a stage here skips those ticks, which changes nothing
that reaches the output. At the end every stage gets the output (JAX's
``psum`` of the last stage's buffer).

Parameters are "stacked": a dict of tensors, each with a leading
``n_layers`` axis; each stage uses its ``n_layers / n_stage`` rows.

Gradients (:class:`_Pipeline`): JAX differentiates its ``fori_loop``,
``ppermute`` and ``psum``; here the forward keeps each stage's autograd
graph of each micro-batch, and the backward runs the schedule in reverse,
a gradient hopping one stage back a tick: the last stage starts from the
output's gradient (the same on every stage: the caller's loss is), each
stage backpropagates its layers for its micro-batch and sends the input's
gradient on. Each rank's parameter rows and stage 0's x then get their
gradients, summed over the stages, so every rank gets the whole gradient
of the stacked parameters and of x. Every rank takes part in every hop of
both trips, whatever its stage computes that tick.

Usage::

    fn = make_pipeline(layer_fn, mesh, n_microbatches=8)   # mesh has stage
    y = fn(stacked_params, x)       # == the layers applied in order

``layer_fn(params_i, x) -> y`` takes one layer's parameters (each stacked
tensor's row i) and must keep x's shape.
"""
from __future__ import annotations

from typing import Callable, Mapping, Union

import torch

from diff_vits_tpu_torch.parallel import mesh as mesh_lib
from diff_vits_tpu_torch.parallel.sharding import Group, Layout


def sequential(layer_fn: Callable, stacked_params: Mapping[str, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    """The stack's layers applied in order (JAX's ``lax.scan`` of
    ``layer_fn``): what the pipeline computes."""
    n_layers = next(iter(stacked_params.values())).shape[0]
    for i in range(n_layers):
        x = layer_fn({k: v[i] for k, v in stacked_params.items()}, x)
    return x


def make_pipeline(layer_fn: Callable, mesh: Union[Layout, Mapping[str, int]],
                  n_microbatches: int, axis_name: str = "stage"):
    """``f(stacked_params, x) -> y``: ``layer_fn`` over the stacked layers,
    pipelined over ``axis_name`` of ``mesh`` (a ``sharding.Layout``, or a
    {axis: size} mesh whose Layout is built here: every rank must call
    this). ``stacked_params``: a dict of tensors [n_layers, ...] with
    n_layers divisible by the axis' size; x: [batch, ...] with batch
    divisible by ``n_microbatches`` (ValueError otherwise, as JAX's).
    Every rank passes the same whole inputs and gets the whole output."""
    layout = mesh if isinstance(mesh, Layout) else Layout(mesh,
                                                          mesh_lib.rank())
    group = layout.group(axis_name)
    n_stage, stage = group.size, group.index
    n_micro = n_microbatches

    def fn(stacked_params: Mapping[str, torch.Tensor], x: torch.Tensor
           ) -> torch.Tensor:
        n_layers = next(iter(stacked_params.values())).shape[0]
        if n_layers % n_stage:
            raise ValueError(f"{n_layers} layers not divisible by "
                             f"{n_stage} stages")
        if x.shape[0] % n_micro:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"{n_micro} microbatches")
        names = list(stacked_params)
        return _Pipeline.apply(layer_fn, group, n_micro, names, x,
                               *(stacked_params[k] for k in names))

    return fn


class _Pipeline(torch.autograd.Function):
    """The schedule (module docstring) on whole x and stacked values
    (their names ``names``), and its reverse for the gradients."""

    @staticmethod
    def forward(ctx, layer_fn, group: Group, n_micro: int, names, x,
                *values):
        n_stage, stage = group.size, group.index
        per = values[0].shape[0] // n_stage
        mine = {k: v[stage * per:(stage + 1) * per].detach()
                .requires_grad_(v.requires_grad)
                for k, v in zip(names, values)}
        b = x.shape[0]
        x_micro = x.detach().reshape((n_micro, b // n_micro)
                                     + tuple(x.shape[1:]))
        ins, outs = {}, {}
        out_buf = torch.zeros_like(x_micro)
        state = torch.zeros_like(x_micro[0])
        n_ticks = n_micro + n_stage - 1
        for t in range(n_ticks):
            m = t - stage       # the micro-batch this stage holds
            if 0 <= m < n_micro:
                inp = (x_micro[m] if stage == 0 else state).detach()
                ins[m] = inp.requires_grad_(x.requires_grad or stage > 0)
                with torch.enable_grad():
                    outs[m] = sequential(layer_fn, mine, ins[m])
                state = outs[m].detach()
                if stage == n_stage - 1:
                    out_buf[m] = state
            else:               # the bubble: JAX's result here is dropped
                state = torch.zeros_like(x_micro[0])
            if t < n_ticks - 1:
                state = group.shift_many([state.contiguous()])[0]
        ctx.group, ctx.names, ctx.per, ctx.n_micro = group, names, per, \
            n_micro
        ctx.mine, ctx.ins, ctx.outs = mine, ins, outs
        ctx.shapes = [v.shape for v in values]
        y = group.all_reduce(out_buf) if n_stage > 1 else out_buf
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, gy):
        group, names, per = ctx.group, ctx.names, ctx.per
        n_stage, stage = group.size, group.index
        ins, outs, mine = ctx.ins, ctx.outs, ctx.mine
        n_micro = ctx.n_micro
        g_micro = gy.reshape((n_micro, -1) + tuple(gy.shape[1:]))
        keys = [k for k in names if mine[k].requires_grad]
        g_par = {k: torch.zeros_like(mine[k]) for k in names}
        g_x = torch.zeros_like(g_micro)
        send = torch.zeros_like(g_micro[0])
        n_ticks = n_micro + n_stage - 1
        for t in reversed(range(n_ticks)):
            if t < n_ticks - 1:     # stage s+1's input gradient of tick t+1
                got = group.shift_many([send.contiguous()], step=-1)[0]
            m = t - stage
            if 0 <= m < n_micro:
                g_out = g_micro[m] if stage == n_stage - 1 else got
                wrt = [ins[m]] if ins[m].requires_grad else []
                grads = torch.autograd.grad(
                    outs[m], wrt + [mine[k] for k in keys], g_out,
                    allow_unused=True)
                g_in = grads[0] if wrt else None
                for k, g in zip(keys, grads[len(wrt):]):
                    if g is not None:
                        g_par[k] += g
                send = (torch.zeros_like(g_micro[0]) if g_in is None
                        else g_in)
                if stage == 0 and g_in is not None:
                    g_x[m] = g_in
            else:
                send = torch.zeros_like(g_micro[0])
        whole = []
        for k, shape in zip(names, ctx.shapes):
            g = torch.zeros(shape, dtype=g_par[k].dtype,
                            device=g_par[k].device)
            g[stage * per:(stage + 1) * per] = g_par[k]
            whole.append(g)
        flat = torch.cat([g_x.reshape(-1)] + [g.reshape(-1) for g in whole])
        if n_stage > 1:
            flat = group.all_reduce(flat)
        out, off = [], g_x.numel()
        for g in whole:
            out.append(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        return (None, None, None, None, flat[:g_x.numel()].view(gy.shape),
                *out)
