"""State sharding of the port's training over the mesh's process groups.

The port's counterpart of what GSPMD does for JAX's jitted step under
``state_sharding_rules`` (``diff_vits_tpu/train/trainer.py:233-243``); it
has no single JAX file. :func:`shard_model` takes a model whose every rank
holds the same whole weights and leaves each rank holding only its shard of
every parameter the rules split; the AdamW moments and the EMA, made from
the parameters, are then shards too. Three pieces:

* :class:`Layout`: the rank's coordinates and the process groups of its
  axes (``dist.new_group`` is called by every rank for every group, in one
  order). A :class:`Group` of one rank makes every collective the
  identity. Under gloo a CUDA tensor goes through the host, and a half
  tensor is reduced in float32.
* :class:`Plan`: each split parameter's :class:`Leaf` (the torch dim each
  axis splits, from the flax-layout spec of ``mesh.state_sharding_rules``)
  and the tensor-parallel sites. A site runs on its shards when every
  leaf of it is split on ``model`` the Megatron way: the column weights on
  their output features, the row weight on its input features, the heads
  and each fused part (``[q | k | v]``, ``[val | gate]``) divisible. Then
  the module gets a ``tp`` group and computes its local heads or hidden
  units (``nn.unet1d.CrossAttention``, ``GEGLUFeedForward``,
  ``nn.fairseq.EncSALayer``, ``TransformerFFNLayer``); a column bias,
  replicated by the rules, is cut to the rank's part each step. A fused
  column weight is split part by part (rank i holds ``[q_i | k_i | v_i]``),
  so that each rank's heads are whole; gathered, it is in one process's
  layout again. ``MoEFeedForward`` gets an ``ep`` group when its expert
  leaves split on the expert axis. Every other split leaf (a site the
  rules split only in part, ZeRO-3's ``fsdp`` splits, the leaves that are
  no site's) is gathered whole at the start of each step.
* The step (:meth:`Plan.bind`, :meth:`Plan.reduce_grads`,
  :meth:`Plan.grad_norm`): gathered leaves are fresh autograd leaves bound
  into the modules in place of the shards for the forward and backward;
  after the backward, a gathered leaf's gradient is cut back to the
  shard, summed over ``fsdp`` (a reduce-scatter: the ``fsdp`` ranks took
  other rows) and merely sliced over ``model`` / ``expert`` (those ranks
  took the same rows and hold the same gradient). Every gradient is then
  averaged over the data ranks that hold the same shard. The global norm
  counts each shard once.

Megatron's two operators (:class:`_Enter`, identity forward / all-reduce
backward; :class:`_Reduce`, all-reduce forward / identity backward) keep
every tensor outside a site whole and its gradient complete on every rank
of the group.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from diff_vits_tpu_torch.parallel import mesh as mesh_lib

# the order in which a leaf's axes are gathered; slices go the other way
_GATHER_ORDER = ("fsdp", "seq", "model", "expert", "data")


class Group:
    """The ranks that differ from this one on the axes ``axes`` only:
    ``size`` of them, this rank at ``index``; ``handle`` is the process
    group (None for a group of one, whose collectives are the identity);
    ``members`` their global ranks in the group's order."""

    def __init__(self, axes: Tuple[str, ...], handle, size: int,
                 index: int, members: Sequence[int] = ()):
        self.axes, self.handle, self.size, self.index = (axes, handle, size,
                                                         index)
        self.members = list(members)

    def _host(self) -> bool:
        return dist.get_backend(self.handle) == "gloo"

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the group, a new tensor (no gradient)."""
        if self.size == 1:
            return t.detach().clone()
        low = t.dtype in (torch.float16, torch.bfloat16)
        buf = t.detach().to("cpu" if self._host() else t.device,
                            torch.float32 if low else t.dtype, copy=True)
        dist.all_reduce(buf, group=self.handle)
        return buf.to(t.device, t.dtype)

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (one shape), in the group's order."""
        if self.size == 1:
            return [t]
        buf = t.detach().to("cpu" if self._host() else t.device).contiguous()
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.handle)
        return [p.to(t.device) for p in parts]

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """Row ``index`` of the sum over the group of ``t`` [size, n]."""
        if self.size == 1:
            return t[0]
        if self._host():    # gloo: the sum, then the rank's row
            return self.all_reduce(t)[self.index]
        out = torch.empty_like(t[0])
        dist.reduce_scatter_tensor(out, t.contiguous(), group=self.handle)
        return out

    def shift_many(self, tensors: Sequence[torch.Tensor],
                   likes: Optional[Sequence[torch.Tensor]] = None,
                   step: int = 1) -> List[torch.Tensor]:
        """One hop round the ring of the group: sends ``tensors`` to the
        rank ``step`` places on (``index + step``) and returns what the rank
        ``step`` places back sent, each shaped and typed like the matching
        one of ``likes`` (default ``tensors``; meta tensors will do), on
        its tensor's device (no gradient). Under gloo through the host."""
        likes = tensors if likes is None else likes
        if self.size == 1:
            return [t.detach().clone() for t in tensors]
        where = ("cpu" if self._host() else tensors[0].device)
        dst = self.members[(self.index + step) % self.size]
        src = self.members[(self.index - step) % self.size]
        ops, got = [], []
        for t, like in zip(tensors, likes):
            send = t.detach().to(where).contiguous()
            recv = torch.empty(like.shape, dtype=like.dtype, device=where)
            ops += [dist.P2POp(dist.isend, send, dst, self.handle),
                    dist.P2POp(dist.irecv, recv, src, self.handle)]
            got.append(recv)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [r.to(t.device) for r, t in zip(got, tensors)]

    # Megatron's operators, for the modules
    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as it enters a site: identity forward, gradient summed over
        the group backward."""
        return _Enter.apply(x, self) if self.size > 1 else x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """A site's partial output summed over the group (forward); the
        gradient passes unchanged."""
        return _Reduce.apply(x, self) if self.size > 1 else x

    def row(self, linear: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """A row-parallel ``linear`` on the rank's input features ``x``:
        the partial products summed over the group, then the bias, once."""
        y = self.reduce(torch.nn.functional.linear(x, linear.weight))
        return y if linear.bias is None else y + linear.bias


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class Layout:
    """Rank ``rank``'s place on ``mesh`` ({axis: size}) and its groups:
    one for each axis, ``dp`` over the data axes (``data``, ``fsdp``),
    ``shard`` over every axis but ``data``. Builds the process groups when
    there is a process group and more than one rank."""

    def __init__(self, mesh: Mapping[str, int], rank: int):
        self.mesh, self.rank = dict(mesh), rank
        self.coords = mesh_lib.coords(self.mesh, rank)
        self.data_index = mesh_lib.data_index(self.mesh, rank)
        self.data_size = mesh_lib.data_size(self.mesh)
        kinds = {a: (a,) for a in self.mesh}
        kinds["dp"] = tuple(a for a in self.mesh if a in mesh_lib.DATA_AXES)
        kinds["shard"] = tuple(a for a in self.mesh if a != "data")
        self.groups = {k: self._group(axes) for k, axes in kinds.items()}

    def _group(self, axes: Tuple[str, ...]) -> Group:
        size = math.prod(self.mesh[a] for a in axes)
        # the group's members in the group's order: varying ``axes``
        # (row-major), the other coordinates this rank's
        index = 0
        for a in axes:
            index = index * self.mesh[a] + self.coords[a]
        if size == 1 or not dist.is_initialized():
            return Group(axes, None, 1, 0, [self.rank])
        handle, mine = None, []
        world = math.prod(self.mesh.values())
        fixed = [a for a in self.mesh if a not in axes]
        seen = set()
        for r in range(world):      # every group, in one order on every rank
            c = mesh_lib.coords(self.mesh, r)
            key = tuple(c[a] for a in fixed)
            if key in seen:
                continue
            seen.add(key)
            members = [q for q in range(world)
                       if all(mesh_lib.coords(self.mesh, q)[a] == c[a]
                              for a in fixed)]
            g = dist.new_group(members)
            if key == tuple(self.coords[a] for a in fixed):
                handle, mine = g, members
        return Group(axes, handle, size, index, mine)

    def group(self, kind: str) -> Group:
        """The group of ``kind`` (an axis, "dp" or "shard"); a group of one
        for an axis the mesh does not have."""
        return self.groups.get(kind) or Group((), None, 1, 0, [self.rank])


@dataclasses.dataclass
class Leaf:
    """A split parameter: its whole torch ``shape``, the torch dim each
    axis splits (``dims``), the axes along which the forward uses the
    rank's shard as it is (``local``), and ``parts``: the fused blocks of
    the ``model`` dim, each split alone (1: the dim is split as a
    whole)."""
    name: str
    shape: Tuple[int, ...]
    dims: Dict[str, int]
    local: Tuple[str, ...] = ()
    parts: int = 1

    def split(self, axis: str) -> int:
        return self.parts if axis == "model" else 1

    def gathered(self) -> List[str]:
        return [a for a in _GATHER_ORDER if a in self.dims
                and a not in self.local]


def block(t: torch.Tensor, dim: int, index: int, n: int,
          parts: int = 1) -> torch.Tensor:
    """Block ``index`` of ``n`` of ``t`` along ``dim``; with ``parts`` > 1,
    the concatenation of block ``index`` of each of the ``parts`` equal
    parts of the dim."""
    size = t.shape[dim] // parts
    step = size // n
    if parts == 1:
        return t.narrow(dim, index * step, step)
    return torch.cat([t.narrow(dim, j * size + index * step, step)
                      for j in range(parts)], dim)


def unblock(blocks: Sequence[torch.Tensor], dim: int,
            parts: int = 1) -> torch.Tensor:
    """The inverse of :func:`block`: the whole tensor from every index's
    block, in index order."""
    if parts == 1:
        return torch.cat(list(blocks), dim)
    step = blocks[0].shape[dim] // parts
    return torch.cat([b.narrow(dim, j * step, step)
                      for j in range(parts) for b in blocks], dim)


# module class name -> (column weights with their parts, column biases
# with their parts, the row module, the attribute holding the head count)
_SITES = {
    "CrossAttention": ((("to_q", 1), ("to_k", 1), ("to_v", 1)), (),
                       "to_out", "heads"),
    "GEGLUFeedForward": ((("proj", 2),), (("proj", 2),), "out", None),
    "EncSALayer": ((("in_proj", 3),), (), "out_proj", "num_heads"),
    "TransformerFFNLayer": ((("ffn_1", 1),), (("ffn_1", 1),), "ffn_2",
                            None),
}
_EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


class Plan:
    """How ``model``'s parameters split over ``layout``'s mesh (see the
    module docstring). ``leaves`` maps each split parameter's name to its
    :class:`Leaf`; ``biases`` each column bias cut for a site to (its
    parts); ``sites`` lists the modules that run on their shards."""

    def __init__(self, model: nn.Module, layout: Layout,
                 min_size: int = 1 << 16, fsdp_axis: str = "fsdp",
                 seq_parallel: bool = False):
        from diff_vits_tpu_torch.utils.convert import flax_leaves
        self.layout = layout
        # the ``seq`` ranks compute other frames of the diffusion UNet
        # (``parallel.activations``): their gradients are then parts of one
        # sum, summed over ``seq``, and not copies
        self.seq_parallel = seq_parallel
        mesh = layout.mesh
        params = dict(model.named_parameters())
        walk = flax_leaves(model)
        shapes = {path: tuple(params[n].shape[d] for d in dims)
                  for n, (path, dims) in walk.items()}
        specs = mesh_lib.state_sharding_rules(mesh, shapes, min_size,
                                              fsdp_axis)
        self.leaves: Dict[str, Leaf] = {}
        for n, (path, dims) in walk.items():
            split = {a: dims[i] for i, a in enumerate(specs[path]) if a}
            if split:
                self.leaves[n] = Leaf(n, tuple(params[n].shape), split)
        self.biases: Dict[str, int] = {}
        self.sites: List[nn.Module] = []
        tp, ep_axis = layout.group("model"), (
            "expert" if mesh.get("expert", 1) > 1 else "model")
        for name, mod in model.named_modules():
            pre = f"{name}." if name else ""
            kind = type(mod).__name__
            if kind in _SITES and tp.size > 1:
                if self._tp_local(mod, pre, *_SITES[kind], tp.size):
                    mod.tp = tp
                    self.sites.append(mod)
            elif kind == "MoEFeedForward":
                got = [self.leaves.get(f"{pre}{w}") for w in _EXPERT_LEAVES]
                if all(g is not None and g.dims == {ep_axis: 0}
                       for g in got):
                    for g in got:
                        g.local = (ep_axis,)
                    mod.ep = layout.group(ep_axis)
                    self.sites.append(mod)

    def _tp_local(self, mod, pre, cols, biases, row, heads_attr, m) -> bool:
        """Whether the site ``mod`` runs on its shards; marks its leaves
        when it does."""
        col = [(self.leaves.get(f"{pre}{c}.weight"), parts)
               for c, parts in cols]
        r = self.leaves.get(f"{pre}{row}.weight")
        heads = getattr(mod, heads_attr) if heads_attr else m
        ok = (r is not None and r.dims.get("model") == 1 and heads % m == 0
              and all(c is not None and c.dims.get("model") == 0
                      and (c.shape[0] // parts) % m == 0
                      for c, parts in col))
        if not ok:
            return False
        r.local = r.local + ("model",)
        for c, parts in col:
            c.local, c.parts = c.local + ("model",), parts
        for b, parts in biases:
            if getattr(mod, b).bias is not None:
                self.biases[f"{pre}{b}.bias"] = parts
        return True

    @property
    def active(self) -> bool:
        return bool(self.leaves)

    # -- placement ---------------------------------------------------------

    def shard(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's shard of parameter ``name``'s ``whole`` value (or of
        a tensor of its shape: a moment, the EMA); ``whole`` itself for a
        parameter that is not split. A new contiguous tensor."""
        leaf = self.leaves.get(name)
        if leaf is None:
            return whole
        t = whole
        for a, d in leaf.dims.items():
            t = block(t, d, self.layout.coords[a], self.layout.mesh[a],
                      leaf.split(a))
        return t.contiguous().clone()

    def gather(self, values: Mapping[str, torch.Tensor],
               axes: Optional[Mapping[str, Sequence[str]]] = None
               ) -> Dict[str, torch.Tensor]:
        """``values`` (parameter name -> this rank's shard) gathered along
        ``axes[name]`` (default: every axis that splits it), one collective
        an axis; no gradient. Every rank of the mesh must call it."""
        out = {n: v.detach() for n, v in values.items()}
        for a in _GATHER_ORDER:
            group = self.layout.group(a)
            names = [n for n in out if n in self.leaves
                     and a in (axes[n] if axes is not None
                               else self.leaves[n].dims)]
            if group.size == 1 or not names:
                continue
            flat = torch.cat([out[n].reshape(-1) for n in names])
            every = group.all_gather(flat)
            off = 0
            for n in names:
                k, shape = out[n].numel(), out[n].shape
                leaf = self.leaves[n]
                out[n] = unblock([e[off:off + k].view(shape) for e in every],
                                 leaf.dims[a], leaf.split(a))
                off += k
        return out

    # -- the step ----------------------------------------------------------

    def working(self, params: Mapping[str, nn.Parameter]
                ) -> Dict[str, torch.Tensor]:
        """The step's gathered leaves: each split parameter's non-local
        axes gathered, as a fresh autograd leaf."""
        need = {n: leaf.gathered() for n, leaf in self.leaves.items()
                if leaf.gathered()}
        got = self.gather({n: params[n] for n in need}, need)
        return {n: t.requires_grad_(True) for n, t in got.items()}

    @contextlib.contextmanager
    def bind(self, model: nn.Module, working: Mapping[str, torch.Tensor]
             ) -> Iterator[None]:
        """Inside the block ``model`` computes with ``working`` in place of
        the shards of the gathered leaves, and with each site's column
        bias cut to the rank's part (cut here, so that each micro-batch's
        backward has its own cut)."""
        if not self.active:
            yield
            return
        params = dict(model.named_parameters())
        tp = self.layout.group("model")
        values = dict(working)
        for n, parts in self.biases.items():
            values[n] = block(params[n], 0, tp.index, tp.size, parts)
        with swap(model, {id(params[n]): v for n, v in values.items()}):
            yield

    def reduce_grads(self, params: Mapping[str, nn.Parameter],
                     working: Mapping[str, torch.Tensor]) -> None:
        """Every parameter's gradient as one process would have it for the
        rank's shard: the gathered leaves' gradients cut back to their
        shards (summed over ``fsdp``, and over ``seq`` under sequence
        parallelism; sliced over ``model`` / ``expert``), every other
        gradient summed over ``seq`` under sequence parallelism, the cut
        column biases' summed over ``model``, then every gradient
        averaged over the data ranks that hold the same shard. A parameter
        no data rank used keeps no gradient. Every rank must call it."""
        lay = self.layout
        names = list(params)
        grads = {n: (working[n].grad if n in working else params[n].grad)
                 for n in names}
        dp = lay.group("dp")
        used = torch.tensor([float(grads[n] is not None) for n in names],
                            device=params[names[0]].device)
        if dp.size > 1:
            used = dp.all_reduce(used)
        live = [n for n, u in zip(names, used.tolist()) if u > 0]
        g = {n: (grads[n] if grads[n] is not None
                 else torch.zeros_like(working.get(n, params[n])))
             for n in live}
        # the axes whose ranks hold other parts of one sum: fsdp (other
        # rows) and, under sequence parallelism, seq (other frames); a
        # split leaf's gradient is reduce-scattered over them and merely
        # sliced over the others (model, expert, and seq otherwise: those
        # ranks hold the same gradient)
        summed = ("fsdp", "seq") if self.seq_parallel else ("fsdp",)
        for n in live:
            leaf = self.leaves.get(n)
            if leaf is None or n not in working:
                continue
            for a in reversed(leaf.gathered()):
                if a not in mesh_lib.DATA_AXES and a not in summed:
                    g[n] = block(g[n], leaf.dims[a], lay.coords[a],
                                 lay.mesh[a], leaf.split(a))
        for a in summed:
            group = lay.group(a)
            rs = [n for n in live if n in working
                  and a in self.leaves[n].gathered()]
            if group.size == 1 or not rs:
                continue
            rows = [torch.cat([block(g[n], self.leaves[n].dims[a], i,
                                     group.size).reshape(-1) for n in rs])
                    for i in range(group.size)]
            mine = group.reduce_scatter(torch.stack(rows))
            off = 0
            for n in rs:
                shape = params[n].shape
                k = math.prod(shape)
                g[n] = mine[off:off + k].view(shape)
                off += k
        # under sequence parallelism every other gradient is summed over seq
        seq = lay.group("seq")
        if self.seq_parallel and seq.size > 1:
            rest = [n for n in live if not (n in self.leaves
                                            and "seq" in self.leaves[n].dims)]
            flat = seq.all_reduce(torch.cat([g[n].reshape(-1).float()
                                             for n in rest]))
            off = 0
            for n in rest:
                k = g[n].numel()
                g[n] = flat[off:off + k].view_as(g[n]).to(g[n].dtype)
                off += k
        # a cut column bias: each model rank has its part's gradient
        cut = [n for n in live if n in self.biases]
        if cut:
            flat = lay.group("model").all_reduce(
                torch.cat([g[n].reshape(-1) for n in cut]))
            off = 0
            for n in cut:
                k = g[n].numel()
                g[n] = flat[off:off + k].view_as(g[n])
                off += k
        # the data ranks holding the same shard: data (and fsdp for a leaf
        # fsdp does not split)
        by_group: Dict[str, List[str]] = {}
        for n in live:
            split = n in self.leaves and "fsdp" in self.leaves[n].dims
            by_group.setdefault("data" if split else "dp", []).append(n)
        for kind, members in by_group.items():
            flat = lay.group(kind).all_reduce(torch.cat(
                [g[n].reshape(-1).float() for n in members]))
            off = 0
            for n in members:
                k = g[n].numel()
                g[n] = (flat[off:off + k] / lay.data_size).view_as(g[n])
                off += k
        for n in names:
            p = params[n]
            p.grad = g[n].to(p.dtype) if n in g else None

    def grad_norm(self, params: Mapping[str, nn.Parameter]) -> torch.Tensor:
        """The global norm of the whole gradient from the ranks' shards:
        each leaf's squared norm over the copies of it the ``shard`` group
        holds, summed over that group."""
        shard = self.layout.group("shard")
        with_grad = [(n, p.grad) for n, p in params.items()
                     if p.grad is not None]
        norms = torch._foreach_norm([g for _, g in with_grad])
        copies = torch.tensor([
            shard.size / math.prod(self.layout.mesh[a]
                                   for a in self.leaves[n].dims)
            if n in self.leaves else float(shard.size)
            for n, _ in with_grad], device=norms[0].device)
        sq = (torch.stack(norms).float() ** 2 / copies).sum()
        return shard.all_reduce(sq).sqrt()


@contextlib.contextmanager
def swap(model: nn.Module, values: Mapping[int, torch.Tensor]
         ) -> Iterator[None]:
    """Inside the block, every module of ``model`` that holds a parameter
    whose ``id`` is a key of ``values`` reads the tensor given for it
    instead (a shared parameter in every module that holds it)."""
    done = []
    try:
        for mod in model.modules():
            for k, p in list(mod._parameters.items()):
                if p is not None and id(p) in values:
                    mod._parameters[k] = values[id(p)]
                    done.append((mod, k, p))
        yield
    finally:
        for mod, k, p in done:
            mod._parameters[k] = p


def shard_model(model: nn.Module, layout: Layout,
                min_size: int = 1 << 16, fsdp_axis: str = "fsdp",
                seq_parallel: bool = False) -> Plan:
    """The :class:`Plan` of ``model`` over ``layout`` (ZeRO-3 over
    ``fsdp_axis``; ``seq_parallel``: the step shards the diffusion UNet's
    frames over ``seq``), and each split parameter of ``model`` replaced
    by a parameter holding this rank's shard of its value (every rank must
    hold the same whole weights)."""
    plan = Plan(model, layout, min_size, fsdp_axis, seq_parallel)
    if not plan.active:
        return plan
    params = dict(model.named_parameters())
    new = {id(params[n]): nn.Parameter(plan.shard(n, params[n].detach()),
                                       requires_grad=params[n].requires_grad)
           for n in plan.leaves}
    for mod in model.modules():
        for k, p in list(mod._parameters.items()):
            if p is not None and id(p) in new:
                mod._parameters[k] = new[id(p)]
    return plan


@contextlib.contextmanager
def whole(model: nn.Module, plan: Plan) -> Iterator[None]:
    """Inside the block ``model`` computes as one process with the whole
    parameters (gathered here: every rank must enter) and no site runs on
    its shards."""
    params = dict(model.named_parameters())
    full = plan.gather({n: params[n] for n in plan.leaves})
    attr = [(m, "ep" if hasattr(m, "ep") else "tp") for m in plan.sites]
    saved = [getattr(m, a) for m, a in attr]
    for m, a in attr:
        setattr(m, a, None)
    try:
        with swap(model, {id(params[n]): v for n, v in full.items()}):
            yield
    finally:
        for (m, a), g in zip(attr, saved):
            setattr(m, a, g)
