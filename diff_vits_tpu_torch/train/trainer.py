"""Training loop of the port: loss, backward, clipped AdamW, EMA,
checkpoints.

Port of ``diff_vits_tpu/train/trainer.py``, on one process or, under
``torchrun``, data parallel over the ranks of a ``torch.distributed``
process group (``parallel.mesh``):

* ``make_optimizer``: AdamW with optax.adamw's weight decay (1e-4, not
  torch's 1e-2 default), betas and eps from the config;
* ``clip_by_global_norm_scheduled``: global-norm clip to 10.0 before
  ``clip_switch_step`` and 1.0 after, returning the pre-clip norm
  (trainer.py:46-52);
* the MAS noise anneal from the step before it is incremented, gradient
  accumulation as the mean of the micro-batch gradients, the refer1/refer2
  coin flip per micro-batch (trainer.py:126-164, :332-345);
* EMA as a float32 copy of the parameters, never an alias of them,
  updated after each optimizer step (trainer.py:159-163, :216-222);
* bfloat16 ``torch.autocast`` on the card when ``train.compute_dtype`` is
  "bfloat16", over float32 master weights;
* ``train.remat_policy`` "none", "dots" or "full" (trainer.py:84-113),
  block by block through ``nn.remat`` (which says why the block and not
  the whole loss is the unit, and how the dropout generator is replayed).

Parallelism (trainer.py:175-245, :286-330): ``train.mesh_shape`` over
the world size as JAX's ``make_mesh`` takes it (``parallel.mesh``), with
any of the axes JAX's ``Trainer`` takes: ``data``, ``fsdp``, ``model``,
``expert``, ``seq``. Every rank builds the same initial weights from
``train.seed``; then ``parallel.sharding.shard_model`` leaves it holding
only its shard of every parameter JAX's ``state_sharding_rules`` split
(Megatron tensor parallelism over ``model``, ZeRO-3 over ``fsdp``, MoE
experts over ``expert``, else over ``model``; leaves of at least
``min_size`` elements, 1 << 16 as in JAX), and the AdamW moments and the
EMA are made from the shards. The step equals JAX's step on the global
batch:

* rows go over the data axes only (``data`` and ``fsdp``: ZeRO-3 is data
  parallel); the ranks that differ only on ``model``, ``expert`` or
  ``seq`` take the same rows. A data rank takes ``train_batch_size /
  data ranks`` rows (the loaders' ``host_id`` / ``num_hosts`` shard);
* with ``sequence_parallel`` (JAX's ``Trainer`` never asks for it; its
  callers do, as ``__graft_entry__.py:231`` does) each step runs inside
  ``parallel.activations.sequence_parallel``: the ``seq`` ranks run the
  diffusion UNet on their frames and everything else whole, the loss is
  split as ``DiffVits.forward`` says and every gradient is summed over
  ``seq``; ``fsdp_axis="seq"`` makes ``seq`` ZeRO-3's axis as well. A
  ``stage`` axis is refused, as JAX's ``Trainer`` refuses it;
* the two loss terms that divide by a sum over the whole batch (l_length
  and the KL terms) divide by that sum's mean over the data ranks, and the
  MAS noise is scaled by the global batch's std (``rank_mean``);
  ``loss_diff`` is a mean of per-item means and needs none;
* the split leaves a site cannot use as shards are gathered at the start
  of the step; after the accumulation loop and before the clip each
  gradient is cut back to its shard and averaged over the data ranks that
  hold that shard (``Plan.reduce_grads``: zeros for a parameter unused on
  a rank; a parameter unused on every rank keeps no gradient, as it would
  on one process); the clip's global norm counts every shard once;
* t, the diffusion, posterior and MAS noise and the dropout masks come
  from a generator seeded by (``train.seed``, data coordinate), data rank
  0's being the one-process generator, so the ranks that share rows draw
  the same; the refer1/refer2 coin is the same on every rank;
* metrics are averaged over the data ranks before they are logged;
  checkpoints, ``save_flax``, tensorboard and ``eval_sample`` are rank
  0's, on the whole state that every rank gathers first (the files are
  those of one process, and either loads into the other), the others
  waiting at a barrier; ``load`` and ``resume_latest`` read the whole
  state on every rank and keep the rank's shards; a SIGTERM seen by any
  rank stops every rank at the same step (the stop flag is all-reduced
  each step). A step that raises under sharding cannot gather (the others
  may not have failed), so each rank writes its own shards and their
  layout without a collective (``model-<step>.shards/``); ``load`` and
  ``resume_latest`` reassemble them into the whole state.

Checkpoints: ``save`` writes the port's own format; ``save_flax`` the JAX
package's trainer state (``params``, optax's ``opt_state``,
``ema_params``), which JAX's ``Trainer.load`` resumes; ``load`` takes
either, and a reference checkpoint converted by ``utils.convert``.

Every configuration ``DiffVits`` builds trains here unchanged: the
duration predictor and the spec flow are the model's business. The
flash-attention route (K8) of the UNets' and prompt encoders' attention is
on by default on the card, for every configuration: model3's route-on step
median lies inside the route-off runs' interquartile range over runs in
turns (``tools/torch_flash_route_ab.py``), at 44% less peak memory. It is
off on the CPU, as JAX defaults it;
``nn.unet1d.set_use_flash(trainer.model, flag)`` sets it either way.

Every random draw of a step (dropout, posterior and MAS noise, t,
diffusion noise) comes from the trainer's ``torch.Generator`` on its
device, seeded with ``train.seed``; the coin flip from a Python
``random.Random(seed + 17)``, drawn on the calling thread when the step
takes its micro-batch, so the flips come in the same order with the
prefetch on or off.

The loop (trainer.py:246-646 of the JAX package):

* batches from ``batches`` (any iterable of
  :class:`~diff_vits_tpu_torch.data.batch.Batch`), else from
  ``TextMelDataset(cfg)`` (or ``dataset``) through ``NativeTrainLoader``
  when ``train.use_native_loader`` and it builds and finds ``.mel.npy``
  sidecars, else ``TrainLoader`` (``loader_kind`` says which);
* a prefetch thread that assembles the next batches and copies them to
  the device while the step runs (on the card: pinned host tensors,
  ``non_blocking`` copies on a side stream the step's stream waits on);
* scalars to tensorboardX (when it imports) every ``log_every`` steps;
* SIGTERM / SIGINT: a checkpoint at the next step boundary, then return;
* a step that raises leaves a checkpoint and the error goes on;
* every ``save_and_sample_every`` steps a checkpoint and ``eval_sample``
  (30-step UniPC on the raw parameters, mel L1 and correlation against
  the ground truth, the fixed-t loss, ``sample-N.mel.npy`` and, with
  ``train.vocoder_ckpt``, ``sample-N.wav``), when there is a dataset;
  a failing eval is printed and training goes on.
"""
from __future__ import annotations

import dataclasses
import math
import os
import queue
import random
import signal
import subprocess
import threading
import time
from datetime import datetime
from typing import (Dict, Iterable, Iterator, List, Mapping, Optional,
                    Sequence, Union)

import numpy as np
import torch

from diff_vits_tpu_torch.core import trace
from diff_vits_tpu_torch.core.config import Config
from diff_vits_tpu_torch.core.device import DeviceLike, resolve_device
from diff_vits_tpu_torch.data.batch import Batch
from diff_vits_tpu_torch.data.dataset import TextMelDataset, TrainLoader
from diff_vits_tpu_torch.models.diff_vits import (
    DiffVits, eval_mode, synthesize)
from diff_vits_tpu_torch.nn.remat import check_policy, set_remat
from diff_vits_tpu_torch.nn.unet1d import set_use_flash
from diff_vits_tpu_torch.parallel import activations
from diff_vits_tpu_torch.parallel import mesh as mesh_lib
from diff_vits_tpu_torch.parallel import sharding
from diff_vits_tpu_torch.text.symbols import symbols
from diff_vits_tpu_torch.train import checkpoint as ckpt_lib
from diff_vits_tpu_torch.utils.convert import (
    convert_tree, from_flax_params, to_flax_params)
from diff_vits_tpu_torch.utils.init import init_random

WEIGHT_DECAY = 1e-4     # optax.adamw's default, which the JAX trainer keeps


def make_optimizer(cfg: Config, params) -> torch.optim.AdamW:
    """AdamW as the JAX trainer's ``optax.adamw(lr, b1, b2, eps)`` with its
    default weight decay 1e-4 (diff_vits_tpu/train/trainer.py:41-43).

    The two give the same update up to rounding, so optax's state maps onto
    this one (``Trainer.load`` / ``save_flax``): ``optax.adamw`` is
    ``chain(scale_by_adam, add_decayed_weights, scale_by_learning_rate)``,
    ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``, update
    ``-lr (mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps) + wd p)`` with
    t = ``count`` after its increment; ``torch.optim.AdamW``
    (``_single_tensor_adamw``) keeps ``exp_avg`` = mu and ``exp_avg_sq`` =
    nu by the same recurrences, takes t = its ``step`` after the
    increment, puts eps outside the square root
    (``sqrt(exp_avg_sq) / sqrt(1 - b2^t) + eps``) and applies the
    decoupled decay ``p *= 1 - lr wd`` from the same parameter before the
    Adam step."""
    return torch.optim.AdamW(params, lr=cfg.train.train_lr,
                             betas=tuple(cfg.train.adam_betas),
                             eps=cfg.train.eps, weight_decay=WEIGHT_DECAY)


def clip_by_global_norm_scheduled(grads: Sequence[torch.Tensor], step: int,
                                  cfg: Config,
                                  g_norm: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Scale ``grads`` in place by min(1, max_norm / (norm + 1e-6)),
    max_norm ``clip_before`` before ``clip_switch_step`` and
    ``clip_after`` from it on. Returns the pre-clip global norm (a device
    scalar: no host sync); ``g_norm`` is that norm when the caller has it
    (shards of a sharded state)."""
    max_norm = (cfg.train.clip_before if step < cfg.train.clip_switch_step
                else cfg.train.clip_after)
    if g_norm is None:
        g_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.clamp(max_norm / (g_norm + 1e-6),
                                           max=1.0))
    return g_norm


def clip_grad_value(grads, clip_value: Optional[float],
                    norm_type: float = 2.0):
    """Element-wise value clip (trainer.py:55): (``grads`` with every
    entry clamped to [-clip_value, clip_value], or unchanged for None; the
    pre-clip p-norm over every leaf, float32). ``grads`` is a mapping or a
    sequence of tensors; the result has its structure, new tensors."""
    leaves = list(grads.values()) if isinstance(grads, Mapping) \
        else list(grads)
    total = sum(torch.sum(g.abs().float() ** norm_type)
                for g in leaves) ** (1.0 / norm_type)

    def clip(g):
        return g if clip_value is None else g.clamp(-clip_value, clip_value)
    if isinstance(grads, Mapping):
        return {k: clip(g) for k, g in grads.items()}, total
    return [clip(g) for g in leaves], total


_MELS = ("spec", "refer1", "refer2")
_END = object()         # the prefetch worker's end-of-batches mark


def batch_to_device(batch: Batch, device: torch.device, *,
                    pinned: bool = False) -> Dict[str, torch.Tensor]:
    """Every field of ``batch`` on ``device``: ids and lengths int64, mels
    float32. ``pinned``: through page-locked host memory with non-blocking
    copies on the current stream (the caller orders their use)."""
    out = {}
    for f in dataclasses.fields(Batch):
        a = np.asarray(getattr(batch, f.name),
                       np.float32 if f.name in _MELS else np.int64)
        t = torch.from_numpy(a)
        out[f.name] = (t.pin_memory().to(device, non_blocking=True)
                       if pinned else t.to(device))
    return out


def forward_inputs(fields: Dict[str, torch.Tensor], use_refer1: bool
                   ) -> Dict[str, torch.Tensor]:
    """DiffVits.forward's inputs from a batch's fields, with refer1 or
    refer2 as the prompt."""
    r = "refer1" if use_refer1 else "refer2"
    return dict(text=fields["text"], text_lengths=fields["text_lengths"],
                spec=fields["spec"], spec_lengths=fields["spec_lengths"],
                refer=fields[r], refer_lengths=fields[f"{r}_lengths"],
                tone=fields["tone"], language=fields["language"])


def device_batch(batch: Batch, use_refer1: bool, device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """DiffVits.forward's inputs from ``batch``, with refer1 or refer2 as
    the prompt."""
    return forward_inputs(batch_to_device(batch, device), use_refer1)


def summary_writer(logdir: str):
    """A tensorboardX ``SummaryWriter`` on ``logdir``; None when
    tensorboardX is not installed."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(logdir)


def make_loader(ds: TextMelDataset, cfg: Config, **kw):
    """``NativeTrainLoader(ds, cfg, **kw)`` when ``train.use_native_loader``,
    it builds and ``ds`` has ``.mel.npy`` sidecars, else ``TrainLoader``.
    Returns (loader, "native" or "python", why not native)."""
    reason = "train.use_native_loader is off"
    if cfg.train.use_native_loader:
        from diff_vits_tpu_torch.data.native_loader import NativeTrainLoader
        try:
            loader = NativeTrainLoader(ds, cfg, **kw)
            if len(loader) > 0:
                return loader, "native", None
            reason = "no .npy mel sidecars in the dataset"
        except (OSError, subprocess.CalledProcessError) as e:
            reason = f"{type(e).__name__}: {e}"
    return TrainLoader(ds, cfg, **kw), "python", reason


def rank_seed(seed: int, rank: int) -> int:
    """The seed of data rank ``rank``'s generator: ``seed`` itself on data
    rank 0."""
    return seed + 1_000_003 * rank


class Trainer:
    """``Trainer(cfg, batches)`` builds the model from ``train.seed`` on
    ``device`` (the card unless given) in training mode and trains on
    ``batches``; with ``batches=None`` on ``dataset`` (default
    ``TextMelDataset(cfg)``) through its loader. ``train_step`` runs one
    optimizer step, ``train`` the loop; checkpoints, samples and
    tensorboard events go to ``workdir`` (default a new timestamped folder
    under ``train.logs_folder``). ``min_size``: the fewest elements of a
    leaf that the sharding rules split (JAX's default); ``fsdp_axis``:
    the axis ZeRO-3 scatters over (``seq`` to pair it with sequence
    parallelism, as JAX's multi-chip dry run does);
    ``sequence_parallel``: each step shards the diffusion UNet's frames
    over the ``seq`` ranks (``parallel.activations``; JAX's ``Trainer``
    never enters that scope, its callers do); a ``seq`` axis without it
    holds replicas."""

    def __init__(self, cfg: Config, batches: Optional[Iterable[Batch]] = None,
                 *, dataset: Optional[TextMelDataset] = None,
                 device: DeviceLike = None, workdir: Optional[str] = None,
                 min_size: int = 1 << 16, fsdp_axis: str = "fsdp",
                 sequence_parallel: bool = False):
        self.cfg = cfg
        check_policy(cfg.train.remat_policy)
        if "stage" in cfg.train.mesh_axes:
            raise ValueError("Trainer takes no 'stage' axis (JAX's neither): "
                             "the pipeline is parallel.pipeline's")
        self.mesh = mesh_lib.make_mesh(cfg.train.mesh_shape,
                                       cfg.train.mesh_axes)
        self.rank, self.world = mesh_lib.rank(), mesh_lib.world_size()
        # under a process group (torchrun, even of one rank) the step takes
        # the parallel path and its collectives
        self.dp = mesh_lib.distributed()
        self.layout = sharding.Layout(self.mesh, self.rank)
        self.data_rank = self.layout.data_index
        self.data_ranks = self.layout.data_size
        if cfg.train.train_batch_size % self.data_ranks:
            raise ValueError(
                f"train.train_batch_size={cfg.train.train_batch_size} must "
                f"be divisible by the {self.data_ranks} data-parallel ranks "
                f"(the 'data' x 'fsdp' axes of the mesh {self.mesh}): the "
                "global batch shards over them")
        self.device = resolve_device(device)
        self.model = DiffVits(cfg, len(symbols), device=self.device)
        init_random(self.model, torch.Generator().manual_seed(cfg.train.seed))
        self.model.train()
        set_use_flash(self.model, self.device.type == "cuda")
        set_remat(self.model, cfg.train.remat_policy)
        # the step shards the diffusion UNet's frames over seq when asked
        self.seq_parallel = (sequence_parallel
                             and self.layout.group("seq").size > 1)
        self.plan = sharding.shard_model(self.model, self.layout, min_size,
                                         fsdp_axis, self.seq_parallel)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.params = list(self.model.parameters())
        self.optimizer = make_optimizer(cfg, self.params)
        # a copy, never the parameters' own storage
        self.ema = ([p.detach().float().clone() for p in self.params]
                    if cfg.train.use_ema else None)
        self.step = 0
        self.accum = max(1, cfg.train.gradient_accumulate_every)
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(cfg.train.seed, self.data_rank))
        self._py_rng = random.Random(cfg.train.seed + 17)
        self.bf16 = (self.device.type == "cuda"
                     and cfg.train.compute_dtype == "bfloat16")
        now = datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
        self.logs_folder = workdir or os.path.join(cfg.train.logs_folder, now)
        self.ds = dataset
        if batches is None:
            self.ds = dataset if dataset is not None else TextMelDataset(cfg)
            batches = self._make_loader()
        else:
            self.loader_kind = "given"
        self.batches = batches
        self.last_eval_metrics: Dict[str, float] = {}
        self._eval_cache: Optional[Batch] = None
        self._vocoder = None

    def _make_loader(self):
        """The training loader (:func:`make_loader`); prints the choice and
        records it in ``loader_kind``."""
        loader, self.loader_kind, reason = make_loader(
            self.ds, self.cfg, seed=self.cfg.train.seed,
            batch_size=self.cfg.train.train_batch_size // self.data_ranks,
            host_id=self.data_rank, num_hosts=self.data_ranks)
        if self.loader_kind == "native":
            print("loader: native C++ (csrc/loader.cc)", flush=True)
        elif self.cfg.train.use_native_loader:
            # a run records which input pipeline fed it
            print(f"loader: python fallback ({reason})", flush=True)
        return loader

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.bf16)

    # -- one step ----------------------------------------------------------

    def train_step(self, batch: Union[Batch, Sequence[Batch]]
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (``accum`` micro-batches when
        gradient accumulation is on). Returns the metrics as device
        scalars, the loss terms averaged over the micro-batches and the
        pre-clip gradient norm as ``loss/grad``. One ``dvt.train.step``
        span of the port's tracer (``core.trace``)."""
        micro = [batch] if isinstance(batch, Batch) else list(batch)
        if len(micro) != self.accum:
            raise ValueError(f"train_step takes {self.accum} micro-batches, "
                             f"got {len(micro)}")
        with trace.span("dvt.train.step", step=self.step + 1):
            return self.step_on([batch_to_device(mb, self.device)
                                 for mb in micro])

    def step_on(self, micro: Sequence[Dict[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
        """:meth:`train_step` on micro-batches already on the device (the
        fields of :func:`batch_to_device`); the coin flip between refer1
        and refer2 is drawn here, once per micro-batch. Spans of the port's
        tracer: ``dvt.train.forward`` and ``dvt.train.backward`` a
        micro-batch, ``dvt.train.metrics`` (the sum of its metrics) and
        ``dvt.train.optimizer`` (the ranks' gradient reduction, the clip,
        AdamW and the EMA)."""
        mas_noise_scale = max(self.cfg.train.mas_noise_scale_initial
                              - self.cfg.train.noise_scale_delta * self.step,
                              0.0)
        inputs = [forward_inputs(mb, self._py_rng.random() < 0.5)
                  for mb in micro]
        rank_mean = self._mean_over_ranks if self.dp else None
        self.optimizer.zero_grad(set_to_none=True)
        params = dict(zip(self.names, self.params))
        working = self.plan.working(params) if self.plan.active else {}
        sums: Dict[str, torch.Tensor] = {}
        scope = self.layout if self.seq_parallel else None
        for mb in inputs:
            with self.plan.bind(self.model, working), \
                    activations.sequence_parallel(scope):
                with trace.span("dvt.train.forward"), self._autocast():
                    loss, (metrics, _, _) = self.model(
                        **mb, generator=self.generator,
                        mas_noise_scale=mas_noise_scale,
                        rank_mean=rank_mean)
                with trace.span("dvt.train.backward"):
                    (loss / len(inputs)).backward()
            with trace.span("dvt.train.metrics"):
                for k, v in metrics.items():
                    sums[k] = sums.get(k, 0.0) + v.detach().float()
        metrics = {k: v / len(inputs) for k, v in sums.items()}
        with trace.span("dvt.train.optimizer"):
            if self.dp:
                self.plan.reduce_grads(params, working)
            del working
            grads = [p.grad for p in self.params if p.grad is not None]
            metrics["loss/grad"] = clip_by_global_norm_scheduled(
                grads, self.step, self.cfg,
                self.plan.grad_norm(params) if self.plan.active else None)
            self.optimizer.step()
            if self.ema is not None:
                d = self.cfg.train.ema_decay
                with torch.no_grad():
                    torch._foreach_mul_(self.ema, d)
                    torch._foreach_add_(self.ema, self.params, alpha=1.0 - d)
        self.step += 1
        return metrics

    # -- parallelism -------------------------------------------------------

    def _mean_over_ranks(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s mean over the data ranks (the ranks sharing rows hold the
        same ``t``)."""
        return self.layout.group("dp").all_reduce(t) / self.data_ranks

    def held_state_bytes(self) -> int:
        """The bytes of this rank's parameters, AdamW moments and EMA."""
        moments = [v for st in self.optimizer.state.values()
                   for k, v in st.items() if k in ("exp_avg", "exp_avg_sq")]
        return sum(t.numel() * t.element_size()
                   for t in self.params + moments + (self.ema or []))

    def whole_state(self) -> Dict[str, object]:
        """The whole training state, gathered from the ranks' shards (every
        rank must call it): ``model`` (the state dict), ``optimizer`` (its
        state dict) and ``ema`` (a list, or None), each as one process
        holds it."""
        sd = self.model.state_dict()
        opt = self.optimizer.state_dict()
        if not self.plan.active:
            return dict(model=sd, optimizer=opt, ema=self.ema)
        sd.update(self._gather_list(self.params))
        state = opt["state"]
        for key in ("exp_avg", "exp_avg_sq"):
            got = self._gather_list([state.get(i, {}).get(key)
                                     for i in range(len(self.names))])
            for i, n in enumerate(self.names):
                if n in got:
                    state[i] = dict(state[i], **{key: got[n]})
        return dict(model=sd, optimizer=opt, ema=self.whole_ema())

    def whole_ema(self) -> Optional[List[torch.Tensor]]:
        """The EMA as one process holds it (every rank must call it)."""
        if self.ema is None or not self.plan.active:
            return self.ema
        got = self._gather_list(self.ema)
        return [got.get(n, e) for n, e in zip(self.names, self.ema)]

    def _gather_list(self, values: Sequence[Optional[torch.Tensor]]
                     ) -> Dict[str, torch.Tensor]:
        """The whole tensors of the split parameters' ``values`` (one a
        parameter, in order; None where there is none), by name."""
        return self.plan.gather({n: v for n, v in zip(self.names, values)
                                 if n in self.plan.leaves and v is not None})

    def _shard_state(self, sd: Dict[str, torch.Tensor],
                     opt: Optional[Dict] = None,
                     ema: Optional[Sequence[torch.Tensor]] = None):
        """The rank's shards of a whole state (``sd`` a model state dict,
        ``opt`` an optimizer state dict, ``ema`` a list): the inverse of
        :meth:`whole_state`."""
        sd = {k: self.plan.shard(k, v) for k, v in sd.items()}
        if opt is not None:
            opt = dict(opt, state={
                i: {k: (self.plan.shard(self.names[i], v)
                        if k in ("exp_avg", "exp_avg_sq") else v)
                    for k, v in st.items()}
                for i, st in opt["state"].items()})
        if ema is not None:
            ema = [self.plan.shard(n, e) for n, e in zip(self.names, ema)]
        return sd, opt, ema

    def global_metrics(self, metrics: Dict[str, torch.Tensor]
                        ) -> Dict[str, float]:
        """``metrics`` averaged over the ranks, as floats (a host sync): a
        ``dvt.train.metrics`` span of the port's tracer."""
        with trace.span("dvt.train.metrics"):
            names = sorted(metrics)
            vals = torch.stack([metrics[k].float() for k in names])
            vals = self._mean_over_ranks(vals) if self.dp else vals
            return dict(zip(names, vals.tolist()))

    def _any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` is true on any rank (every rank must ask)."""
        if not self.dp:
            return flag
        t = torch.tensor([float(flag)], device=self.device)
        return bool(mesh_lib.all_reduce_sum(t).item() > 0)

    # -- input pipeline ----------------------------------------------------

    def device_batches(self, it: Iterator[Batch], prefetch: bool = True
                       ) -> Iterator[List[Dict[str, torch.Tensor]]]:
        """Each step's ``accum`` micro-batches of ``it`` on the device, made
        on a worker thread ahead of the step when ``prefetch``. Ends when
        ``it`` runs out; close it to stop the worker."""
        if prefetch:
            return self._prefetch(it)
        return self._sync_batches(it)

    def _sync_batches(self, it):
        while True:
            try:
                micro = [next(it) for _ in range(self.accum)]
            except StopIteration:
                return
            yield [batch_to_device(mb, self.device) for mb in micro]

    def _prefetch(self, it, depth: int = 2):
        """Up to ``depth`` steps' device batches made ahead by a worker
        thread; its errors are raised here. On the card the worker copies
        from pinned memory on a side stream and records an event, which
        the consuming stream waits on; each tensor is recorded on that
        stream, so the allocator keeps its memory until the step is done.
        Closing the generator stops the worker (it never stays blocked on a
        full queue) and joins it."""
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return
                except queue.Full:
                    pass

        def worker():
            try:
                while not stop.is_set():
                    try:
                        micro = [next(it) for _ in range(self.accum)]
                    except StopIteration:
                        put(_END)
                        return
                    if not cuda:
                        put(([batch_to_device(mb, self.device)
                              for mb in micro], None))
                        continue
                    with torch.cuda.stream(stream):
                        dev = [batch_to_device(mb, self.device, pinned=True)
                               for mb in micro]
                    ready = torch.cuda.Event()
                    ready.record(stream)
                    put((dev, ready))
            except BaseException as e:  # raised again on the consumer
                put(e)

        t = threading.Thread(target=worker, name="trainer-prefetch",
                             daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                dev, ready = item
                if ready is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(ready)
                    for fields in dev:
                        for v in fields.values():
                            v.record_stream(consumer)
                yield dev
        finally:
            stop.set()
            t.join()
            while not q.empty():
                q.get_nowait()

    # -- loop --------------------------------------------------------------

    def train(self, num_steps: Optional[int] = None, log_every: int = 100,
              prefetch: bool = True) -> Dict[str, float]:
        """Step until ``num_steps`` (default ``train.train_num_steps``), the
        batches run out or SIGTERM / SIGINT arrives; log every
        ``log_every`` steps (stdout and tensorboard), where a non-finite
        loss checkpoints and raises; every ``save_and_sample_every`` steps
        checkpoint and run :meth:`eval_sample`; checkpoint at the end.
        ``prefetch`` makes the next batches on a worker thread. Returns the
        last logged metrics."""
        num_steps = num_steps or self.cfg.train.train_num_steps
        log_every = max(1, min(log_every, num_steps))
        every = self.cfg.train.save_and_sample_every
        lead = self.rank == 0
        writer = summary_writer(self.logs_folder) if lead else None
        batches = self.device_batches(iter(self.batches), prefetch)
        preempted: List[int] = []

        def on_signal(signum, frame):
            preempted.append(signum)
            print(f"signal {signum}: checkpointing at the next step "
                  "boundary", flush=True)

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, on_signal)
            except ValueError:  # not the main thread
                pass
        logged: Dict[str, float] = {}
        stopped = False
        t0 = time.time()
        try:
            while self.step < num_steps:
                # every rank stops at the same step: a signal on one rank
                # is every rank's (the collectives of a step need them all)
                stopped = self._any_rank(bool(preempted))
                if stopped:
                    break
                try:
                    micro = next(batches)
                except StopIteration:
                    break
                with trace.span("dvt.train.step", step=self.step + 1):
                    try:
                        metrics = self.step_on(micro)
                    except Exception:
                        # a checkpoint of what is left, never hiding the
                        # error; no barrier: the other ranks may not have
                        # failed
                        try:
                            self.save(self.step, sync=False)
                        except Exception as save_err:
                            print(f"crash checkpoint failed: {save_err}",
                                  flush=True)
                        raise
                    if self.step % log_every == 0:
                        logged = self.global_metrics(metrics)
                if self.step % log_every == 0:
                    if not math.isfinite(logged["loss/all"]):
                        self.save(self.step)
                        raise FloatingPointError(
                            f"non-finite loss at step {self.step}: {logged}")
                    sps = log_every / (time.time() - t0)
                    t0 = time.time()
                    line = " ".join(f"{k}={v:.4f}"
                                    for k, v in sorted(logged.items()))
                    if lead:
                        print(f"step {self.step} {line} steps/s={sps:.2f}",
                              flush=True)
                    if writer is not None:
                        for k, v in logged.items():
                            writer.add_scalar(k, v, self.step)
                        writer.add_scalar("perf/steps_per_sec", sps,
                                          self.step)
                if self.step % every == 0:
                    self.save(self.step)
                    # under sharding every rank gathers the parameters
                    if self.ds is not None and (lead or self.plan.active):
                        try:
                            self.eval_sample(self.step, writer)
                        except Exception as e:  # eval never stops training
                            print(f"eval_sample failed: "
                                  f"{type(e).__name__}: {e}", flush=True)
                    mesh_lib.barrier()
        finally:
            batches.close()
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
            if writer is not None:
                writer.close()
        if self.step % every != 0:
            self.save(self.step)
        if lead and (stopped or preempted):
            print(f"preempted: checkpointed at step {self.step}; rerun to "
                  "auto-resume", flush=True)
        elif lead:
            print("training complete", flush=True)
        return logged

    # -- evaluation --------------------------------------------------------

    def _eval_batch(self) -> Batch:
        """One utterance of ``data.val_files`` (of the training set when
        that is the same folder or empty): batch 1, seed ``train.seed + 1``,
        made once."""
        if self._eval_cache is None:
            ds = self.ds
            if self.cfg.data.val_files != self.cfg.data.training_files:
                val = TextMelDataset(self.cfg, root=self.cfg.data.val_files)
                if len(val) > 0:
                    ds = val
            loader, _, _ = make_loader(ds, self.cfg, batch_size=1,
                                       seed=self.cfg.train.seed + 1)
            self._eval_cache = next(iter(loader))
        return self._eval_cache

    @torch.no_grad()
    def eval_fixed_t_loss(self, batch: Batch,
                          t_fracs=(0.1, 0.3, 0.5, 0.7, 0.9),
                          ema: Optional[Sequence[torch.Tensor]] = None
                          ) -> Dict[str, float]:
        """Diffusion loss at fixed steps with fixed noise (trainer.py:523):
        eval mode (no dropout; the kernel routes), refer1, zero posterior
        and MAS noise, noise from ``train.seed + 2``, in float32. The raw
        parameters per step fraction and their mean; the EMA's (``ema``,
        default the trainer's own) mean when there is one. Under sharding
        it runs inside :meth:`eval_sample`, on the whole state."""
        inputs = device_batch(batch, True, self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            self.cfg.train.seed + 2)
        noise = torch.randn(inputs["spec"].shape, generator=gen,
                            device=self.device)
        b, total = inputs["spec"].shape[0], self.cfg.train.timesteps

        def loss_at(f, params=None):
            t = torch.full((b,), int(f * total), dtype=torch.int64,
                           device=self.device)
            kw = dict(inputs, t=t, noise=noise)
            if params is None:
                _, (metrics, _, _) = self.model(**kw)
            else:
                _, (metrics, _, _) = torch.func.functional_call(
                    self.model, params, (), kw)
            return float(metrics["loss/diff"])

        with eval_mode(self.model):
            out = {f"eval/diff_t{f:g}": loss_at(f) for f in t_fracs}
            out["eval/diff_fixed_t"] = float(np.mean(list(out.values())))
            ema = self.ema if ema is None else ema
            if ema is not None:
                ema = dict(zip(self.names, ema))
                out["eval/ema_diff_fixed_t"] = float(np.mean(
                    [loss_at(f, ema) for f in t_fracs]))
        return out

    def eval_sample(self, step: int, writer=None, sampling_steps: int = 30
                    ) -> Dict[str, float]:
        """Synthesize the eval utterance (:meth:`_eval_batch`, always its
        refer1) with ``sampling_steps``-step UniPC on the raw parameters,
        in eval mode, up to ``data.max_mel_len`` frames; add the mel's L1
        and correlation against the ground truth over their common frames
        to :meth:`eval_fixed_t_loss`; write ``sample-<milestone>.mel.npy``
        and, with ``train.vocoder_ckpt``, ``sample-<milestone>.wav``; log
        the metrics, both mels' images and the audio to ``writer``.
        Returns the metrics, also kept in ``last_eval_metrics``. Under
        sharding every rank calls it and gathers the whole state; rank 0
        samples and the others return {}."""
        ema = self.whole_ema()
        with sharding.whole(self.model, self.plan):
            if self.rank != 0 and self.plan.active:
                return {}
            return self._eval_sample(step, writer, sampling_steps, ema)

    def _eval_sample(self, step, writer, sampling_steps, ema):
        from diff_vits_tpu_torch.data.audio import write_wav
        batch = self._eval_batch()
        fields = forward_inputs(batch_to_device(batch, self.device), True)
        gen = torch.Generator().manual_seed(
            self.cfg.train.seed * 1_000_003 + step)
        mel, lengths = synthesize(
            self.model, fields["text"], fields["text_lengths"],
            fields["refer"], fields["refer_lengths"], fields["tone"],
            fields["language"], generator=gen, sampling_steps=sampling_steps,
            max_len=self.cfg.data.max_mel_len, device=self.device)
        eval_metrics = self.eval_fixed_t_loss(batch, ema=ema)
        mel_np = mel[0, :int(lengths[0])].float().cpu().numpy()
        gt_np = np.asarray(batch.spec[0][:int(batch.spec_lengths[0])],
                           np.float32)
        n = min(len(mel_np), len(gt_np))
        if n > 0:
            eval_metrics["eval/mel_l1"] = float(
                np.mean(np.abs(mel_np[:n] - gt_np[:n])))
            denom = mel_np[:n].std() * gt_np[:n].std()
            eval_metrics["eval/mel_corr"] = float(
                np.corrcoef(mel_np[:n].ravel(), gt_np[:n].ravel())[0, 1]
            ) if denom > 0 else 0.0
        self.last_eval_metrics = eval_metrics
        print("eval step {} {}".format(step, " ".join(
            f"{k.split('/', 1)[1]}={v:.4f}"
            for k, v in sorted(eval_metrics.items()))), flush=True)
        milestone = step // self.cfg.train.save_and_sample_every
        os.makedirs(self.logs_folder, exist_ok=True)
        np.save(os.path.join(self.logs_folder,
                             f"sample-{milestone}.mel.npy"), mel_np)
        wav = None
        if self.cfg.train.vocoder_ckpt:
            if self._vocoder is None:
                from diff_vits_tpu_torch.models.vocoder import load_vocoder
                self._vocoder = load_vocoder(
                    self.cfg, self.cfg.train.vocoder_ckpt, device=self.device)
            with torch.inference_mode():
                wav = self._vocoder(torch.from_numpy(mel_np[None]).to(
                    self.device))[0].float().cpu().numpy()
            write_wav(os.path.join(self.logs_folder,
                                   f"sample-{milestone}.wav"),
                      wav, self.cfg.data.sampling_rate)
        if writer is not None:
            from diff_vits_tpu_torch.utils.logging import (
                plot_spectrogram_to_numpy)
            for k, v in eval_metrics.items():
                writer.add_scalar(k, v, step)
            writer.add_image("gen/mel", plot_spectrogram_to_numpy(mel_np.T),
                             step, dataformats="HWC")
            writer.add_image("gt/mel", plot_spectrogram_to_numpy(gt_np.T),
                             step, dataformats="HWC")
            if wav is not None:
                try:
                    writer.add_audio("gen/audio", wav[None, :], step,
                                     sample_rate=self.cfg.data.sampling_rate)
                except ImportError as e:  # tensorboardX encodes with soundfile
                    print(f"tensorboard audio skipped: {e}", flush=True)
        return eval_metrics

    # -- checkpoints -------------------------------------------------------

    def save(self, step: int, sync: bool = True) -> Optional[str]:
        """Write the checkpoint of ``step`` on rank 0 (its path; None on the
        other ranks), every rank then waiting at a barrier unless not
        ``sync``. Under data parallelism with ``sync`` the file also holds
        every rank's generator state (``generators``, gathered here). A
        sharded state is gathered first (:meth:`whole_state`), so the file
        is one process's. Without ``sync`` (a step raised: no collective)
        a sharded state is written by every rank alone, its own shards and
        their layout (``checkpoint.save_shard_checkpoint``; the path of
        this rank's file), which :meth:`load` reassembles."""
        if not sync and self.plan.active:
            state = {"model": self.model.state_dict(),
                     "optimizer": self.optimizer.state_dict(),
                     "ema": self.ema,
                     "generator": self.generator.get_state(),
                     "py_rng": self._py_rng.getstate()}
            return ckpt_lib.save_shard_checkpoint(
                self.logs_folder, step, self.rank, self.world, state,
                self._shard_layout())
        gens = None
        if sync and self.dp:
            gens = mesh_lib.all_gather_rows(
                self.generator.get_state()[None].to(self.device)).cpu()
        whole = self.whole_state()
        path = None
        if self.rank == 0:
            state = {"model": whole["model"],
                     "optimizer": whole["optimizer"],
                     "generator": self.generator.get_state(),
                     "py_rng": self._py_rng.getstate()}
            if whole["ema"] is not None:
                state["ema"] = whole["ema"]
            if gens is not None:
                state["generators"] = gens
            path = ckpt_lib.save_checkpoint(self.logs_folder, step, state,
                                            keep=self.cfg.train.keep_ckpts)
        if sync:
            mesh_lib.barrier()
        return path

    def _shard_layout(self) -> Dict[str, object]:
        """Where this rank's shards lie: the mesh, its coordinates, the
        parameters in order and each split one's whole shape, split dims
        and parts."""
        return dict(mesh=dict(self.mesh), coords=dict(self.layout.coords),
                    names=list(self.names),
                    leaves={n: dict(shape=leaf.shape, dims=dict(leaf.dims),
                                    parts=leaf.parts)
                            for n, leaf in self.plan.leaves.items()})

    def save_flax(self, step: int) -> Optional[str]:
        """Write the trainer state as the JAX package's ``Trainer.save``
        does (diff_vits_tpu/train/trainer.py:289-300): ``{"params",
        "opt_state", "ema_params"}`` with the flax names, optax.adamw's
        state as ``{"0": {"count", "mu", "nu"}, "1": {}, "2": {}}``
        (:func:`make_optimizer` says why the moments carry over): ``mu`` /
        ``nu`` the AdamW ``exp_avg`` / ``exp_avg_sq`` (zero for a parameter
        that has had no step), ``count`` the AdamW step as int32. Not the
        random streams, which a JAX state does not hold. Rank 0 writes
        (None on the others) the whole state every rank gathers first,
        every rank then waiting at a barrier."""
        whole = self.whole_state()
        if self.rank != 0:
            mesh_lib.barrier()
            return None
        names = self.names
        params = {n: whole["model"][n] for n in names}
        mu, nu, count = {}, {}, 0
        for i, n in enumerate(names):
            st = whole["optimizer"]["state"].get(i, {})
            mu[n] = st.get("exp_avg", torch.zeros_like(params[n]))
            nu[n] = st.get("exp_avg_sq", torch.zeros_like(params[n]))
            count = max(count, int(st.get("step", 0)))
        state = {"params": to_flax_params(self.model, params),
                 "opt_state": {
                     "0": {"count": np.asarray(count, np.int32),
                           "mu": to_flax_params(self.model, mu),
                           "nu": to_flax_params(self.model, nu)},
                     "1": {}, "2": {}}}
        if whole["ema"] is not None:
            state["ema_params"] = to_flax_params(
                self.model, dict(zip(names, whole["ema"])))
        path = ckpt_lib.save_flax_checkpoint(
            self.logs_folder, step, state, keep=self.cfg.train.keep_ckpts)
        mesh_lib.barrier()
        return path

    def _load_flax_state(self, path: str, state) -> None:
        """A JAX trainer state (diff_vits_tpu/train/trainer.py:302-328):
        ``params`` through ``from_flax_params``; optax.adamw's ``mu`` /
        ``nu`` / ``count`` as AdamW's ``exp_avg`` / ``exp_avg_sq`` / step
        (a state without ``opt_state`` restarts the optimizer, as JAX
        does); ``ema_params`` as the EMA, else a copy of the params. Each
        rank keeps its shards."""
        names = self.names
        sd = from_flax_params(state["params"], self.cfg)
        want = set(self.model.state_dict())
        missing, unexpected = want - set(sd), set(sd) - want
        if missing or unexpected:
            raise ValueError(
                f"{path}: the JAX trainer state's params do not fit this "
                f"configuration (missing {sorted(missing)[:5]}, unexpected "
                f"{sorted(unexpected)[:5]})")
        self.model.load_state_dict(self._shard_state(sd)[0], strict=True)
        self.optimizer = make_optimizer(self.cfg, self.params)
        if "opt_state" in state:
            adam = state["opt_state"]["0"]
            mu, nu = convert_tree(adam["mu"]), convert_tree(adam["nu"])
            step = torch.tensor(float(np.asarray(adam["count"])))
            opt = self.optimizer.state_dict()
            opt["state"] = {i: {"step": step.clone(),
                                "exp_avg": self.plan.shard(n, mu[n]),
                                "exp_avg_sq": self.plan.shard(n, nu[n])}
                            for i, n in enumerate(names)}
            self.optimizer.load_state_dict(opt)
        if self.ema is not None:
            src = self.params
            if "ema_params" in state:
                whole = convert_tree(state["ema_params"])
                src = [self.plan.shard(n, whole[n]) for n in names]
            self.ema = [v.detach().to(self.device, torch.float32).clone()
                        for v in src]
        print(f"{path} is a JAX trainer state: it holds no torch random "
              "streams, so the trainer's generator and coin flips go on as "
              "they are", flush=True)

    def load(self, path: str) -> None:
        """Restore a checkpoint of :meth:`save`; a params-only one
        (``{"model": ...}``, as ``utils.convert`` writes from a reference
        checkpoint), where, as JAX's ``Trainer.load`` does, the optimizer
        starts afresh, the random streams go on as they are and the EMA
        starts from the params; or a trainer state of the JAX package
        (``params``, ``opt_state``, ``ema_params``: :meth:`save_flax`'s
        layout), whose random streams are not in the file either; or the
        ``.shards`` directory of a sharded run's crash checkpoint, whose
        ranks' files are reassembled into the whole state first. Every
        rank reads the whole state and keeps its shards."""
        step, state = ckpt_lib.load_checkpoint(path, map_location=self.device)
        if "model" not in state and "params" in state:
            self._load_flax_state(path, state)
        elif "model" not in state:
            raise ValueError(f"{path}: the checkpoint holds neither 'model' "
                             "(the port's) nor 'params' (the JAX package's)")
        else:
            sd, opt, ema = self._shard_state(
                state["model"], state.get("optimizer"), state.get("ema"))
            self.model.load_state_dict(sd, strict=True)
            if opt is not None:
                self.optimizer.load_state_dict(opt)
            else:
                self.optimizer = make_optimizer(self.cfg, self.params)
            gens = state.get("generators")
            if gens is not None and len(gens) == self.world:
                # a fresh host copy: the file may map to the card, and
                # set_state of a row view reads out of bounds
                self.generator.set_state(gens[self.rank].to("cpu",
                                                            copy=True))
            elif "generator" in state and self.data_rank == 0:
                self.generator.set_state(state["generator"].cpu())
            if "py_rng" in state:
                self._py_rng.setstate(state["py_rng"])
            if self.ema is not None:
                src = ema or self.params
                self.ema = [e.detach().float().clone() for e in src]
        self.step = step
        print(f"resumed from {path} at step {self.step}", flush=True)

    def resume_latest(self) -> bool:
        """Load the newest checkpoint of the workdir; False when none."""
        path = ckpt_lib.latest_checkpoint_path(self.logs_folder)
        if path is None:
            return False
        self.load(path)
        return True
