"""Training loop of the port: loss, backward, clipped AdamW, EMA,
checkpoints.

Port of ``diff_vits_tpu/train/trainer.py`` for one process on one device:

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
  "bfloat16", over float32 master weights.

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
``random.Random(seed + 17)``. The dataset, loader and command line need
the text frontend and audio and come with that slice; ``batches`` is any
iterable of :class:`~diff_vits_tpu_torch.data.batch.Batch`.
"""
from __future__ import annotations

import math
import os
import random
import time
from datetime import datetime
from typing import Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from diff_vits_tpu_torch.core.config import Config
from diff_vits_tpu_torch.core.device import DeviceLike, resolve_device
from diff_vits_tpu_torch.data.batch import Batch
from diff_vits_tpu_torch.models.diff_vits import DiffVits, eval_mode
from diff_vits_tpu_torch.nn.unet1d import set_use_flash
from diff_vits_tpu_torch.text.symbols import symbols
from diff_vits_tpu_torch.train import checkpoint as ckpt_lib
from diff_vits_tpu_torch.utils.init import init_random

WEIGHT_DECAY = 1e-4     # optax.adamw's default, which the JAX trainer keeps


def make_optimizer(cfg: Config, params) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=cfg.train.train_lr,
                             betas=tuple(cfg.train.adam_betas),
                             eps=cfg.train.eps, weight_decay=WEIGHT_DECAY)


def clip_by_global_norm_scheduled(grads: Sequence[torch.Tensor], step: int,
                                  cfg: Config) -> torch.Tensor:
    """Scale ``grads`` in place by min(1, max_norm / (norm + 1e-6)),
    max_norm ``clip_before`` before ``clip_switch_step`` and
    ``clip_after`` from it on. Returns the pre-clip global norm (a device
    scalar: no host sync)."""
    max_norm = (cfg.train.clip_before if step < cfg.train.clip_switch_step
                else cfg.train.clip_after)
    g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.clamp(max_norm / (g_norm + 1e-6),
                                           max=1.0))
    return g_norm


def device_batch(batch: Batch, use_refer1: bool, device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """DiffVits.forward's inputs from ``batch``, with refer1 or refer2 as
    the prompt."""
    refer = batch.refer1 if use_refer1 else batch.refer2
    refer_lengths = batch.refer1_lengths if use_refer1 \
        else batch.refer2_lengths

    def ids(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    def mel(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)
    return dict(text=ids(batch.text), text_lengths=ids(batch.text_lengths),
                spec=mel(batch.spec), spec_lengths=ids(batch.spec_lengths),
                refer=mel(refer), refer_lengths=ids(refer_lengths),
                tone=ids(batch.tone), language=ids(batch.language))


def _check_unported(cfg: Config) -> None:
    """Refuse the JAX trainer's options that the port does not run yet,
    rather than train without them: rematerialisation (ROADMAP Queue 1,
    item 10, ``torch.utils.checkpoint``) and a device mesh (Queue 1, item
    7). JAX raises on an unknown policy too (trainer.py:105-112)."""
    if cfg.train.remat_policy != "none":
        raise ValueError(
            f"train.remat_policy {cfg.train.remat_policy!r} is not ported "
            "(ROADMAP Queue 1, item 10); the port trains with 'none'")
    if math.prod(cfg.train.mesh_shape) != 1:
        raise ValueError(
            f"train.mesh_shape {tuple(cfg.train.mesh_shape)} spans more than "
            "one device, which the port does not train on yet (ROADMAP "
            "Queue 1, item 7)")


class Trainer:
    """``Trainer(cfg, batches)`` builds the model from ``train.seed`` on
    ``device`` (the card unless given) in training mode; ``train_step``
    runs one optimizer step, ``train`` the loop."""

    def __init__(self, cfg: Config, batches: Iterable[Batch], *,
                 device: DeviceLike = None, workdir: Optional[str] = None):
        self.cfg = cfg
        _check_unported(cfg)
        self.device = resolve_device(device)
        self.model = DiffVits(cfg, len(symbols), device=self.device)
        init_random(self.model, torch.Generator().manual_seed(cfg.train.seed))
        self.model.train()
        set_use_flash(self.model, self.device.type == "cuda")
        self.params = list(self.model.parameters())
        self.optimizer = make_optimizer(cfg, self.params)
        # a copy, never the parameters' own storage
        self.ema = ([p.detach().float().clone() for p in self.params]
                    if cfg.train.use_ema else None)
        self.step = 0
        self.accum = max(1, cfg.train.gradient_accumulate_every)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.train.seed)
        self._py_rng = random.Random(cfg.train.seed + 17)
        self.bf16 = (self.device.type == "cuda"
                     and cfg.train.compute_dtype == "bfloat16")
        self.batches = batches
        now = datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
        self.logs_folder = workdir or os.path.join(cfg.train.logs_folder, now)

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.bf16)

    # -- one step ----------------------------------------------------------

    def train_step(self, batch: Union[Batch, Sequence[Batch]]
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (``accum`` micro-batches when
        gradient accumulation is on). Returns the metrics as device
        scalars, the loss terms averaged over the micro-batches and the
        pre-clip gradient norm as ``loss/grad``."""
        micro = [batch] if isinstance(batch, Batch) else list(batch)
        if len(micro) != self.accum:
            raise ValueError(f"train_step takes {self.accum} micro-batches, "
                             f"got {len(micro)}")
        mas_noise_scale = max(self.cfg.train.mas_noise_scale_initial
                              - self.cfg.train.noise_scale_delta * self.step,
                              0.0)
        self.optimizer.zero_grad(set_to_none=True)
        sums: Dict[str, torch.Tensor] = {}
        for mb in micro:
            inputs = device_batch(mb, self._py_rng.random() < 0.5,
                                  self.device)
            with self._autocast():
                loss, (metrics, _, _) = self.model(
                    **inputs, generator=self.generator,
                    mas_noise_scale=mas_noise_scale)
            (loss / len(micro)).backward()
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v.detach().float()
        metrics = {k: v / len(micro) for k, v in sums.items()}
        grads = [p.grad for p in self.params if p.grad is not None]
        metrics["loss/grad"] = clip_by_global_norm_scheduled(
            grads, self.step, self.cfg)
        self.optimizer.step()
        if self.ema is not None:
            d = self.cfg.train.ema_decay
            with torch.no_grad():
                torch._foreach_mul_(self.ema, d)
                torch._foreach_add_(self.ema, self.params, alpha=1.0 - d)
        self.step += 1
        return metrics

    # -- loop --------------------------------------------------------------

    def train(self, num_steps: Optional[int] = None, log_every: int = 100
              ) -> Dict[str, float]:
        """Step until ``num_steps`` (default ``train.train_num_steps``) or
        the batches run out; log every ``log_every`` steps, where a
        non-finite loss checkpoints and raises; checkpoint every
        ``save_and_sample_every`` steps and at the end. Returns the last
        logged metrics."""
        num_steps = num_steps or self.cfg.train.train_num_steps
        log_every = max(1, min(log_every, num_steps))
        it = iter(self.batches)
        logged: Dict[str, float] = {}
        t0 = time.time()
        while self.step < num_steps:
            try:
                micro = [next(it) for _ in range(self.accum)]
            except StopIteration:
                break
            metrics = self.train_step(micro)
            if self.step % log_every == 0:
                logged = {k: float(v) for k, v in metrics.items()}
                if not math.isfinite(logged["loss/all"]):
                    self.save(self.step)
                    raise FloatingPointError(
                        f"non-finite loss at step {self.step}: {logged}")
                sps = log_every / (time.time() - t0)
                t0 = time.time()
                line = " ".join(f"{k}={v:.4f}"
                                for k, v in sorted(logged.items()))
                print(f"step {self.step} {line} steps/s={sps:.2f}",
                      flush=True)
            if self.step % self.cfg.train.save_and_sample_every == 0:
                self.save(self.step)
        if self.step % self.cfg.train.save_and_sample_every != 0:
            self.save(self.step)
        return logged

    # -- evaluation --------------------------------------------------------

    @torch.no_grad()
    def eval_fixed_t_loss(self, batch: Batch,
                          t_fracs=(0.1, 0.3, 0.5, 0.7, 0.9)
                          ) -> Dict[str, float]:
        """Diffusion loss at fixed steps with fixed noise (trainer.py:523):
        eval mode (no dropout; the kernel routes), refer1, zero posterior
        and MAS noise, noise from ``train.seed + 2``, in float32. The raw
        parameters per step fraction and their mean; the EMA's mean when
        there is one."""
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
            if self.ema is not None:
                names = [n for n, _ in self.model.named_parameters()]
                ema = dict(zip(names, self.ema))
                out["eval/ema_diff_fixed_t"] = float(np.mean(
                    [loss_at(f, ema) for f in t_fracs]))
        return out

    # -- checkpoints -------------------------------------------------------

    def save(self, step: int) -> str:
        state = {"model": self.model.state_dict(),
                 "optimizer": self.optimizer.state_dict(),
                 "generator": self.generator.get_state(),
                 "py_rng": self._py_rng.getstate()}
        if self.ema is not None:
            state["ema"] = self.ema
        return ckpt_lib.save_checkpoint(self.logs_folder, step, state,
                                        keep=self.cfg.train.keep_ckpts)

    def load(self, path: str) -> None:
        """Restore a checkpoint of :meth:`save`, or a params-only one
        (``{"model": ...}``, as converted from the reference): as JAX's
        ``Trainer.load`` does, the optimizer then starts afresh, the random
        streams go on as they are, and the EMA starts from the params."""
        step, state = ckpt_lib.load_checkpoint(path, map_location=self.device)
        self.model.load_state_dict(state["model"], strict=True)
        if "optimizer" in state:
            self.optimizer.load_state_dict(state["optimizer"])
        else:
            self.optimizer = make_optimizer(self.cfg, self.params)
        if "generator" in state:
            self.generator.set_state(state["generator"].cpu())
        if "py_rng" in state:
            self._py_rng.setstate(state["py_rng"])
        if self.ema is not None:
            src = state.get("ema") or self.params
            self.ema = [e.detach().float().clone() for e in src]
        self.step = step

    def resume_latest(self) -> bool:
        """Load the newest checkpoint of the workdir; False when none."""
        path = ckpt_lib.latest_checkpoint_path(self.logs_folder)
        if path is None:
            return False
        self.load(path)
        print(f"resumed from {path} at step {self.step}", flush=True)
        return True
