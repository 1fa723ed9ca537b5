"""The port's ``Trainer`` runs a VITS variant unchanged: the stochastic
duration predictor with the residual-coupling spec flow, EMA on, the
flash-attention route on (on the CPU ``sdpa`` takes its plain version):
two CPU steps at the tiny widths of test_torch_variants, finite losses,
every parameter moved. On the CPU the trainer leaves the flash route
off (on the card it turns it on: tests/test_torch_kernels_gpu.py)."""
import dataclasses
import math

import torch

from diff_vits_tpu_torch.nn.unet1d import set_use_flash
from diff_vits_tpu_torch.train.trainer import Trainer
from test_torch_common import tiny_configs
from test_torch_trainer import _batch as trainer_batch
from test_torch_variants import variant_configs

torch.set_num_threads(2)


def test_trainer_takes_steps_on_the_sdp_flow_variant():
    _, cfg = variant_configs(duration_predictor="sdp", use_flow=True)
    _, base = tiny_configs()
    cfg = dataclasses.replace(base, vits=cfg, train=dataclasses.replace(
        base.train, use_ema=True))
    trainer = Trainer(cfg, [], device="cpu")
    set_use_flash(trainer.model, True)
    before = [p.detach().clone() for p in trainer.params]
    for step in range(2):
        metrics = trainer.train_step(trainer_batch(seed=step))
        assert all(math.isfinite(float(v)) for v in metrics.values())
    moved = [not torch.equal(p, p0) for p, p0 in zip(trainer.params, before)]
    assert all(moved), sum(moved)
    assert trainer.step == 2


def test_trainer_leaves_the_flash_route_off_on_the_cpu():
    _, cfg = tiny_configs()
    trainer = Trainer(cfg, [], device="cpu")
    flags = [m.use_flash for m in trainer.model.modules()
             if hasattr(m, "use_flash")]
    assert flags and not any(flags)

