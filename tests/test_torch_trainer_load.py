"""The port's ``Trainer`` on what its JAX counterpart takes or refuses:
a params-only checkpoint (``{"model": ...}``, the kind converted from the
reference) loads as ``diff_vits_tpu/train/trainer.py`` ``Trainer.load``
loads it (a fresh optimizer, the random streams kept, the EMA a copy of
the params) and trains on; a ``train.remat_policy`` or ``train.mesh_shape``
that the port does not run is refused instead of ignored."""
from pathlib import Path

import dataclasses

import numpy as np
import pytest
import torch

from diff_vits_tpu_torch.core.config import load_config
from diff_vits_tpu_torch.train import checkpoint as ckpt_lib
from diff_vits_tpu_torch.train.trainer import Trainer
from test_torch_trainer import _batch, _cfg

torch.set_num_threads(2)

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def test_params_only_checkpoint_loads_and_trains(tmp_path):
    cfg = _cfg(use_ema=True)
    src = Trainer(cfg, [], device="cpu", workdir=str(tmp_path / "src"))
    src.train_step(_batch(0))               # params away from the init
    path = ckpt_lib.save_checkpoint(str(tmp_path / "ckpt"), 7,
                                    {"model": src.model.state_dict()})

    tr = Trainer(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, seed=cfg.train.seed + 1)), [], device="cpu",
        workdir=str(tmp_path / "dst"))
    gen_state = tr.generator.get_state()
    py_state = tr._py_rng.getstate()
    tr.load(path)
    assert tr.step == 7
    for (n, a), b in zip(src.model.state_dict().items(),
                         tr.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    # JAX: opt_state = tx.init(params), the trainer's own rng kept
    assert tr.optimizer.state_dict()["state"] == {}
    assert all(p is q for p, q in zip(
        (p for g in tr.optimizer.param_groups for p in g["params"]),
        tr.params))
    assert torch.equal(tr.generator.get_state(), gen_state)
    assert tr._py_rng.getstate() == py_state
    # the EMA starts as a float32 copy of the loaded params, no alias
    for e, p in zip(tr.ema, tr.params):
        torch.testing.assert_close(e, p.detach().float(), rtol=0, atol=0)
        assert e.untyped_storage().data_ptr() \
            != p.untyped_storage().data_ptr()

    before = [p.detach().clone() for p in tr.params]
    ema_before = [e.clone() for e in tr.ema]
    metrics = tr.train_step(_batch(1))
    assert tr.step == 8
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert any(not torch.equal(a, p) for a, p in zip(before, tr.params))
    assert any(not torch.equal(a, e) for a, e in zip(ema_before, tr.ema))
    assert len(tr.optimizer.state) == sum(
        p.grad is not None for p in tr.params)


@pytest.mark.parametrize("train,match", [
    (dict(remat_policy="dots"), "remat_policy"),
    (dict(remat_policy="full"), "remat_policy"),
    (dict(remat_policy="dotz"), "remat_policy"),
    (dict(mesh_shape=(4,)), "mesh_shape"),
    (dict(mesh_shape=(2, 2)), "mesh_shape"),
], ids=["dots", "full", "misspelled", "dp4", "mesh2x2"])
def test_trainer_refuses_what_it_does_not_run(train, match):
    with pytest.raises(ValueError, match=match):
        Trainer(_cfg(**train), [], device="cpu")


def test_trainer_takes_the_defaults_and_refuses_the_multi_chip_config():
    tr = Trainer(_cfg(remat_policy="none", mesh_shape=(1,)), [],
                 device="cpu")
    assert tr.step == 0
    cfg = load_config(str(CONFIGS / "multi_chip_dp.json"))
    assert tuple(cfg.train.mesh_shape) == (4,)
    with pytest.raises(ValueError, match="Queue 1, item 7"):
        Trainer(cfg, [], device="cpu")
