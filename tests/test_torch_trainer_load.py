"""The port's ``Trainer`` on what its JAX counterpart takes or refuses:
a params-only checkpoint (``{"model": ...}``, the kind converted from the
reference) loads as ``diff_vits_tpu/train/trainer.py`` ``Trainer.load``
loads it (a fresh optimizer, the random streams kept, the EMA a copy of
the params) and trains on; every ``train.remat_policy`` JAX takes builds
and steps and a misspelled one raises; a ``train.mesh_shape`` whose
product is not the world size falls back to the world size as JAX's
``make_mesh`` does (one process here), a ``model`` axis larger than 1 is
taken and an axis name JAX's ``Trainer`` does not take is refused."""
from pathlib import Path

import dataclasses

import numpy as np
import pytest
import torch

from diff_vits_tpu_torch.core.config import load_config
from diff_vits_tpu_torch.parallel.mesh import make_mesh
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
    (dict(remat_policy="dots"), None),
    (dict(remat_policy="full"), None),
    (dict(remat_policy="dotz"), "remat_policy"),
    (dict(mesh_shape=(4,)), None),
    (dict(mesh_shape=(2, 2)), None),
], ids=["dots", "full", "misspelled", "dp4", "mesh2x2"])
def test_trainer_refuses_what_it_does_not_run(train, match):
    """What JAX runs builds and steps (a mesh over the one process, as
    JAX's make_mesh takes a shape that is not the device count); what JAX
    refuses is refused."""
    if match is not None:
        with pytest.raises(ValueError, match=match):
            Trainer(_cfg(**train), [], device="cpu")
        return
    tr = Trainer(_cfg(**train), [], device="cpu")
    assert tr.mesh == {"data": 1} and tr.world == 1
    assert all(getattr(m, "remat", tr.cfg.train.remat_policy)
               == tr.cfg.train.remat_policy for m in tr.model.modules())
    metrics = tr.train_step(_batch(0))
    assert tr.step == 1 and np.isfinite(float(metrics["loss/all"]))


def test_trainer_mesh_refuses_a_model_axis():
    """The Trainer's mesh (``make_mesh`` of ``train.mesh_shape`` over the
    ranks): a ``model`` axis of 2 over 2 ranks, which JAX shards the
    Trainer's state over, is taken (the sharded step is held to one
    process in ``test_torch_shard_tp.py``); over one process it falls back
    to (1, 1); an axis JAX's Trainer does not take is refused."""
    shape, axes = (1, 2), ("data", "model")
    assert make_mesh(shape, axes, world=2) == {"data": 1, "model": 2}
    tr = Trainer(_cfg(mesh_shape=shape, mesh_axes=axes), [], device="cpu")
    assert tr.mesh == {"data": 1, "model": 1}
    assert not tr.plan.active and tr.data_ranks == 1
    with pytest.raises(ValueError, match="mesh axes"):
        Trainer(_cfg(mesh_shape=shape, mesh_axes=("data", "pipe")), [],
                device="cpu")


def test_trainer_takes_the_defaults_and_refuses_the_multi_chip_config():
    """The multi-chip config builds on one process: its mesh (4,) falls
    back to the one rank (torchrun spreads it over the ranks)."""
    tr = Trainer(_cfg(remat_policy="none", mesh_shape=(1,)), [],
                 device="cpu")
    assert tr.step == 0
    cfg = load_config(str(CONFIGS / "multi_chip_dp.json"))
    assert tuple(cfg.train.mesh_shape) == (4,)
    tr = Trainer(cfg, [], device="cpu")
    assert tr.mesh == {"data": 1} and tr.world == 1
