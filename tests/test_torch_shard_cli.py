"""The port's training command line under a sharded mesh: two gloo ranks
on the CPU (spawned as ``torchrun`` would start them) read ``"mesh_axes":
["data", "model"]``, ``"mesh_shape": [1, 2]`` from the config and train
the tiny model of ``test_torch_train_cli.py`` with its state split (the
rules' ``min_size`` at 0): both ranks take the same rows, ``eval_sample``
runs on the whole model the ranks gather, rank 0 alone writes, and
``--resume auto`` continues the sharded run from its checkpoint, which one
process loads as its own."""
import dataclasses
import json
import os

import torch

from diff_vits_tpu_torch.core.config import load_config
from diff_vits_tpu_torch.parallel import launch
from diff_vits_tpu_torch.train.trainer import Trainer
from test_torch_train_cli import run_config  # noqa: F401

torch.set_num_threads(2)


def test_train_cli_under_a_model_mesh_then_resume(run_config):
    cfg_path, tmp = run_config
    cfg = load_config(cfg_path)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, mesh_axes=("data", "model"), mesh_shape=(1, 2)))
    path = str(tmp / "tp_config.json")
    with open(path, "w") as f:
        json.dump(cfg.to_dict(), f)
    workdir = str(tmp / "tp_run")
    args = ["-c", path, "--workdir", workdir, "--log_every", "1",
            "--device", "cpu"]
    ranks = launch.run_ranks(launch.train_cli, 2, [*args, "--steps", "2"],
                             0)
    assert [r[0] for r in ranks] == [2, 2]
    assert ranks[0][1] == [os.path.join(workdir, "model-2.ckpt")]
    assert ranks[1][1] == []
    for _, _, info in ranks:
        assert info["mesh"] == {"data": 1, "model": 2}
        assert "CrossAttention" in info["sites"]
    assert {"model-2.ckpt", "sample-1.mel.npy"} <= set(os.listdir(workdir))

    ranks = launch.run_ranks(launch.train_cli, 2,
                             [*args, "--steps", "3", "--resume", "auto"], 0)
    assert [r[0] for r in ranks] == [3, 3]
    assert ranks[0][1] == [os.path.join(workdir, "model-3.ckpt")]
    one = Trainer(cfg, [], device="cpu", workdir=str(tmp / "tp_one"))
    one.load(os.path.join(workdir, "model-3.ckpt"))
    assert one.step == 3 and not one.plan.active
