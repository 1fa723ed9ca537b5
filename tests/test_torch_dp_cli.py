"""The port's training command line data parallel over two gloo ranks on
the CPU (spawned by ``parallel.launch.run_ranks`` as ``torchrun`` would
start them), and the mesh rules (``serve --dp`` is in
``test_torch_dp_serve.py``):

* ``train.cli`` under 2 ranks trains 4 steps (batch 2: a row a rank),
  checkpoints and samples on rank 0 only (rank 1 writes no checkpoint),
  and ``--resume auto`` continues to step 6 from rank 0's file, each rank
  taking back its own generator;
* ``make_mesh`` falls back to the world size as JAX's does, takes a
  ``model`` / ``expert`` / ``seq`` axis larger than 1 (sharded training,
  ``test_torch_shard_*.py``), refuses an axis name JAX's ``Trainer`` does
  not take, and a batch the ranks cannot share equally is refused.
"""
import os

import pytest
import torch

from diff_vits_tpu_torch.parallel import launch, mesh
from diff_vits_tpu_torch.train import checkpoint as ckpt_lib
from test_torch_train_cli import run_config  # noqa: F401

torch.set_num_threads(2)


def test_train_cli_over_two_ranks_then_resume(run_config):
    cfg_path, tmp = run_config
    workdir = str(tmp / "dp_run")
    args = ["-c", cfg_path, "--workdir", workdir, "--log_every", "2",
            "--device", "cpu"]
    ranks = launch.run_ranks(launch.train_cli, 2, [*args, "--steps", "4"])
    assert [step for step, _ in ranks] == [4, 4]
    assert ranks[0][1] == [os.path.join(workdir, f"model-{s}.ckpt")
                           for s in (2, 4)]
    assert ranks[1][1] == []
    names = set(os.listdir(workdir))
    assert {"model-2.ckpt", "model-4.ckpt", "sample-1.mel.npy",
            "sample-2.mel.npy"} <= names
    _, state = ckpt_lib.load_checkpoint(os.path.join(workdir,
                                                     "model-4.ckpt"))
    gens = state["generators"]
    assert len(gens) == 2 and not torch.equal(gens[0], gens[1])

    ranks = launch.run_ranks(launch.train_cli, 2,
                             [*args, "--steps", "6", "--resume", "auto"])
    assert [step for step, _ in ranks] == [6, 6]
    assert ranks[0][1] == [os.path.join(workdir, "model-6.ckpt")]
    assert ranks[1][1] == []


def test_make_mesh_takes_jax_fallback_and_refuses_model_axes():
    assert mesh.make_mesh((4,), ("data",), world=1) == {"data": 1}
    assert mesh.make_mesh((2, 2), ("data",), world=1) == {"data": 1}
    assert mesh.make_mesh((3, 1), ("data", "model"), world=2) == {
        "data": 2, "model": 1}
    assert mesh.make_mesh(None, ("data", "model"), world=4) == {
        "data": 4, "model": 1}
    for shape, axes in (((2, 2), ("data", "model")),
                        ((1, 4), ("data", "expert")),
                        ((2, 2), ("data", "seq"))):
        assert mesh.make_mesh(shape, axes, world=4) == dict(zip(axes, shape))
    with pytest.raises(ValueError, match="mesh axes"):
        mesh.make_mesh((2, 2), ("data", "pipe"), world=4)
    assert mesh.rows(8, 1, 2) == slice(4, 8)
    with pytest.raises(ValueError, match="divisible"):
        mesh.rows(6, 0, 4)
