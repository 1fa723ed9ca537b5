"""Training command line of the port.

Port of ``diff_vits_tpu/train/cli.py`` (the same flags, plus ``--device``):
trains from the folder of ``data.training_files`` (as ``data.preprocess``
writes it) on the card unless ``--device`` names another device.
``--resume`` takes the port's checkpoints, a reference checkpoint
converted by ``utils.convert``, and a trainer state of the JAX package
(``Trainer.load``).

Under ``torchrun`` every rank joins the process group first
(``parallel.mesh.init_distributed``: NCCL on the cards, gloo with
``--device cpu``) and the ``Trainer`` trains over the ranks on the mesh of
``train.mesh_shape`` / ``train.mesh_axes``: data parallel over ``data``,
and with its state sharded as JAX's ``state_sharding_rules`` shard it over
``fsdp`` (ZeRO-3), ``model`` (tensor parallelism) and ``expert`` (the MoE
experts); rank 0 alone writes checkpoints and logs, from the state every
rank gathers. A ``train.mesh_shape`` whose product is not the number of
ranks falls back to all of them on ``data``, as in JAX.

Usage:
  python -m diff_vits_tpu_torch.train.cli -c config.json --workdir runs/a \
      [--resume auto|<checkpoint>] [--steps N] [--log_every 100] \
      [--device cpu] [--trace_out spans.json]
  torchrun --nproc_per_node N -m diff_vits_tpu_torch.train.cli \
      -c configs/multi_chip_dp.json --workdir runs/dp [--resume auto]
  # a config with "mesh_shape": [2, 2], "mesh_axes": ["fsdp", "model"]
  torchrun --nproc_per_node 4 -m diff_vits_tpu_torch.train.cli \
      -c tp_fsdp.json --workdir runs/tp
"""
from __future__ import annotations

import argparse
import os

from diff_vits_tpu_torch.core import trace
from diff_vits_tpu_torch.core.config import Config, load_config


def main(argv=None):
    """Parse ``argv``, train, and return the ``Trainer``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, default="config.json")
    parser.add_argument("--resume", type=str, default=None,
                        help="checkpoint path (the port's or a JAX trainer "
                             "state), or 'auto' to continue from the newest "
                             "checkpoint in --workdir (use a fixed --workdir "
                             "for preemption-safe runs)")
    parser.add_argument("--workdir", type=str, default=None,
                        help="fixed run directory (default: a fresh "
                             "timestamped dir under train.logs_folder)")
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; "
                             "raises when there is none)")
    parser.add_argument("--trace_out", type=str, default=None,
                        help="write the port's spans and counters of the "
                             "training loop (core.trace; every span is held "
                             "in memory until the end) to this path as "
                             "Chrome-trace JSON (rank 0's)")
    args = parser.parse_args(argv)

    from diff_vits_tpu_torch.parallel.mesh import init_distributed
    from diff_vits_tpu_torch.train.trainer import Trainer

    init_distributed(device=args.device)
    cfg = load_config(args.config) if os.path.exists(args.config) else Config()
    trainer = Trainer(cfg, workdir=args.workdir, device=args.device)
    if args.resume == "auto":
        trainer.resume_latest()
    elif args.resume:
        trainer.load(args.resume)
    if args.trace_out:
        trace.enable(events=trainer.device.type == "cuda")
    trainer.train(num_steps=args.steps, log_every=args.log_every)
    if args.trace_out:
        collected = trace.collect()
        trace.disable()
        if trainer.rank == 0:
            trace.export(args.trace_out, collected)
    return trainer


if __name__ == "__main__":
    main()
    from diff_vits_tpu_torch.parallel.mesh import shutdown_distributed
    shutdown_distributed()
