"""Convert a reference PyTorch checkpoint into the port's format.

Port of ``diff_vits_tpu/utils/convert_checkpoint.py``: takes the torch
``{'step', 'model': state_dict}`` file the reference Trainer writes
(model3.py:1326-1333) and produces a ``model-<step>.ckpt`` that
``Trainer.load`` and ``infer.tts_infer`` read (params only; the optimizer
restarts, exactly like the reference's own resume). The widths are the
reference's defaults unless a ``Config`` is given; ``utils/convert`` is
the command line that reads them from a config file.

Usage:
  python -m diff_vits_tpu_torch.utils.convert_checkpoint \
      --in logs/tts/<run>/model-172.pt --out_dir logs/tts/converted
"""
from __future__ import annotations

import argparse
from typing import Optional

import torch

from diff_vits_tpu_torch.core.config import Config


def convert(in_path: str, out_dir: str, cfg: Optional[Config] = None
            ) -> str:
    """Write ``in_path``'s parameters as ``out_dir/model-<step>.ckpt``;
    returns its path."""
    from diff_vits_tpu_torch.train import checkpoint as ckpt_lib
    from diff_vits_tpu_torch.utils.convert import (
        reference_state_dict_to_port)

    blob = torch.load(in_path, map_location="cpu", weights_only=True)
    step, sd = reference_state_dict_to_port(blob, cfg or Config())
    path = ckpt_lib.save_checkpoint(out_dir, step, {"model": sd}, keep=0)
    print(f"converted {in_path} (step {step}) -> {path}")
    return path


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--in", dest="in_path", required=True)
    parser.add_argument("--out_dir", required=True)
    args = parser.parse_args(argv)
    return convert(args.in_path, args.out_dir)


if __name__ == "__main__":
    main()
