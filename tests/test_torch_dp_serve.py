"""``serve --dp`` over two gloo ranks on the CPU (spawned by
``parallel.launch.run_ranks`` as ``torchrun`` would start them) at the
tiny config of ``test_torch_cli_serve.py`` (batch 2, two mel buckets, a
2-step DDIM): each rank synthesizes its row of every bucket batch, drawing
the batch's prior and initial noise whole from the batch's generator and
keeping its row, and rank 0 writes. The files are those one process
writes for the manifest: the same names and frame counts, the values
within atol 1e-4 (a batch of 1 on each rank takes other float32 summation
orders than the batch of 2 of one process: ~6e-6 apart on this CPU).
Without a process group, ``--dp`` runs as one rank (``test_torch_cli_serve``).
"""
import os

import numpy as np
import torch

from diff_vits_tpu_torch.infer import serve
from diff_vits_tpu_torch.parallel import launch
from test_torch_cli import files, no_cmudict  # noqa: F401
from test_torch_cli_serve import ROWS, _args, write_manifest

torch.set_num_threads(2)

ATOL = 1e-4


def test_serve_dp_over_two_ranks_writes_the_one_process_mels(
        files, no_cmudict, tmp_path):
    manifest = write_manifest(tmp_path / "utts.tsv", ROWS, files, tmp_path)
    serve.main(_args(files, manifest, tmp_path / "one", "--device", "cpu"))
    launch.run_ranks(serve.main, 2, _args(
        files, manifest, tmp_path / "dp", "--device", "cpu", "--dp"))
    one = sorted(os.listdir(tmp_path / "one"))
    assert one == sorted(f"{u}.mel.npy" for u, _ in ROWS)
    assert sorted(os.listdir(tmp_path / "dp")) == one
    for name in one:
        dp, ref = (np.load(tmp_path / d / name) for d in ("dp", "one"))
        assert dp.shape == ref.shape, name
        np.testing.assert_allclose(dp, ref, rtol=0, atol=ATOL, err_msg=name)
