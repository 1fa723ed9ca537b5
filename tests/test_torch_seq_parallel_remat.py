"""Sequence parallelism under rematerialisation: two gloo ranks on the
CPU on a ``seq`` axis, the tiny configuration of ``test_torch_remat.py``
with four items (``test_torch_dp.py``'s lengths; 16 mel frames, 8 a
rank), one ``Trainer`` step with ``sequence_parallel`` under
``train.remat_policy`` "full" and "dots", whose recomputes run the
halos, the GroupNorm all-reduces and the ring again in the backward,
against one process's step with the same draws (parameters rtol 1e-5 /
atol 1e-6, metrics alike)."""
import dataclasses

import pytest
import torch

from diff_vits_tpu_torch.parallel import launch
from diff_vits_tpu_torch.train.trainer import Trainer
from diff_vits_tpu_torch.utils.convert import convert_tree, to_flax_params
from test_torch_dp import (
    SPEC_LENGTHS, TEXT_LENGTHS, assert_metrics_equal, assert_params_equal)
from test_torch_remat import tiny, tiny_batch

torch.set_num_threads(2)

POLICIES = ("full", "dots")


def config(policy, mesh=False):
    _, pcfg = tiny(policy)
    train = dict(train_batch_size=4)
    if mesh:
        train.update(mesh_axes=("seq",), mesh_shape=(2,))
    return dataclasses.replace(pcfg, train=dataclasses.replace(
        pcfg.train, **train))


@pytest.fixture(scope="module")
def numbers():
    batch = tiny_batch(seed=0, text_lengths=TEXT_LENGTHS,
                       spec_lengths=SPEC_LENGTHS)[0]
    ranks = launch.run_ranks(launch.calls, 2, [
        (launch.train_step, (config(p, True), [batch], "cpu", None, 0),
         dict(seq_parallel=True)) for p in POLICIES], timeout=120)
    start = convert_tree(to_flax_params(Trainer(config("none"), [],
                                                device="cpu").model))
    return dict(ranks=ranks, start=start, one=[
        launch.train_step(config(p), [batch]) for p in POLICIES])


@pytest.mark.parametrize("i", range(len(POLICIES)), ids=POLICIES)
def test_seq_parallel_step_under_remat_equals_one_process(numbers, i):
    params, metrics = numbers["one"][i]
    for rank in numbers["ranks"]:
        got = rank[i]
        assert_params_equal(got[0], params, numbers["start"])
        assert_metrics_equal(got[1], metrics)
