"""Checkpoints of a sharded ``Trainer`` (the port's counterpart of
``tests/test_checkpoint.py:46``): four gloo ranks on the CPU on an
``fsdp`` 2 x ``model`` 2 mesh (``parallel.launch.checkpoint_cycle``), the
tiny configuration of ``test_torch_shard_tp.py`` with EMA on.

* A one-process checkpoint loads into the sharded ranks bit for bit: each
  rank holds the shards JAX's rules give it, and the state they gather
  again is the file's, parameters, AdamW moments and EMA.
* The sharded ranks' checkpoint is one process's format and loads into
  one process bit for bit (the whole state the ranks gathered).
* ``save_flax`` under sharding writes the bytes one process writes from
  that state, and the whole model the ranks gather for ``eval_sample``
  gives one process's fixed-t losses, the EMA's included (rtol 1e-5 /
  atol 1e-6: a rank computes on one thread, this process on two).
* ``resume_latest`` under sharding resumes the same trajectory: a fresh
  sharded ``Trainer`` resumed from the checkpoint takes the next step to
  the parameters of the run that went straight on, bitwise.
* On two ``model`` ranks (fused q|k|v split part by part), a step that
  raises on one rank (``parallel.launch.crash_cycle``: rank 1 before its
  first collective; the other then fails in its own) re-raises
  on every rank, rank 1's own error unchanged, and each rank leaves its
  shards in ``model-1.shards``; ``Trainer.load`` (and ``resume_latest``)
  of that directory reassembles the whole state the ranks held before the
  step, bit for bit.
"""
import os

import numpy as np
import pytest
import torch

from diff_vits_tpu_torch.parallel import launch
from diff_vits_tpu_torch.train import checkpoint as ckpt_lib
from diff_vits_tpu_torch.train.trainer import Trainer
from test_torch_dp import ATOL, RTOL, SPEC_LENGTHS, TEXT_LENGTHS
from test_torch_remat import tiny_batch
from test_torch_shard_tp import configs, expected_shapes

torch.set_num_threads(2)

AXES, SHAPE = ("fsdp", "model"), (2, 2)


def _state_arrays(tr):
    """A one-process Trainer's state as :func:`launch._numpy_state`."""
    return launch._numpy_state(tr.whole_state())


def _assert_same_state(got, want):
    assert set(got["model"]) == set(want["model"])
    for k, v in want["model"].items():
        np.testing.assert_array_equal(got["model"][k], v, err_msg=k)
    assert set(got["optimizer"]) == set(want["optimizer"])
    for k, v in want["optimizer"].items():
        np.testing.assert_array_equal(got["optimizer"][k], v, err_msg=k)
    assert len(got["ema"]) == len(want["ema"])
    for a, b in zip(got["ema"], want["ema"]):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def cycle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard_ckpt")
    jcfg, pcfg = configs(AXES, SHAPE)
    b0, b1, b2 = (tiny_batch(seed=s, text_lengths=TEXT_LENGTHS,
                             spec_lengths=SPEC_LENGTHS)[0] for s in range(3))
    one = Trainer(pcfg, [], device="cpu", workdir=str(tmp / "one"))
    one.train_step(b2)
    start = one.save(one.step)
    ranks = launch.run_ranks(launch.checkpoint_cycle, 4, pcfg, [b0, b1],
                             str(tmp / "sharded"), start, "cpu", 0,
                             timeout=180)
    return dict(tmp=tmp, cfg=pcfg, start=start, start_state=_state_arrays(
        one), ranks=ranks, shapes=expected_shapes(jcfg, pcfg, AXES, SHAPE))


def test_one_process_checkpoint_loads_into_the_shards_bitwise(cycle):
    for r in cycle["ranks"]:
        loaded = r["loaded"]
        _assert_same_state(loaded["whole"], cycle["start_state"])
        for name, shapes in loaded["shapes"].items():
            assert set(shapes.values()) == {cycle["shapes"][name][0]}, name
    assert any(local != whole for local, whole in cycle["shapes"].values())


def test_sharded_checkpoint_loads_into_one_process_bitwise(cycle):
    saved = cycle["ranks"][0]["saved"]
    assert saved and all(r["saved"] is None for r in cycle["ranks"][1:])
    step, state = ckpt_lib.load_checkpoint(saved)
    _, ref = ckpt_lib.load_checkpoint(cycle["start"])
    assert step == 2 and set(state) == set(ref) | {"generators"}
    one = Trainer(cycle["cfg"], [], device="cpu",
                  workdir=str(cycle["tmp"] / "back"))
    one.load(saved)
    assert one.step == 2
    _assert_same_state(_state_arrays(one), cycle["ranks"][0]["whole"])
    for r in cycle["ranks"][1:]:
        _assert_same_state(r["whole"], cycle["ranks"][0]["whole"])


def test_save_flax_under_sharding_writes_one_process_bytes(cycle):
    flax = cycle["ranks"][0]["saved_flax"]
    assert flax and all(r["saved_flax"] is None for r in cycle["ranks"][1:])
    one = Trainer(cycle["cfg"], [], device="cpu",
                  workdir=str(cycle["tmp"] / "flax_one"))
    one.load(cycle["ranks"][0]["saved"])
    mine = one.save_flax(one.step)
    assert os.path.basename(mine) == os.path.basename(flax)
    with open(mine, "rb") as a, open(flax, "rb") as b:
        assert a.read() == b.read()


def test_whole_model_evaluates_as_one_process(cycle):
    one = Trainer(cycle["cfg"], [], device="cpu",
                  workdir=str(cycle["tmp"] / "eval_one"))
    one.load(cycle["ranks"][0]["saved"])
    b0 = tiny_batch(seed=0, text_lengths=TEXT_LENGTHS,
                    spec_lengths=SPEC_LENGTHS)[0]
    want = one.eval_fixed_t_loss(b0)
    assert "eval/ema_diff_fixed_t" in want
    for r in cycle["ranks"]:     # one thread a rank, two here
        assert set(r["eval"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(r["eval"][k], v, rtol=RTOL,
                                       atol=ATOL, err_msg=k)


def test_resume_latest_under_sharding_resumes_the_trajectory(cycle):
    for r in cycle["ranks"]:
        assert r["resumed_from"] == cycle["ranks"][0]["saved"]
        for name, a in r["straight"].items():
            np.testing.assert_array_equal(r["resumed"][name], a,
                                          err_msg=name)
        moved = [n for n, a in r["straight"].items()
                 if not np.array_equal(a, r["whole"]["model"][n])]
        assert len(moved) > len(r["straight"]) // 2


@pytest.fixture(scope="module")
def crash(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard_crash")
    _, pcfg = configs(AXES, (1, 2))
    b0, b1 = (tiny_batch(seed=s, text_lengths=TEXT_LENGTHS,
                         spec_lengths=SPEC_LENGTHS)[0] for s in range(2))
    ranks = launch.run_ranks(launch.crash_cycle, 2, pcfg, [b0, b1],
                             str(tmp), 1, "cpu", 0, timeout=120)
    return dict(tmp=tmp, cfg=pcfg, ranks=ranks)


def test_a_failed_sharded_step_reraises_and_writes_every_rank(crash):
    folder = os.path.join(crash["tmp"], "model-1.shards")
    for r, got in enumerate(crash["ranks"]):
        assert got["step"] == 1
        assert got["crash"] == [os.path.join(folder, f"rank-{r}-of-2.pt")]
        assert got["error"] is not None
    assert crash["ranks"][1]["error"] == \
        "RuntimeError('injected failure on rank 1')"
    assert sorted(os.listdir(folder)) == [f"rank-{r}-of-2.pt"
                                          for r in range(2)]


@pytest.mark.parametrize("how", ["load", "resume_latest"])
def test_crash_shards_load_into_the_state_before_the_step(crash, how):
    one = Trainer(crash["cfg"], [], device="cpu", workdir=str(crash["tmp"]))
    if how == "load":
        one.load(os.path.join(crash["tmp"], "model-1.shards"))
    else:
        assert one.resume_latest()
    assert one.step == 1
    for r in crash["ranks"]:
        _assert_same_state(_state_arrays(one), r["before"])
