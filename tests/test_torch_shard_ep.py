"""Expert parallelism over an ``expert`` axis of two gloo ranks on the
CPU, the denoiser's transformer blocks with the MoE feed-forward (4
experts, top 2): the checks of ``test_torch_shard_tp.py`` (one process's
step with its draws, JAX's ``make_train_step`` in the deterministic mode,
each rank's shards and held bytes against JAX's rules). Each rank holds 2
experts and computes them for the rows both ranks take; the combine is
summed over the ranks. In the same ranks the experts ride a ``model``
axis when the mesh has no ``expert`` axis (JAX's EP-shares-TP layout),
beside the tensor-parallel sites, and equal one process too."""
import pytest
import torch

from test_torch_shard_tp import (
    check_each_rank_holds_its_shard, check_parity_ranks_equal_jax,
    check_ranks_equal_one_process, run)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def numbers():
    return run(("data", "expert"), (1, 2), moe=4,
               extra=[(("data", "model"), (1, 2))])


def test_ep_step_equals_one_process(numbers):
    check_ranks_equal_one_process(numbers)


def test_ep_step_equals_jax_global_step(numbers):
    check_parity_ranks_equal_jax(numbers)


def test_ep_ranks_hold_their_shards(numbers):
    check_each_rank_holds_its_shard(numbers, {"MoEFeedForward"})
    for (_, _, info), _ in numbers["ranks"]:
        w1 = [s["param"] for n, s in info["shapes"].items()
              if n.endswith("ff_moe.w1")]
        assert w1 and all(s[0] == 2 for s in w1)


def test_experts_over_the_model_axis_equal_one_process(numbers):
    (tp,) = numbers["extra"]
    check_ranks_equal_one_process(numbers, [r[:2] for r in tp])
    for _, _, info in tp:
        assert {"MoEFeedForward", "CrossAttention"} <= set(info["sites"])
