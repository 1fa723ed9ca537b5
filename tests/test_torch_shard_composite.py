"""ZeRO-3 composed with tensor parallelism: four gloo ranks on the CPU
on an ``fsdp`` 2 x ``model`` 2 mesh, the checks of
``test_torch_shard_tp.py`` (one process's step with its draws, JAX's
``make_train_step`` in the deterministic mode, each rank's shards and held
bytes against JAX's rules). The two ``fsdp`` rows of ranks take other rows
of the batch; within each, the two ``model`` ranks run the split sites on
their heads and hidden units, each site's leaves gathered over ``fsdp``
first. In the same ranks a ``model`` 2 x ``seq`` 2 step under
``train.remat_policy`` "dots" (whose recompute runs the sites'
collectives again in the backward) equals the one process's step too.
Its ranks share rows: ``mesh.global_batch_draws``, which makes a rank
draw the whole batch's noise as one process does, does not reach the
recompute in the backward, where a data rank of a real run replays its
own draws."""
import pytest
import torch

from test_torch_shard_tp import (
    check_each_rank_holds_its_shard, check_parity_ranks_equal_jax,
    check_ranks_equal_one_process, run)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def numbers():
    return run(("fsdp", "model"), (2, 2),
               extra=[(("model", "seq"), (2, 2), "dots")])


def test_fsdp_x_model_step_equals_one_process(numbers):
    check_ranks_equal_one_process(numbers)


def test_fsdp_x_model_step_equals_jax_global_step(numbers):
    check_parity_ranks_equal_jax(numbers)


def test_fsdp_x_model_ranks_hold_their_shards(numbers):
    check_each_rank_holds_its_shard(numbers, {
        "CrossAttention", "GEGLUFeedForward", "EncSALayer",
        "TransformerFFNLayer"})


def test_fsdp_x_model_step_under_remat_equals_one_process(numbers):
    (dots,) = numbers["extra"]
    check_ranks_equal_one_process(numbers, [r[:2] for r in dots])
    assert all("CrossAttention" in info["sites"] for _, _, info in dots)
