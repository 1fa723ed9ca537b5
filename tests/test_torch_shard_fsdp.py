"""ZeRO-3 over an ``fsdp`` axis of two gloo ranks on the CPU: the checks
of ``test_torch_shard_tp.py`` (one process's step with its draws, JAX's
``make_train_step`` in the deterministic mode, each rank's shards and held
bytes against JAX's rules). The ``fsdp`` ranks take other rows (ZeRO-3 is
data parallel), every split leaf is gathered for the step and its gradient
reduce-scattered, and no site runs on shards. In the same ranks a
``data`` x ``seq`` mesh, which the JAX ``Trainer`` runs as replicas that
shard nothing, equals the one process's step too."""
import pytest
import torch

from test_torch_shard_tp import (
    check_each_rank_holds_its_shard, check_parity_ranks_equal_jax,
    check_ranks_equal_one_process, run)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def numbers():
    return run(("data", "fsdp"), (1, 2), extra=[(("data", "seq"), (1, 2))])


def test_fsdp_step_equals_one_process(numbers):
    check_ranks_equal_one_process(numbers)


def test_fsdp_step_equals_jax_global_step(numbers):
    check_parity_ranks_equal_jax(numbers)


def test_fsdp_ranks_hold_their_shards(numbers):
    check_each_rank_holds_its_shard(numbers, set())


def test_seq_mesh_step_equals_one_process(numbers):
    (seq,) = numbers["extra"]
    check_ranks_equal_one_process(numbers, [r[:2] for r in seq])
    for _, _, info in seq:     # nothing split: every rank holds all
        assert info["mesh"] == {"data": 1, "seq": 2} and info["sites"] == []
        for name, shapes in info["shapes"].items():
            assert set(shapes.values()) == {numbers["shapes"][name][1]}
