"""``test_torch_dp.py``'s checks with gradient accumulation over 2
micro-batches (each of the global batch's shape, unequal halves): two
gloo ranks against one process and against JAX's ``make_train_step``
(its scan over the micro-batches), rtol 1e-5 / atol 1e-6."""
import pytest
import torch

from test_torch_dp import (
    check_parity_ranks_equal_jax, check_ranks_equal_one_process, run)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def numbers():
    return run(accum=2)


def test_two_ranks_accumulated_step_equals_one_process(numbers):
    check_ranks_equal_one_process(numbers)


def test_two_ranks_accumulated_step_equals_jax_global_step(numbers):
    check_parity_ranks_equal_jax(numbers)
