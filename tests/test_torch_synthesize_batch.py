"""End-to-end ``synthesize``, port against JAX, on a ragged batch of 3
(text lengths 8, 5, 2; prompt lengths 11, 7, 11); see
test_torch_synthesize.py for the setup and the gate."""
import pytest
import torch

from test_torch_synthesize import check_synthesize_matches_jax, tiny_models

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    return tiny_models()


def test_synthesize_matches_jax_ragged_b3(models):
    check_synthesize_matches_jax(models, 3)
