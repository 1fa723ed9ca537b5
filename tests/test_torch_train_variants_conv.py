"""The conv duration predictor's training forward against JAX, without a
flow, with the residual-coupling flow and (with gradients) with the
transformer-coupling flow, as set out in test_torch_train_variants.py."""
import pytest
import torch

from test_torch_train_variants import (
    check_forward_and_gradients, check_training_forward)

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["conv_none", "conv_residual"])
def test_vits_training_forward_matches_jax(name):
    check_training_forward(name)


def test_vits_training_forward_and_gradients_match_jax():
    check_forward_and_gradients("conv_transformer")
