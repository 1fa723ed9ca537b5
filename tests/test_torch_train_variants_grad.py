"""The stochastic duration predictor with the residual-coupling flow:
``VITS.forward`` and its gradients against JAX (one jitted value and
gradient), as set out in test_torch_train_variants.py."""
import torch

from test_torch_train_variants import check_forward_and_gradients

torch.set_num_threads(2)


def test_vits_training_forward_and_gradients_match_jax():
    check_forward_and_gradients("sdp_residual")
