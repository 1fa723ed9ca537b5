"""The port's training step under ``train.remat_policy`` "full" against
JAX's ``make_train_step`` under "full" (``jax.checkpoint`` of the whole
loss), as ``test_torch_remat.py`` holds "dots": the tiny configuration of
``tests/test_remat.py``, the deterministic mode, the same parameters;
metrics and parameters within rtol 1e-5 / atol 1e-6."""
import torch

from test_torch_remat import check_against_jax

torch.set_num_threads(2)


def test_full_step_equals_jax_make_train_step():
    check_against_jax("full")
