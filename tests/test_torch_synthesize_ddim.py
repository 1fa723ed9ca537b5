"""``synthesize`` of the port with DDIM (``sample_method="ddim"``, eta 0:
integer steps of ``np.linspace(-1, 999, 31)``, the UNet embedding its own
timesteps each call) against the JAX package's on the tiny config: a
ragged batch of 2, 30 steps, injected initial noise, zero prior noise,
float32. Gate: max |mel diff| <= 5e-3; frame counts equal."""
import torch

from test_torch_synthesize_samplers import (  # noqa: F401 (a fixture)
    check_sampler_matches_jax, models)

torch.set_num_threads(2)


def test_ddim_matches_jax(models):
    _, calls = check_sampler_matches_jax(models, "ddim")
    # one UNet call a step, each embedding its own integer timestep
    assert calls == [None] * 30
