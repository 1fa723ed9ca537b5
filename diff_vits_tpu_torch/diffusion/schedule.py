"""Beta schedule (port of ``linear_beta_schedule`` of
``diff_vits_tpu/diffusion/schedule.py``)."""
from __future__ import annotations

import numpy as np


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    """Linear beta schedule in float64."""
    scale = 1000 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps,
                       dtype=np.float64)
