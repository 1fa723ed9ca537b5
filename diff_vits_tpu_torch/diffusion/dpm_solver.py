"""Sampling time grids and the model-callback adapter.

Port of ``time_steps_uniform`` (``get_time_steps`` with the time-uniform
grid, the one the serving sampler uses) and ``adapt_x0_fn`` of
``diff_vits_tpu/diffusion/dpm_solver.py``. The quadratic grid and the
DPM-Solver++ sampler itself are not ported yet.
"""
from __future__ import annotations

import inspect
from typing import Callable

import numpy as np
import torch

from diff_vits_tpu_torch.diffusion.noise_schedule import NoiseScheduleVP


def time_steps_uniform(ns: NoiseScheduleVP, steps: int) -> torch.Tensor:
    """Sampling grid of steps+1 times, uniform from ns.T to 1/total_N,
    float32."""
    grid = np.linspace(ns.T, 1.0 / ns.total_N, steps + 1)
    return torch.as_tensor(grid, dtype=torch.float32)


def adapt_x0_fn(x0_fn: Callable) -> Callable:
    """Normalise a model callback to ``(x, t_discrete, step_index)``;
    3-argument callbacks also get the solver's grid index, with which they
    index precomputed per-step conditioning."""
    try:
        n = len(inspect.signature(x0_fn).parameters)
    except (TypeError, ValueError):
        n = 2
    if n >= 3:
        return x0_fn
    return lambda x, td, i: x0_fn(x, td)
