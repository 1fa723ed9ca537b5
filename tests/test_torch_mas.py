"""Port's MAS (``ops/mas.py``; on the CPU its plain version) against the
JAX package's scan MAS and its Pallas kernel in interpret mode. The paths
must be identical cell for cell (tolerance 0): random scores, small
integer scores (ties in the DP and in the backtrack), ragged lengths,
items with t_x == t_y, t_x == 1 and t_y == 1, and a bfloat16 input."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.ops.mas import maximum_path as jax_maximum_path
from diff_vits_tpu.ops.mas_pallas import maximum_path_pallas
from diff_vits_tpu_torch.ops import mas

torch.set_num_threads(2)


def _case(seed, b, t_y_max, t_x_max, tied):
    rng = np.random.default_rng(seed)
    t_y = rng.integers(t_x_max, t_y_max + 1, b)
    t_x = rng.integers(2, t_x_max + 1, b)
    t_y[0], t_x[0] = t_y_max, t_x_max        # unpadded item
    t_x[1] = t_y[1] = min(t_y[1], t_x_max)   # t_x == t_y: the diagonal
    t_x[2] = 1                               # one token takes every frame
    t_y[3], t_x[3] = 1, 1                    # one frame
    if tied:
        neg = rng.integers(-2, 1, (b, t_y_max, t_x_max)).astype(np.float32)
    else:
        neg = (rng.normal(size=(b, t_y_max, t_x_max)) * 5 - 50
               ).astype(np.float32)
    y_keep = np.arange(t_y_max)[None] < t_y[:, None]
    x_keep = np.arange(t_x_max)[None] < t_x[:, None]
    mask = (y_keep[:, :, None] & x_keep[:, None, :]).astype(np.float32)
    return neg, mask


@pytest.mark.parametrize("seed,b,t_y,t_x,tied", [
    (0, 5, 37, 13, False),
    (1, 6, 29, 29, True),      # Tx == Ty buffers, ties everywhere
    (2, 4, 45, 17, True),
])
def test_plain_mas_equals_jax_scan_and_pallas(seed, b, t_y, t_x, tied):
    neg, mask = _case(seed, b, t_y, t_x, tied)
    port = mas.maximum_path(torch.from_numpy(neg), torch.from_numpy(mask))
    scan = np.asarray(jax_maximum_path(jnp.asarray(neg), jnp.asarray(mask)))
    pallas = np.asarray(maximum_path_pallas(jnp.asarray(neg),
                                            jnp.asarray(mask),
                                            interpret=True))
    assert port.dtype == torch.float32
    np.testing.assert_array_equal(port.numpy(), scan)
    np.testing.assert_array_equal(port.numpy(), pallas)
    # every kept frame on exactly one token
    np.testing.assert_array_equal(port.numpy().sum(2), mask[:, :, 0])


def test_plain_mas_keeps_bfloat16_and_matches_jax():
    neg, mask = _case(3, 4, 23, 9, False)
    port = mas.maximum_path(torch.from_numpy(neg).bfloat16(),
                            torch.from_numpy(mask))
    ref = jax_maximum_path(jnp.asarray(neg).astype(jnp.bfloat16),
                           jnp.asarray(mask))
    assert port.dtype == torch.bfloat16
    np.testing.assert_array_equal(port.float().numpy(),
                                  np.asarray(ref, np.float32))


def test_mas_refuses_other_devices_and_counts_no_cpu_launch():
    neg, mask = _case(4, 4, 10, 5, False)
    before = mas.maximum_path.launches
    mas.maximum_path(torch.from_numpy(neg), torch.from_numpy(mask))
    assert mas.maximum_path.launches == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        mas.maximum_path(torch.zeros(1, 4, 3, device="meta"),
                         torch.zeros(1, 4, 3, device="meta"))
