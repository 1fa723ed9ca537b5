"""Port's UNet1DConditionModel (tiny) against the JAX package with every
resnet and transformer block routed through the Pallas kernels (K1-K4) in
interpret mode (``DIFF_VITS_FUSED=1``), the route the JAX package takes on
the TPU. float32, atol 1e-4, T = 37 (odd: upsample size forcing)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from diff_vits_tpu.nn.unet1d import UNet1DConditionModel as JUNet
from diff_vits_tpu_torch.nn.unet1d import UNet1DConditionModel
from test_torch_common import assert_close, fill, flax_shapes, load, to_jax

torch.set_num_threads(2)


def test_unet_matches_jax_pallas_route(monkeypatch):
    kw = dict(in_channels=8, out_channels=4,
              block_out_channels=(16, 16, 32, 32), cross_attention_dim=16,
              attention_head_dim=4)
    rng = np.random.default_rng(11)
    b, t, s = 2, 37, 9
    x = rng.normal(size=(b, t, 8)).astype(np.float32)
    ts = rng.uniform(0, 999, size=(b,)).astype(np.float32)
    ctx = rng.normal(size=(b, s, 16)).astype(np.float32)
    keep = (np.arange(s)[None] < np.array([[s], [3]])).astype(np.float32)
    jm = JUNet(**kw)
    arrays = [jnp.asarray(a) for a in (x, ts, ctx, keep)]
    tree = fill(flax_shapes(jm, *arrays), seed=5)
    pm = load(UNet1DConditionModel(**kw, device="cpu"), tree)
    monkeypatch.setenv("DIFF_VITS_FUSED", "1")
    ref = jax.jit(jm.apply)(to_jax(tree), *arrays)
    with torch.no_grad():
        port = pm(*[torch.from_numpy(a) for a in (x, ts, ctx, keep)])
    assert_close(port, ref, 1e-4)
