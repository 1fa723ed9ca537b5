"""Shared helpers of the PyTorch-port parity tests, and parity of the
port's small building blocks (masks, timestep and text embeddings).

Weights: the flax parameter tree of a JAX module is read with
``jax.eval_shape`` of its ``init`` (no initializer runs: flax init of the
tiny UNet alone takes ~30 s on a CPU), filled from a numpy seed in the
flax layout, handed to JAX as is and to the port through
``diff_vits_tpu_torch.utils.convert``. Inputs are numpy arrays given to
both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from diff_vits_tpu.core import masking as jmask
from diff_vits_tpu.core.config import (
    Config as JConfig, DiffusionEncoderConfig as JDiffCfg,
    VitsConfig as JVitsCfg)
from diff_vits_tpu.nn import embeddings as jemb
from diff_vits_tpu_torch.core import masking as tmask
from diff_vits_tpu_torch.core.config import (
    Config, DiffusionEncoderConfig, VitsConfig)
from diff_vits_tpu_torch.nn import embeddings as temb
from diff_vits_tpu_torch.utils.convert import convert_tree

torch.set_num_threads(2)

TINY_VITS = dict(inter_channels=16, hidden_channels=32, filter_channels=32,
                 n_heads=2, n_layers=3, kernel_size=3, gin_channels=16)
TINY_DIFF = dict(hidden_channels=16, block_out_channels=(16, 16, 32, 32),
                 n_prompt_layers=2)


def tiny_configs():
    """(JAX Config, port Config) of the tiny test model."""
    return (JConfig(vits=JVitsCfg(**TINY_VITS),
                    diffusion_encoder=JDiffCfg(**TINY_DIFF)),
            Config(vits=VitsConfig(**TINY_VITS),
                   diffusion_encoder=DiffusionEncoderConfig(**TINY_DIFF)))


def flax_shapes(module, *args, method=None, **kwargs):
    """The params tree of ``module.init(..., method=method)`` as shapes."""
    def init():
        return module.init({"params": jax.random.PRNGKey(0),
                            "dropout": jax.random.PRNGKey(1)}, *args,
                           method=method, **kwargs)
    return jax.eval_shape(init)["params"]


def fill(shapes, seed: int = 0):
    """Numpy values for a tree of shapes, scaled like trained weights:
    kernels ~ N(0, 1/fan_in), norm scales ~ 1, biases and tables small."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, s in flatten_dict(shapes).items():
        leaf, shape = path[-1], s.shape
        if leaf == "kernel":
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif leaf == "scale":
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif leaf == "embedding":
            v = rng.normal(size=shape)
        else:  # bias, positional_embedding, emb_rel_k/v
            v = 0.1 * rng.normal(size=shape)
        out[path] = v.astype(np.float32)
    return unflatten_dict(out)


def to_jax(tree):
    return {"params": jax.tree_util.tree_map(jnp.asarray, tree)}


def load(port_module, tree):
    port_module.load_state_dict(convert_tree(tree), strict=True)
    return port_module.eval()


def assert_close(port_out, jax_out, atol, rtol=0.0):
    """allclose; prints the max |port - jax| seen (``pytest -rP``)."""
    port = np.asarray(port_out.detach().float())
    ref = np.asarray(jax_out, np.float32)
    print(f"max |port - jax| = {np.abs(port - ref).max():.2e} "
          f"(atol {atol}, rtol {rtol})")
    np.testing.assert_allclose(port, ref, atol=atol, rtol=rtol)


# -- building blocks -------------------------------------------------------

def test_sequence_mask_and_generate_path_match_jax():
    rng = np.random.default_rng(0)
    lengths = np.array([5, 1, 3], np.int32)
    dur = rng.integers(0, 4, (3, 5)).astype(np.float32)
    x_mask = (np.arange(5)[None] < lengths[:, None]).astype(np.float32)
    y_mask = (np.arange(12)[None] < np.array([12, 2, 7])[:, None]
              ).astype(np.float32)
    mask = y_mask[:, :, None] * x_mask[:, None, :]
    np.testing.assert_array_equal(
        tmask.sequence_mask(torch.from_numpy(lengths), 6).numpy(),
        np.asarray(jmask.sequence_mask(jnp.asarray(lengths), 6)))
    np.testing.assert_array_equal(
        tmask.generate_path(torch.from_numpy(dur),
                            torch.from_numpy(mask)).numpy(),
        np.asarray(jmask.generate_path(jnp.asarray(dur), jnp.asarray(mask))))


def test_generate_path_of_bfloat16_durations_past_256_frames():
    """Durations held in bfloat16 (the serving dtype) whose running sum
    passes 256 frames: every frame on the token the float32 durations
    put it on, and each token given its own count."""
    g = torch.Generator().manual_seed(0)
    dur = torch.randint(1, 9, (2, 300), generator=g).float()
    mask = torch.ones(2, int(dur.sum(-1).max()), 300)
    path = tmask.generate_path(dur.to(torch.bfloat16),
                               mask.to(torch.bfloat16))
    assert torch.equal(path.float(), tmask.generate_path(dur, mask))
    assert torch.equal(path.float().sum(dim=1), dur)


def test_timestep_embedding_matches_jax():
    t = np.array([0.0, 1.0, 37.5, 999.0], np.float32)
    for dim, flip, shift in [(16, True, 0.0), (7, False, 1.0)]:
        assert_close(
            temb.get_timestep_embedding(torch.from_numpy(t), dim, flip,
                                        shift),
            jemb.get_timestep_embedding(jnp.asarray(t), dim, flip, shift),
            atol=2e-5)


def test_text_time_embedding_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 11, 16)).astype(np.float32)
    for heads in (1, 4, 16):
        jm = jemb.TextTimeEmbedding(16, 24, num_heads=heads)
        tree = fill(flax_shapes(jm, jnp.asarray(x)), seed=heads)
        pm = load(temb.TextTimeEmbedding(16, 24, num_heads=heads), tree)
        assert_close(pm(torch.from_numpy(x)),
                     jm.apply(to_jax(tree), jnp.asarray(x)), atol=1e-5)


# key biases: a bias on the attention keys adds the same q.b to every score
# of a query row, which the softmax cancels, so their true gradient is 0
# and both packages hold float32 rounding noise there
ZERO_GRAD_SUFFIXES = ("conv_k.bias", "k_proj.bias")


def assert_grads_close(module, jax_grads, rtol=1e-3):
    """``module``'s parameter gradients against a JAX gradient tree of the
    same flax parameters (converted by ``convert_tree``): every leaf within
    rtol plus an atol of rtol times the leaf's largest |gradient| (near-zero
    elements are sums of many terms taken in another order). The key biases
    of ZERO_GRAD_SUFFIXES: both sides below 1e-6 times the largest
    gradient of the tree."""
    ref = convert_tree(jax.tree_util.tree_map(np.asarray, jax_grads))
    params = dict(module.named_parameters())
    assert set(ref) == set(params)
    top = max(float(np.abs(r.numpy()).max()) for r in ref.values())
    worst = 0.0
    for name, p in params.items():
        assert p.grad is not None, name
        got, want = p.grad.numpy(), ref[name].numpy()
        if name.endswith(ZERO_GRAD_SUFFIXES):
            assert np.abs(got).max() <= 1e-6 * top, name
            assert np.abs(want).max() <= 1e-6 * top, name
            continue
        scale = float(np.abs(want).max())
        worst = max(worst, float(np.abs(got - want).max()) / scale)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                                   err_msg=name)
    print(f"{len(params)} leaves; worst max |port - jax| / max |jax| = "
          f"{worst:.2e}")
