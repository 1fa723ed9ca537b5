"""``synthesize`` with the MoE feed-forward in every transformer block of
the denoiser UNet (``diffusion_encoder.moe_experts`` 4, top 2) against the
JAX package on the tiny config: 30-step UniPC from injected initial noise,
zero prior noise, a ragged batch of 2; gate max |mel diff| <= 5e-3 (that
of ``test_torch_synthesize.py``) and equal frame counts. The weights are
JAX's tree with the stacked expert kernels scaled as trained weights,
carried over by ``from_flax_params``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diff_vits_tpu.models.diff_vits import DiffVits as JDiffVits
from diff_vits_tpu.models.diff_vits import synthesize as jsynthesize
from diff_vits_tpu_torch.models.diff_vits import DiffVits, synthesize
from diff_vits_tpu_torch.text.symbols import symbols
from diff_vits_tpu_torch.utils.convert import from_flax_params
from test_torch_common import flax_shapes, tiny_configs, to_jax
from test_torch_moe import fill_moe
from test_torch_synthesize import GATE, ORDER, make_batch

torch.set_num_threads(2)


def test_moe_synthesize_matches_jax():
    jcfg, pcfg = tiny_configs()
    moe = dict(moe_experts=4, moe_top_k=2)
    jcfg = dataclasses.replace(jcfg, diffusion_encoder=dataclasses.replace(
        jcfg.diffusion_encoder, **moe))
    pcfg = dataclasses.replace(pcfg, diffusion_encoder=dataclasses.replace(
        pcfg.diffusion_encoder, **moe))
    jm = JDiffVits(jcfg, n_vocab=len(symbols))
    b, t, s, ty = 1, 5, 7, 12
    text = jnp.ones((b, t), jnp.int32)
    lengths = jnp.full((b,), t, jnp.int32)
    refer = jnp.zeros((b, s, 100))
    refer_lengths = jnp.full((b,), s, jnp.int32)

    def init_path(m):
        m.vits.enc_q(refer, refer_lengths,
                     g=m.vits.ref_enc(refer)[:, None, :])
        content, _ = m.vits_infer(text, lengths, refer, refer_lengths, text,
                                  text, noise_key=jax.random.PRNGKey(0),
                                  max_len=ty)
        ph, pk = m.encode_prompt(refer, refer_lengths)
        return m.denoise_cached(jnp.zeros((b, ty, 100)), jnp.ones((b,)),
                                content, ph, pk)

    tree = fill_moe(flax_shapes(jm, method=init_path), seed=2)
    pm = DiffVits(pcfg, len(symbols), device="cpu")
    pm.load_state_dict(from_flax_params(tree, pcfg), strict=True)
    pm.eval()
    assert sum(".ff_moe." in n for n, _ in pm.named_parameters()) > 0

    max_len = 40
    data = make_batch(2, 8, 11, seed=2)
    noise = np.random.default_rng(102).normal(
        size=(2, max_len, 100)).astype(np.float32)
    run = jax.jit(functools.partial(
        jsynthesize, jm, sampling_steps=30, sample_method="unipc",
        noise_scale=0.0, max_len=max_len))
    ref_mel, ref_len = run(to_jax(tree),
                           *[jnp.asarray(data[k]) for k in ORDER],
                           key=jax.random.PRNGKey(0),
                           init_noise=jnp.asarray(noise))
    mel, out_len = synthesize(
        pm, *[torch.from_numpy(data[k]) for k in ORDER], sampling_steps=30,
        noise_scale=0.0, max_len=max_len, init_noise=torch.from_numpy(noise),
        device="cpu")
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
    err = float(np.abs(mel.numpy() - np.asarray(ref_mel)).max())
    print(f"MoE synthesize: max |mel diff| = {err:.2e} (gate {GATE}), "
          f"max |mel| {float(np.abs(np.asarray(ref_mel)).max()):.3f}")
    assert err <= GATE, err
