"""Port's VITS prior (``predict_lengths`` and ``infer`` with zero prior
noise) against the JAX package on a ragged batch. Content: float32, atol
1e-4; predicted frame counts: exactly equal."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from diff_vits_tpu.models.vits import VITS as JVITS
from diff_vits_tpu_torch.models.vits import VITS
from test_torch_common import (
    assert_close, fill, flax_shapes, load, tiny_configs, to_jax)

torch.set_num_threads(2)

N_VOCAB = 40


def test_vits_predict_lengths_and_infer_match_jax():
    jcfg, pcfg = tiny_configs()
    rng = np.random.default_rng(8)
    b, t, s, max_len = 3, 9, 12, 48
    text = rng.integers(1, N_VOCAB, (b, t)).astype(np.int32)
    lengths = np.array([9, 4, 2], np.int32)
    refer = rng.normal(size=(b, s, 100)).astype(np.float32)
    refer_lengths = np.array([12, 12, 5], np.int32)
    tone = rng.integers(0, 11, (b, t)).astype(np.int32)
    lang = rng.integers(0, 3, (b, t)).astype(np.int32)
    arrays = (text, lengths, refer, refer_lengths, tone, lang)
    jargs = list(map(jnp.asarray, arrays))
    targs = list(map(torch.from_numpy, arrays))
    key = jax.random.PRNGKey(0)

    jm = JVITS(N_VOCAB, jcfg.vits)

    def init_path(m, *a):
        # the posterior encoder's weights too (speaker-conditioned)
        m.enc_q(a[2], a[3], g=m.ref_enc(a[2])[:, None, :])
        return m.infer(*a, noise_key=key, max_len=max_len)
    tree = fill(flax_shapes(jm, *jargs, method=init_path), seed=4)
    pm = load(VITS(N_VOCAB, pcfg.vits, device="cpu"), tree)
    params = to_jax(tree)

    ref_len = jax.jit(lambda p, *a: jm.apply(
        p, *a, noise_key=key, method=JVITS.predict_lengths))(params, *jargs)
    ref_c, ref_out = jax.jit(lambda p, *a: jm.apply(
        p, *a, noise_key=key, noise_scale=0.0, max_len=max_len,
        method=JVITS.infer))(params, *jargs)
    with torch.no_grad():
        port_len = pm.predict_lengths(*targs)
        port_c, port_out = pm.infer(*targs, noise_scale=0.0, max_len=max_len)
    np.testing.assert_array_equal(port_len.numpy(), np.asarray(ref_len))
    np.testing.assert_array_equal(port_out.numpy(), np.asarray(ref_out))
    assert port_c.shape == (b, max_len, 16)
    assert_close(port_c, ref_c, 1e-4)
