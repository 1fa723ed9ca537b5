"""The port's ReferenceEncoder (3x3 stride-2 Conv2d stack + GRU) and
SpeakerEncoder (stacked LSTMs) against the JAX package (CPU, float32,
atol = rtol = 1e-4 over T <= 32), and the converter's Conv2d and packed
GRU / LSTM rules both ways, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from diff_vits_tpu.models import encoders as J
from diff_vits_tpu_torch.models import encoders as P
from diff_vits_tpu_torch.utils.convert import convert_tree, to_flax_params
from test_torch_common import assert_close, fill, flax_shapes, load, to_jax
from test_torch_offpath_layers import assert_tree_equal

torch.set_num_threads(2)
TOL = 1e-4


# 100 and 70 mel bins leave 2 bins after the six stride-2 convs, so the
# per-frame flattening order (bin, then channel) decides the GRU's input
@pytest.mark.parametrize("t,mels", [(32, 100), (29, 70)])
def test_reference_encoder_matches_jax(t, mels):
    x = np.random.default_rng(t).normal(size=(2, t, mels)).astype(np.float32)
    jm = J.ReferenceEncoder(mels, 12)
    tree = fill(flax_shapes(jm, jnp.asarray(x)), seed=1)
    pm = load(P.ReferenceEncoder(mels, 12, device="cpu"), tree)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.shape == (2, 12)
    assert_close(got, jm.apply(to_jax(tree), jnp.asarray(x)), atol=TOL,
                 rtol=TOL)
    assert_tree_equal(to_flax_params(pm), tree)


def test_reference_encoder_conv_kernels_land_as_conv2d_weights():
    x = np.zeros((1, 8, 100), np.float32)
    jm = J.ReferenceEncoder(100, 4)
    tree = fill(flax_shapes(jm, jnp.asarray(x)), seed=2)
    pm = load(P.ReferenceEncoder(100, 4, device="cpu"), tree)
    assert pm.gru.weight_ih_l0.shape == (3 * 128, 2 * 128)
    np.testing.assert_array_equal(pm.conv_1.weight.detach().numpy(),
                                  tree["conv_1"]["kernel"].transpose(3, 2,
                                                                     0, 1))


@pytest.mark.parametrize("layers,t", [(2, 16), (3, 32)])
def test_speaker_encoder_matches_jax(layers, t):
    x = np.random.default_rng(layers).normal(size=(3, t, 10)).astype(
        np.float32)
    jm = J.SpeakerEncoder(12, 8, layers)
    tree = fill(flax_shapes(jm, jnp.asarray(x)), seed=3)
    pm = load(P.SpeakerEncoder(10, 12, 8, layers, device="cpu"), tree)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    torch.testing.assert_close(got.norm(dim=1), torch.ones(3))
    assert_close(got, jm.apply(to_jax(tree), jnp.asarray(x)), atol=TOL,
                 rtol=TOL)
    assert_tree_equal(to_flax_params(pm), tree)


def test_packed_cells_have_torch_layout_and_zero_biases():
    rng = np.random.default_rng(0)

    def dense(i, o, bias=True):
        d = {"kernel": rng.normal(size=(i, o)).astype(np.float32)}
        if bias:
            d["bias"] = rng.normal(size=(o,)).astype(np.float32)
        return d
    gru = {"ir": dense(3, 4), "iz": dense(3, 4), "in": dense(3, 4),
           "hr": dense(4, 4, False), "hz": dense(4, 4, False),
           "hn": dense(4, 4)}
    lstm = {g: dense(3, 4, False) for g in ("ii", "if", "ig", "io")}
    lstm.update({g: dense(4, 4) for g in ("hi", "hf", "hg", "ho")})
    sd = convert_tree({"gru": gru, "x": {"lstm_fwd": lstm,
                                         "lstm_bwd": lstm}})
    np.testing.assert_array_equal(sd["gru.weight_ih_l0"][4:8].numpy(),
                                  gru["iz"]["kernel"].T)
    np.testing.assert_array_equal(sd["gru.bias_hh_l0"][:8].numpy(), 0.0)
    np.testing.assert_array_equal(sd["gru.bias_hh_l0"][8:].numpy(),
                                  gru["hn"]["bias"])
    np.testing.assert_array_equal(sd["x.lstm.bias_ih_l0_reverse"].numpy(),
                                  0.0)
    np.testing.assert_array_equal(sd["x.lstm.weight_hh_l0"][8:12].numpy(),
                                  lstm["hg"]["kernel"].T)
    m = nn.Module()
    m.gru = nn.GRU(3, 4, batch_first=True)
    m.x = nn.Module()
    m.x.lstm = nn.LSTM(3, 4, batch_first=True, bidirectional=True)
    m.load_state_dict(sd, strict=True)
    assert_tree_equal(to_flax_params(m), {"gru": gru, "x": {
        "lstm_fwd": lstm, "lstm_bwd": lstm}})


def test_to_flax_folds_trained_input_biases():
    """A torch-trained GRU / LSTM has both biases: the flax tree computes
    the same function (each bias_ih part added into its gate's bias)."""
    torch.manual_seed(0)
    m = nn.Module()
    m.gru = nn.GRU(5, 6, batch_first=True)
    m.lstm = nn.LSTM(5, 6, batch_first=True)
    x = torch.randn(2, 7, 5)
    m2 = nn.Module()
    m2.gru = nn.GRU(5, 6, batch_first=True)
    m2.lstm = nn.LSTM(5, 6, batch_first=True)
    m2.load_state_dict(convert_tree(to_flax_params(m)), strict=True)
    with torch.no_grad():
        for name in ("gru", "lstm"):
            torch.testing.assert_close(getattr(m2, name)(x)[0],
                                       getattr(m, name)(x)[0], rtol=1e-6,
                                       atol=1e-6)
    with pytest.raises(ValueError, match="one-layer"):
        bad = nn.Module()
        bad.rnn = nn.LSTM(3, 4, num_layers=2)
        to_flax_params(bad)
