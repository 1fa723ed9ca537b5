"""bv2's work count: ``benchmark.work``'s, with the phoneme VAE's
products added (the prior encoder and the phoneme flow over the text,
the expansion to frames; in training also the pooling into phonemes and
the posterior)."""
from __future__ import annotations

from typing import List

from benchmark import work as bw

predict_lengths = bw.predict_lengths
vocoder = bw.vocoder


def phoneme_prior(b: int, t: int, v, s: int) -> List[bw.Op]:
    """Linear, four EncSALayers (8 heads, FFN kernel 9 to 4h), Linear to
    (m, logs)."""
    h, d = v.hidden_channels, v.hidden_channels // 8
    ops = [bw.linear(b * t, h, h, s)]
    for _ in range(4):
        ops += [bw.linear(b * t, h, 3 * h, s), bw.bmm(b * 8, t, d, t, s),
                bw.bmm(b * 8, t, t, d, s), bw.linear(b * t, h, h, s),
                bw.conv(b, t, t, h, 4 * h, 9, s),
                bw.linear(b * t, 4 * h, h, s)]
    return ops + [bw.linear(b * t, h, 2 * v.inter_channels, s)]


def phoneme_flow(b: int, t: int, v, s: int) -> List[bw.Op]:
    """Four residual couplings of ``n_flow_layer`` WN layers, either way."""
    half, h = v.inter_channels // 2, v.hidden_channels
    one = [bw.linear(b * t, half, h, s)] + bw.wn(
        b, t, h, 5, v.n_flow_layer, v.gin_channels, s) + \
        [bw.linear(b * t, h, half, s)]
    return 4 * one


def synthesize(cfg, b, t_x, t_y, s_prompt, s, steps: int = 30
               ) -> List[bw.Op]:
    v = cfg.vits
    return bw.synthesize(cfg, b, t_x, t_y, s_prompt, s, steps) + \
        phoneme_prior(b, t_x, v, s) + phoneme_flow(b, t_x, v, s) + \
        [bw.bmm(b, t_y, t_x, v.inter_channels, s)]


def train_forward(cfg, b, t_x, t_y, s_prompt, s) -> List[bw.Op]:
    v = cfg.vits
    c = v.inter_channels
    return bw.train_forward(cfg, b, t_x, t_y, s_prompt, s) + \
        [bw.bmm(b, t_x, t_y, c, s, operands=1),
         bw.linear(b * t_x, c, c, s), bw.linear(b * t_x, c, 2 * c, s)] + \
        phoneme_flow(b, t_x, v, s) + phoneme_prior(b, t_x, v, s) + \
        [bw.bmm(b, t_y, t_x, c, s, operands=1)]
