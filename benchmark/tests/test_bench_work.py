"""The work arithmetic against torch's own count of the reference's
products at tiny widths, and the readers' shares against a synthetic
trace.

Each configuration of ``BENCHMARK.json`` is counted by the work count of
the reference it names (``benchmark.references``) against that same
reference, and so is ``model3-conv``, an architecture brought in as files
(``conv_reference``): a new reference's count is held to it here.

``torch.utils.flop_counter`` counts the backward of a grouped convolution
(the stochastic duration predictor's depthwise convs) as if the input's
gradient were an ungrouped product; the work arithmetic counts it at the
forward's size, so the training backward is compared only on models that
have no grouped convolution.
"""
import importlib.util
import json
from pathlib import Path

import pytest
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from benchmark import references, work
from benchmark.reference import config as rconf
from benchmark.reference.vocos import Vocos
from benchmark.tests import conv_reference
from benchmark.weights import make_state_dict

TINY_VITS = dict(inter_channels=16, hidden_channels=32, filter_channels=32,
                 n_heads=2, n_layers=3, kernel_size=3, gin_channels=16)
TINY_DIFF = dict(hidden_channels=16, block_out_channels=(16, 16, 32, 32),
                 n_prompt_layers=2)
B, T, S, TY = 2, 21, 30, 50
ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = [c["name"] for c in BENCH["configs"]] + ["model3-conv"]


def tiny(name, monkeypatch):
    """(reference, its config, its model with weights) of a configuration
    at tiny widths; ``model3-conv``: model3 with the conv duration
    predictor, naming its own reference."""
    conv_reference.install(monkeypatch)
    conv = name == "model3-conv"
    file = next(c["file"] for c in BENCH["configs"]
                if c["name"] == ("model3" if conv else name))
    cfg_dict = json.loads((ROOT / file).read_text())
    cfg_dict["vits"].update(TINY_VITS)
    cfg_dict["diffusion_encoder"].update(TINY_DIFF)
    if conv:
        cfg_dict["vits"]["duration_predictor"] = "conv"
        cfg_dict["reference"] = conv_reference.NAME
    ref = references.resolve(cfg_dict)
    cfg = ref.Config.from_dict(cfg_dict)
    m = ref.DiffVits(cfg, 108)
    m.load_state_dict(make_state_dict(m, 1, "cpu", torch.float32))
    return ref, cfg, m


def inputs():
    g = torch.Generator().manual_seed(0)
    text = torch.randint(1, 108, (B, T), generator=g)
    zeros = torch.zeros(B, T, dtype=torch.long)
    return (text, torch.tensor([T, 15]), torch.randn(B, S, 100, generator=g),
            torch.tensor([S, S]), zeros, zeros)


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        out = fn()
    return fc.get_total_flops(), out


@pytest.mark.parametrize("name", CONFIGS)
def test_synthesize_flops(name, monkeypatch):
    ref, cfg, m = tiny(name, monkeypatch)
    m.eval()
    n, _ = counted(lambda: ref.synthesize(
        m, *inputs(), generator=torch.Generator().manual_seed(1),
        max_len=TY, noise_scale=0.667, length_scale=1.0, steps=4))
    assert n == work.total_flops(ref.work.synthesize(cfg, B, T, TY, S, 2, 4))


@pytest.mark.parametrize("name", CONFIGS)
def test_training_flops(name, monkeypatch):
    ref, cfg, m = tiny(name, monkeypatch)
    m.train()
    text, tl, refer, rl, tone, lang = inputs()
    spec, sl = torch.randn(B, TY, 100), torch.tensor([TY, 40])
    fwd, terms = counted(lambda: m.loss(
        text, tl, spec, sl, refer, rl, tone, lang,
        generator=torch.Generator().manual_seed(2), mas_noise_scale=0.01,
        mas_std=torch.tensor(1.0), n_text=tl.sum(), n_frames=sl.sum(),
        b_total=B))
    ops = ref.work.train_forward(cfg, B, T, TY, S, 2)
    assert fwd == work.total_flops(ops)
    if not any(isinstance(mod, nn.Conv1d) and mod.groups > 1
               for mod in m.modules()):
        bwd, _ = counted(lambda: terms["loss/all"].backward())
        assert bwd == work.train_flops(ops) - work.total_flops(ops)
        assert work.total_flops(work.train_ops(ops)) == work.train_flops(ops)


def test_vocoder_flops():
    n, _ = counted(lambda: Vocos()(torch.randn(2, 40, 100)))
    assert n == work.total_flops(work.vocoder(2, 40, 4))


def test_model3_unet_call_at_its_widths():
    """14.8 GFLOP a model3 denoiser call at b=1, T=400 (a plain-route
    count of the port; the issue's sizing)."""
    cfg = rconf.Config.from_dict({})
    d = cfg.diffusion_encoder
    ops = work.unet(1, 400, 267, d.in_channels + cfg.vits.inter_channels,
                    d.out_channels, d.block_out_channels, d.n_heads,
                    d.hidden_channels, 2, embed=False)
    assert 14.0e9 < work.total_flops(ops) < 15.5e9


def _reader(name):
    path = Path(__file__).resolve().parents[1] / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_shares_cannot_pass_100(kind, monkeypatch):
    """A synthetic trace in which every op runs at its floor, back to back:
    the roofline share and the mfu read 100%, and any slower trace less."""
    _, cfg, _ = tiny("model3", monkeypatch)
    ops = work.synthesize(cfg, B, T, TY, S, 2, 4)
    floor = work.roofline_s(ops)
    flops = work.total_flops(ops)
    for stretch in (1.0, 1.5, 7.0):
        busy = floor * stretch
        ctx = {"profile": {"busy_s": busy, "window_s": busy},
               "profile_ops": ops,
               "mfu": (flops, max(busy, flops / work.PEAK_FLOPS) * stretch)}
        roof = _reader(f"kernel_roofline.{kind}")(ctx)
        mfu = _reader(f"mfu.{kind}")(ctx)
        assert roof == pytest.approx(100.0 / stretch)
        assert roof <= 100.0 + 1e-9 and mfu <= 100.0 + 1e-9
    empty = {"profile": {"busy_s": None, "window_s": 1.0}, "profile_ops": ops}
    assert _reader(f"kernel_roofline.{kind}")(empty) is None
    assert _reader(f"idle_share.{kind}")(empty) is None
