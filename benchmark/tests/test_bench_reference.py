"""The frozen reference against the port's plain route, at tiny widths on
the CPU: the same state dict loads into both, and the same inputs and
generator draws give the same mel (synthesis, both duration predictors)
and the same training steps (loss, first gradient and update by leaf, the
reference run two rows at a time with the whole batch's normalisers).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check, references, train
from benchmark.reference import config as rconf, plain_math
from benchmark.reference.model import DiffVits as RefDiffVits
from benchmark.reference.model import synthesize as ref_synthesize
from benchmark.reference.vocos import Vocos as RefVocos
from benchmark.weights import make_state_dict

ROOT = Path(__file__).resolve().parents[2]
TINY_VITS = dict(inter_channels=16, hidden_channels=32, filter_channels=32,
                 n_heads=2, n_layers=3, kernel_size=3, gin_channels=16)
TINY_DIFF = dict(hidden_channels=16, block_out_channels=(16, 16, 32, 32),
                 n_prompt_layers=2)


def tiny_config(kind):
    cfg = json.loads((ROOT / "benchmark" / "configs" / "model3.json")
                     .read_text())
    cfg["vits"].update(TINY_VITS, duration_predictor=kind,
                       use_flow=kind == "sdp")
    cfg["diffusion_encoder"].update(TINY_DIFF)
    return cfg


def models(cfg):
    from diff_vits_tpu_torch.core.config import Config
    from diff_vits_tpu_torch.models.diff_vits import DiffVits
    ref = RefDiffVits(rconf.Config.from_dict(cfg), cfg["n_vocab"])
    sd = make_state_dict(ref, 5, "cpu", torch.float32)
    ref.load_state_dict(sd, strict=True)
    port = DiffVits(Config.from_dict(cfg), cfg["n_vocab"], device="cpu")
    port.load_state_dict(sd, strict=True)
    return ref.eval(), port.eval()


@pytest.mark.parametrize("kind", ["unet", "sdp"])
def test_synthesize_matches_the_port(kind):
    from diff_vits_tpu_torch.models.diff_vits import synthesize
    torch.manual_seed(0)
    ref, port = models(tiny_config(kind))
    g = torch.Generator().manual_seed(3)
    b, t, s = 3, 20, 30
    text = torch.randint(1, 108, (b, t), generator=g)
    tl = torch.tensor([20, 15, 9])
    tone = torch.randint(0, 11, (b, t), generator=g)
    lang = torch.randint(0, 3, (b, t), generator=g)
    refer = torch.randn(b, s, 100, generator=g)
    rl = torch.full((b,), s)
    kw = dict(noise_scale=0.667, length_scale=1.5, max_len=64)
    pm, pl = synthesize(port, text, tl, refer, rl, tone, lang,
                        generator=torch.Generator().manual_seed(11),
                        device="cpu", **kw)
    with plain_math():
        rm, rl_, logw = ref_synthesize(
            ref, text, tl, refer, rl, tone, lang,
            generator=torch.Generator().manual_seed(11), **kw)
    assert pl.tolist() == rl_.tolist()
    assert (pm - rm).abs().max() <= 1e-4 * rm.abs().max()


def test_rows_of_a_batch_take_their_share_of_the_draws():
    """The reference on rows [2, 0] of a batch, drawing the whole batch's
    noise, gives those rows of the whole batch's mel."""
    ref, _ = models(tiny_config("sdp"))
    g = torch.Generator().manual_seed(4)
    b, t, s = 3, 16, 24
    inputs = (torch.randint(1, 108, (b, t), generator=g),
              torch.tensor([16, 12, 9]), torch.randn(b, s, 100, generator=g),
              torch.full((b,), s), torch.zeros(b, t, dtype=torch.long),
              torch.zeros(b, t, dtype=torch.long))
    kw = dict(noise_scale=0.667, length_scale=1.0, max_len=48, steps=6)
    whole, _, _ = ref_synthesize(ref, *inputs,
                                 generator=torch.Generator().manual_seed(9),
                                 **kw)
    rows = [2, 0]
    from benchmark.reference import draws
    with draws.rows(rows, b):
        part, _, _ = ref_synthesize(
            ref, *(x[rows] for x in inputs),
            generator=torch.Generator().manual_seed(9), **kw)
    assert torch.allclose(part, whole[rows], atol=1e-5)


def test_vocoder_matches_the_port():
    from diff_vits_tpu_torch.models.vocoder import Vocos
    ref = RefVocos()
    sd = make_state_dict(ref, 2, "cpu", torch.float32)
    ref.load_state_dict(sd, strict=True)
    port = Vocos(device="cpu")
    port.load_state_dict(sd, strict=True)
    mel = torch.randn(2, 30, 100, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b = port(mel), ref(mel)
    assert (a - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize("kind", ["unet", "sdp"])
def test_training_steps_match_the_port(kind):
    """Three Trainer steps on the CPU (plain route, float32) against the
    reference's, the reference two rows at a time."""
    from diff_vits_tpu_torch.core.config import Config
    from diff_vits_tpu_torch.data.batch import Batch
    from diff_vits_tpu_torch.train.trainer import Trainer
    from benchmark import traffic
    mix = dict(traffic.load("train-crops"), batch_size=5, text_buffer=30,
               mel_crop=50, prompt_frames=30, pool=3, frames_per_token=3.0,
               frames={"median": 40, "sigma": 0.5, "min": 20, "max": 90})
    seed = 2 ** 31 + 99
    run_cfg = train.config(tiny_config(kind), mix, seed)
    run_cfg["train"]["compute_dtype"] = "float32"
    batches = [Batch(**b) for b in traffic.train_batches(
        mix, seed, 108, 100, 3)]
    trainer = Trainer(Config.from_dict(run_cfg), batches=[], device="cpu",
                      workdir=str(ROOT / "build" / "unused"))
    ref = RefDiffVits(rconf.Config.from_dict(run_cfg), 108)
    p0 = make_state_dict(ref, seed, "cpu", torch.float32)
    trainer.model.load_state_dict(p0)
    ref.load_state_dict(p0)
    prog = train.first_steps(trainer, batches, p0, 3)
    refs = check.reference_steps(references.resolve(run_cfg), ref, run_cfg,
                                 batches, 2, "cpu")
    numbers = check.judge_training(prog, refs)
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-4
    assert numbers["update_gap"] < 1e-2
    assert np.isfinite(list(numbers.values())).all()
