"""bv2 (the UNet duration predictor, the residual spec flow and the phoneme
prosody VAE; ``benchmark/configs/bv2.json``) in the port against its plain
reference (``benchmark.reference.bv2``) at tiny widths on the CPU: one
state dict loads strictly into both, the same inputs and generator draws
give the same log durations, frame counts and mel, the VAE's noise is
drawn after the prior's, and the port's tracer puts one ``dvt.ph_vae`` and
one ``dvt.flow`` span inside each ``dvt.prior`` and counts the VAE's
tokens."""
import json
from pathlib import Path

import pytest
import torch

from benchmark import references
from benchmark.reference import draws, plain_math
from benchmark.weights import make_state_dict
from diff_vits_tpu_torch.core import trace
from diff_vits_tpu_torch.core.config import Config
from diff_vits_tpu_torch.models.diff_vits import DiffVits, synthesize

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TINY_VITS = dict(inter_channels=16, hidden_channels=32, filter_channels=32,
                 n_heads=2, n_layers=3, kernel_size=3, gin_channels=16)
TINY_DIFF = dict(hidden_channels=16, block_out_channels=(16, 16, 32, 32),
                 n_prompt_layers=2)
B, T, S, MAX_LEN, STEPS = 3, 20, 30, 64, 4
LENGTHS = [20, 15, 9]
# float32 on both sides, the same products in another order (the port's
# layers are written apart from the reference's): gaps of a few float32
# roundings, 2e-6 on the log durations and 1.5e-6 of the largest |mel|
# here; the port in bfloat16 reads 3e-2 on both
LOGW_TOL = 1e-4           # absolute, on log durations of order 1
MEL_TOL = 1e-4            # of the largest |mel|


def tiny_cfg():
    cfg = json.loads((ROOT / "benchmark" / "configs" / "bv2.json")
                     .read_text())
    cfg["vits"].update(TINY_VITS)
    cfg["diffusion_encoder"].update(TINY_DIFF)
    return cfg


def models(dtype=torch.float32):
    """(the reference, its module, the port in ``dtype``), one state dict
    loaded strictly into both."""
    cfg = tiny_cfg()
    reference = references.resolve(cfg)
    ref = reference.DiffVits(reference.Config.from_dict(cfg), cfg["n_vocab"])
    sd = make_state_dict(ref, 5, "cpu", torch.float32)
    ref.load_state_dict(sd, strict=True)
    port = DiffVits(Config.from_dict(cfg), cfg["n_vocab"], device="cpu",
                    dtype=dtype)
    port.load_state_dict(sd, strict=True)
    return reference, ref.eval(), port.eval()


def inputs():
    g = torch.Generator().manual_seed(3)
    return (torch.randint(1, 108, (B, T), generator=g),
            torch.tensor(LENGTHS), torch.randn(B, S, 100, generator=g),
            torch.full((B,), S), torch.randint(0, 11, (B, T), generator=g),
            torch.randint(0, 3, (B, T), generator=g))


def run_port(port, noise_scale):
    """(mel, frame counts, log durations) of one ``synthesize`` call."""
    logw = []
    hook = port.vits.dp.register_forward_hook(
        lambda mod, args, out: logw.append(out.float()))
    mel, lengths = synthesize(
        port, *inputs(), generator=torch.Generator().manual_seed(11),
        sampling_steps=STEPS, max_len=MAX_LEN, noise_scale=noise_scale,
        length_scale=1.5, device="cpu")
    hook.remove()
    return mel.float(), lengths, logw[0]


def run_reference(reference, ref, noise_scale):
    with plain_math():
        return reference.synthesize(
            ref, *inputs(), generator=torch.Generator().manual_seed(11),
            max_len=MAX_LEN, noise_scale=noise_scale, length_scale=1.5,
            steps=STEPS)


def within(port_out, ref_out):
    """Whether the port's log durations, frame counts and mel are the
    reference's, to the tolerances above."""
    (pm, pl, plogw), (rm, rl, rlogw) = port_out, ref_out
    real = torch.arange(T)[None] < torch.tensor(LENGTHS)[:, None]
    return ((plogw - rlogw).abs()[..., 0][real].max() <= LOGW_TOL
            and pl.tolist() == rl.tolist()
            and (pm - rm).abs().max() <= MEL_TOL * rm.abs().max())


@pytest.mark.parametrize("noise_scale", [0.667, 0.0])
def test_synthesize_matches_the_reference(noise_scale):
    reference, ref, port = models()
    got, want = run_port(port, noise_scale), run_reference(reference, ref,
                                                           noise_scale)
    assert got[1].tolist() == want[1].tolist()
    assert within(got, want)


def test_a_bfloat16_port_fails_the_tolerances():
    reference, ref, port = models(torch.bfloat16)
    assert not within(run_port(port, 0.667),
                      run_reference(reference, ref, 0.667))


def test_state_dicts_load_strictly_both_ways():
    _, ref, port = models()
    assert set(ref.state_dict()) == set(port.state_dict())
    assert any(k.startswith("vits.phoneme_vae.ph_encoder_q.")
               for k in ref.state_dict())
    ref.load_state_dict(port.state_dict(), strict=True)


def test_the_vaes_noise_is_drawn_after_the_priors(monkeypatch):
    """Both sides draw the prior's [B, Ty, C] normal, then the VAE's
    [B, Tx, C], then x_T [B, Ty, 100]; in the port the VAE's lies inside
    ``dvt.ph_vae``, the prior's directly inside ``dvt.prior``."""
    reference, ref, port = models()
    c = TINY_VITS["inter_channels"]
    want = [(B, MAX_LEN, c), (B, T, c), (B, MAX_LEN, 100)]
    shapes = []
    inner = draws.randn
    monkeypatch.setattr(draws, "randn", lambda shape, *a, **k: (
        shapes.append(tuple(shape)), inner(shape, *a, **k))[1])
    run_reference(reference, ref, 0.667)
    assert shapes == want

    trace.enable(events=False)
    try:
        run_port(port, 0.667)
    finally:
        trace.disable()
    spans = trace.collect()["spans"]
    by_id = {s["id"]: s for s in spans}
    noise = [s for s in sorted(spans, key=lambda s: s["start_ns"])
             if s["name"] == "dvt.noise"]
    assert [s["attrs"]["elements"] for s in noise] == [
        b * t * k for b, t, k in want]
    assert [by_id[s["parent"]]["name"] for s in noise] == [
        "dvt.prior", "dvt.ph_vae", "dvt.synthesize"]


def test_the_tracer_spans_and_counts_the_vae_and_the_flow():
    _, _, port = models()
    trace.enable(events=False)
    try:
        for _ in range(2):
            run_port(port, 0.667)
    finally:
        trace.disable()
    got = trace.collect()
    by_id = {s["id"]: s for s in got["spans"]}
    for name, attrs in (("dvt.ph_vae", {"batch": B, "text_bucket": T}),
                        ("dvt.flow", {"batch": B, "frames": MAX_LEN})):
        spans = [s for s in got["spans"] if s["name"] == name]
        assert len(spans) == 2
        for s in spans:
            assert by_id[s["parent"]]["name"] == "dvt.prior"
            assert s["attrs"] == attrs
    assert got["counters"]["ph_vae.tokens_real"] == 2 * sum(LENGTHS)
    assert got["counters"]["ph_vae.tokens_held"] == 2 * B * T
    run_port(port, 0.667)
    assert trace.collect() == {"spans": [], "counters": {}}
