"""The check's control and planted faults, on the CPU at tiny widths.

Each test drives a whole run of a cell's driver (set-up, window, check)
without the look for a card, and holds what comes out to the cell's own
limits (``benchmark/limits/<cell>.json``): the program passes them; the
control (the reference in float8 products in the program's place) and
each planted fault fail them. At the cells' own sizes the same readings
come from ``python3 -m benchmark.control`` on the card.

``model3-conv`` is an architecture that the frozen reference refuses
(the conv duration predictor), brought in as files only: its
configuration names its own reference (``conv_reference``), which the
harness resolves like any other.
"""
import json
from pathlib import Path

import pytest
import torch

from benchmark import check, references, serve, train, traffic
from benchmark.tests import conv_reference

ROOT = Path(__file__).resolve().parents[2]
TINY_VITS = dict(inter_channels=16, hidden_channels=32, filter_channels=32,
                 n_heads=2, n_layers=3, kernel_size=3, gin_channels=16)
TINY_DIFF = dict(hidden_channels=16, block_out_channels=(16, 16, 32, 32),
                 n_prompt_layers=2)
CPU = torch.device("cpu")


def limits(cell):
    return json.loads((ROOT / "benchmark" / "limits" / f"{cell}.json")
                      .read_text())["limits"]


def tiny_config(name):
    """A configuration file's contents at tiny widths; ``model3-conv``:
    model3 with the conv duration predictor and its own reference."""
    conv = name == "model3-conv"
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / f"{'model3' if conv else name}.json").read_text())
    cfg["vits"].update(TINY_VITS)
    cfg["diffusion_encoder"].update(TINY_DIFF)
    if conv:
        cfg["vits"]["duration_predictor"] = "conv"
        cfg["reference"] = conv_reference.NAME
    return cfg


def run_serve(config, mix, seed, monkeypatch, control=False):
    conv_reference.install(monkeypatch)
    cfg = tiny_config(config)
    return serve.run(references.resolve(cfg), cfg, tiny_serve_mix(mix), seed,
                     0.5, False, CPU, 0.0, control=control)


def tiny_serve_mix(name):
    mix = traffic.load(name)
    mix.update(batch_size=4, job_requests=6, steps=4, frames_per_token=2.0,
               text_buckets=[64, 128, 256], mel_buckets=[100, 200],
               check_requests=3, max_jobs=6)
    mix["syllables"] = {"median": 6, "sigma": 0.4, "min": 3, "max": 12}
    return mix


def tiny_train_mix():
    mix = traffic.load("train-crops")
    mix.update(batch_size=6, text_buffer=40, mel_crop=60, prompt_frames=40,
               pool=4, check_block_rows=3, frames_per_token=3.0)
    mix["frames"] = {"median": 50, "sigma": 0.5, "min": 20, "max": 100}
    return mix


SERVE = [("model3-serve-b64", "model3", "serve-sentences"),
         ("sdpflow-serve-long", "sdpflow", "serve-paragraphs"),
         ("model3-serve-b64", "model3-conv", "serve-sentences")]


@pytest.mark.parametrize("cell,config,mix", SERVE)
def test_serving_program_passes_and_control_fails(cell, config, mix,
                                                  monkeypatch):
    out = run_serve(config, mix, 2 ** 31 + 3, monkeypatch, control=True)
    assert check.verdict(out["numbers"], limits(cell)), out["numbers"]
    assert not check.verdict(out["ctx"]["control"], limits(cell))


@pytest.mark.parametrize("cell,config,mix", SERVE)
def test_serving_fails_an_answer_altered_where_it_is_made(cell, config, mix,
                                                          monkeypatch):
    from diff_vits_tpu_torch.infer import serve as serve_mod
    inner = serve_mod.synthesize

    def altered(*args, **kwargs):
        mel, lengths = inner(*args, **kwargs)
        return mel + 0.3 * mel.std(), lengths
    monkeypatch.setattr(serve_mod, "synthesize", altered)
    out = run_serve(config, mix, 2 ** 31 + 4, monkeypatch)
    assert not check.verdict(out["numbers"], limits(cell))


def run_train(control=False):
    cfg = tiny_config("model3")
    return train.run(references.resolve(cfg), cfg, tiny_train_mix(),
                     2 ** 31 + 8, 0.5, False, CPU, 0.0, control=control)


def test_training_program_passes_and_control_and_half_batch_fail():
    out = run_train(control=True)
    lim = limits("model3-train-b128")
    assert check.verdict(out["numbers"], lim), out["numbers"]
    assert not check.verdict(out["ctx"]["control"]["fp8"], lim)
    assert not check.verdict(out["ctx"]["control"]["half_batch"], lim)


def test_training_fails_a_step_that_leaves_its_state_unchanged(monkeypatch):
    from diff_vits_tpu_torch.train.trainer import Trainer
    inner = Trainer.train_step

    def unchanged(self, batch):
        saved = [p.detach().clone() for p in self.params]
        metrics = inner(self, batch)
        with torch.no_grad():
            for p, s in zip(self.params, saved):
                p.copy_(s)
        return metrics
    monkeypatch.setattr(Trainer, "train_step", unchanged)
    out = run_train()
    assert out["numbers"]["update_gap"] == pytest.approx(1.0)
    assert not check.verdict(out["numbers"], limits("model3-train-b128"))


def test_training_fails_half_of_the_batch_left_out(monkeypatch):
    from diff_vits_tpu_torch.data.batch import Batch
    from diff_vits_tpu_torch.train.trainer import Trainer
    inner = Trainer.train_step

    def half(self, batch):
        n = len(batch.text) // 2
        return inner(self, Batch(**{k: v[:n] for k, v in
                                    vars(batch).items()}))
    monkeypatch.setattr(Trainer, "train_step", half)
    out = run_train()
    assert not check.verdict(out["numbers"], limits("model3-train-b128"))
