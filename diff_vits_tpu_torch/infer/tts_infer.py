"""TTS inference CLI: text -> frontend -> prior -> diffusion -> mel (-> wav).

Port of ``diff_vits_tpu/infer/tts_infer.py``, with its flags and their
meanings: one utterance from ``--text`` in ``--lang`` and a prompt wav
(``--refer``), the model from a checkpoint of either package (``-m``: the
port's ``torch.save`` checkpoint, or the JAX package's msgpack one). It
writes ``<out_dir>/tts_<refer>.mel.npy`` and, with a vocoder, ``.wav``.
``--vocoder jax`` is this package's own Vocos (``models.vocoder``, from
``--vocoder_ckpt`` or random weights); the JAX CLI's ``torch`` choice
(the external ``vocos`` package, which downloads its weights) is not
offered, so ``auto`` without ``--vocoder_ckpt`` writes the mel only.
Runs on the card unless ``--device cpu``; the kernels build into
``build/kernels/`` on first use and are reused after.

Usage:
  python -m diff_vits_tpu_torch.infer.tts_infer --text "hello world." \\
      --lang EN --refer raw/138.wav -c config.json \\
      -m logs/tts/.../model-1000.ckpt
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from diff_vits_tpu_torch.core.config import Config, load_config
from diff_vits_tpu_torch.core.device import resolve_device
from diff_vits_tpu_torch.core.masking import intersperse
from diff_vits_tpu_torch.data import audio as audio_lib
from diff_vits_tpu_torch.models.diff_vits import (
    SAMPLE_METHODS, DiffVits, synthesize)
from diff_vits_tpu_torch.models.vocoder import load_vocoder
from diff_vits_tpu_torch.text.frontend import (
    clean_text, cleaned_text_to_sequence)
from diff_vits_tpu_torch.text.symbols import symbols
from diff_vits_tpu_torch.train.checkpoint import load_model_state_dict

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def preprocess_text(text: str, language: str = "ZH", add_blank: bool = True):
    """text -> (phone, tone, language) id arrays [1, T] (int64)."""
    _, phones, tones, _ = clean_text(text, language)
    phone, tone, lang = cleaned_text_to_sequence(phones, tones, language)
    if add_blank:
        phone = intersperse(phone, 0)
        tone = intersperse(tone, 0)
        lang = intersperse(lang, 0)
    return tuple(np.asarray(a, np.int64)[None] for a in (phone, tone, lang))


def load_refer_mel(path: str, cfg: Config) -> np.ndarray:
    """The prompt wav at ``path`` -> log-mel [1, S, n_mels] (float32), at
    the config's sampling rate."""
    wav, sr = audio_lib.read_wav(path)
    wav = audio_lib.resample(wav, sr, cfg.data.sampling_rate)
    mel = audio_lib.log_mel(wav, sr=cfg.data.sampling_rate,
                            hop_length=cfg.data.hop_length,
                            n_mels=cfg.data.n_mel_channels)
    return mel[None].astype(np.float32)


def load_cli_config(path: str) -> Config:
    """The config at ``path``, or the defaults where there is no file (as
    the JAX CLIs do)."""
    return load_config(path) if os.path.exists(path) else Config()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--text", type=str, default="你好，再见。")
    parser.add_argument("--lang", type=str, default="ZH",
                        choices=["ZH", "EN", "JA"])
    parser.add_argument("--refer", type=str, required=True)
    parser.add_argument("-c", "--config_path", type=str, default="config.json")
    parser.add_argument("-m", "--model_path", type=str, required=True)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--sample_method", type=str, default="unipc",
                        choices=SAMPLE_METHODS)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--noise_scale", type=float, default=0.667,
                        help="prior sampling temperature")
    parser.add_argument("--length_scale", type=float, default=1.0,
                        help="duration multiplier (>1 = slower speech)")
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=list(DTYPES),
                        help="serving precision: bfloat16 weights and "
                             "tensor-core kernels, or float32")
    parser.add_argument("--out_dir", type=str, default="output")
    parser.add_argument("--vocoder", type=str, default="auto",
                        choices=["auto", "jax", "none"],
                        help="waveform decoder: 'jax' = this package's "
                             "Vocos (random weights without "
                             "--vocoder_ckpt), 'auto' = the same when "
                             "--vocoder_ckpt is given, else mel only, "
                             "'none' = mel only")
    parser.add_argument("--vocoder_ckpt", type=str, default=None,
                        help="Vocos weights: a torch state dict (.bin/.pt) "
                             "in the published layout, or the JAX "
                             "package's .ckpt")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_cli_config(args.config_path)
    model = DiffVits(cfg, len(symbols), device=device,
                     dtype=DTYPES[args.dtype])
    model.load_state_dict(load_model_state_dict(args.model_path, cfg),
                          strict=True)

    phone, tone, lang = preprocess_text(args.text, args.lang,
                                        cfg.data.add_blank)
    refer = load_refer_mel(args.refer, cfg)
    mel, out_lengths = synthesize(
        model, phone, np.array([phone.shape[1]]), refer,
        np.array([refer.shape[1]]), tone, lang,
        generator=torch.Generator().manual_seed(args.seed),
        sampling_steps=args.steps, sample_method=args.sample_method,
        noise_scale=args.noise_scale, length_scale=args.length_scale,
        device=device)
    mel = mel[0, :int(out_lengths[0])].float().cpu().numpy()

    os.makedirs(args.out_dir, exist_ok=True)
    base = os.path.join(args.out_dir, f"tts_{os.path.basename(args.refer)}")
    np.save(base + ".mel.npy", mel)
    print(f"mel saved: {base}.mel.npy shape={mel.shape}", flush=True)

    if args.vocoder == "none" or (args.vocoder == "auto"
                                  and not args.vocoder_ckpt):
        return
    if not args.vocoder_ckpt:
        print("warning: no --vocoder_ckpt; using random-init vocoder "
              "(audio will be noise)", flush=True)
    voc = load_vocoder(cfg, args.vocoder_ckpt, device=device)
    with torch.inference_mode():
        audio = voc(torch.from_numpy(mel[None]).to(device))
    audio_lib.write_wav(base + ".wav", audio[0].cpu().numpy(),
                        cfg.data.sampling_rate)
    print(f"wav saved: {base}.wav", flush=True)


if __name__ == "__main__":
    main()
