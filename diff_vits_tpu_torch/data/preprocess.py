"""Offline preprocessing: a folder of wavs and transcripts -> the
training layout.

Port of ``diff_vits_tpu/data/preprocess.py``. Per wav: read the sibling
``.txt``, run the text frontend and write ``lang|norm|phones|tones|word2ph``
(with ``--cleaned``, a line already in that form passes through
unchanged); resample to 24 kHz mono and write the wav; write the log-mel
(``.mel.npy``) and log-linear (``.spec.npy``) features (n_fft 1024, hop
256, 100 mels, power 1, log-clip 1e-7). Host only: numpy and scipy.

Usage:
  python -m diff_vits_tpu_torch.data.preprocess --in_dir dataset \
      --language ZH [--out_dir dataset_processed] [--no_spec] [--cleaned]
"""
from __future__ import annotations

import argparse
import glob
import os
import random

import numpy as np

from diff_vits_tpu_torch.data import audio as audio_lib
from diff_vits_tpu_torch.text.frontend import clean_text


def process_one(filename: str, language: str, in_dir: str, out_dir: str,
                write_spec: bool = True, cleaned: bool = False):
    text_path = filename[:-4] + ".txt"
    rel = os.path.relpath(filename, in_dir)
    out_wav = os.path.join(out_dir, rel)
    os.makedirs(os.path.dirname(out_wav), exist_ok=True)

    try:
        with open(text_path, encoding="utf-8") as f:
            text = f.readline().strip()
        if cleaned and text.count("|") == 4:
            line = text
        else:
            norm_text, phones, tones, word2ph = clean_text(text, language)
            line = "{}|{}|{}|{}|{}".format(
                language, norm_text, " ".join(phones),
                " ".join(str(i) for i in tones),
                " ".join(str(i) for i in word2ph))
        with open(out_wav[:-4] + ".txt", "w", encoding="utf-8") as f:
            f.write(line + "\n")
    except Exception as err:  # one bad transcript does not stop the run
        print("err!", filename, err)

    wav, sr = audio_lib.read_wav(filename)
    wav24k = audio_lib.resample(wav, sr, 24000)
    audio_lib.write_wav(out_wav, wav24k, 24000)
    np.save(out_wav[:-4] + ".mel.npy", audio_lib.log_mel(wav24k))
    if write_spec:
        np.save(out_wav[:-4] + ".spec.npy", audio_lib.log_linear(wav24k))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--in_dir", type=str, default="dataset")
    parser.add_argument("--language", type=str, default="ZH")
    parser.add_argument("--out_dir", type=str, default=None)
    parser.add_argument("--no_spec", action="store_true")
    parser.add_argument("--cleaned", action="store_true",
                        help="transcripts are already phone-level cleaned")
    args = parser.parse_args(argv)

    out_dir = args.out_dir or args.in_dir.rstrip("/") + "_processed"
    filenames = glob.glob(f"{args.in_dir}/**/*.wav", recursive=True)
    random.shuffle(filenames)
    for i, f in enumerate(filenames):
        process_one(f, args.language, args.in_dir, out_dir,
                    write_spec=not args.no_spec, cleaned=args.cleaned)
        if i % 100 == 0:
            print(f"{i}/{len(filenames)}")


if __name__ == "__main__":
    main()
