"""AISHELL-3 adapter: copy the training wavs and write each one's
transcript beside it, from ``train/label_train-set.txt``, for
``data.preprocess``.

Port of ``diff_vits_tpu/data/aishell.py``.

Usage:
  python -m diff_vits_tpu_torch.data.aishell --in_dir AISHELL3 \
      --out_dir AISHELL3_mas
"""
from __future__ import annotations

import argparse
import glob
import os
import shutil


def prepare(in_dir: str, out_dir: str):
    label_path = os.path.join(in_dir, "train", "label_train-set.txt")
    labels = {}
    with open(label_path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split("|")
            if len(parts) >= 3:
                utt, _pinyin, text = parts[0], parts[1], parts[2]
                labels[utt.strip()] = text.strip()

    os.makedirs(out_dir, exist_ok=True)
    wavs = glob.glob(os.path.join(in_dir, "train", "wav", "**", "*.wav"),
                     recursive=True)
    n = 0
    for wav in wavs:
        utt = os.path.splitext(os.path.basename(wav))[0]
        if utt not in labels:
            continue
        dst = os.path.join(out_dir, os.path.basename(wav))
        shutil.copy(wav, dst)
        with open(dst[:-4] + ".txt", "w", encoding="utf-8") as f:
            f.write(labels[utt] + "\n")
        n += 1
    print(f"prepared {n} utterances -> {out_dir}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--in_dir", required=True)
    parser.add_argument("--out_dir", required=True)
    args = parser.parse_args(argv)
    prepare(args.in_dir, args.out_dir)


if __name__ == "__main__":
    main()
