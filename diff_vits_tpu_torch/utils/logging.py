"""Logging and TensorBoard helpers.

Port of ``diff_vits_tpu/utils/logging.py``: a file logger, matplotlib
renderings of a spectrogram or an alignment as HWC uint8 images
(matplotlib imported when first used, with the Agg backend), and a
tensorboardX writer helper.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np


def get_logger(model_dir: str, filename: str = "train.log") -> logging.Logger:
    logger = logging.getLogger(os.path.basename(model_dir))
    logger.setLevel(logging.DEBUG)
    formatter = logging.Formatter(
        "%(asctime)s\t%(name)s\t%(levelname)s\t%(message)s")
    os.makedirs(model_dir, exist_ok=True)
    h = logging.FileHandler(os.path.join(model_dir, filename))
    h.setLevel(logging.DEBUG)
    h.setFormatter(formatter)
    logger.addHandler(h)
    return logger


def _figure_to_numpy(fig) -> np.ndarray:
    import matplotlib.pyplot as plt
    fig.canvas.draw()
    data = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    data = data.reshape(fig.canvas.get_width_height()[::-1] + (4,))[..., :3]
    plt.close(fig)
    return data


def _plot(image: np.ndarray, figsize, xlabel: str, ylabel: str
          ) -> np.ndarray:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=figsize)
    im = ax.imshow(np.asarray(image), aspect="auto", origin="lower",
                   interpolation="none")
    plt.colorbar(im, ax=ax)
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    plt.tight_layout()
    return _figure_to_numpy(fig)


def plot_spectrogram_to_numpy(spectrogram: np.ndarray) -> np.ndarray:
    """mel [C, T] -> HWC uint8 image."""
    return _plot(spectrogram, (10, 2), "Frames", "Channels")


def plot_alignment_to_numpy(alignment: np.ndarray) -> np.ndarray:
    """attention [Tx, Ty] -> HWC uint8 image."""
    return _plot(alignment, (6, 4), "Decoder timestep", "Encoder timestep")


def summarize(writer, global_step: int,
              scalars: Optional[Dict[str, float]] = None,
              histograms: Optional[Dict] = None,
              images: Optional[Dict[str, np.ndarray]] = None,
              audios: Optional[Dict[str, np.ndarray]] = None,
              audio_sampling_rate: int = 24000):
    """Write scalars, histograms, HWC images and audio at ``global_step``."""
    for k, v in (scalars or {}).items():
        writer.add_scalar(k, float(v), global_step)
    for k, v in (histograms or {}).items():
        writer.add_histogram(k, np.asarray(v), global_step)
    for k, v in (images or {}).items():
        writer.add_image(k, v, global_step, dataformats="HWC")
    for k, v in (audios or {}).items():
        writer.add_audio(k, np.asarray(v), global_step, audio_sampling_rate)
