"""The port's audio front end against the JAX package: ``ops/stft`` (the
window and the mel filterbank exactly; the STFT magnitude, log-mel and
log-linear spectrograms on 1 s of noise at atol 2e-4, the bound of
tests/test_stft.py) and ``data/audio`` (the host numpy log-mel and
log-linear, polyphase resampling, wav reading of every sample format the
JAX reader scales, a 16-bit write -> read round trip)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from diff_vits_tpu.data import audio as jaudio
from diff_vits_tpu.ops import stft as jstft
from diff_vits_tpu_torch.data import audio
from diff_vits_tpu_torch.ops import stft

torch.set_num_threads(2)

SR = 24000


def _noise(shape, seed=0, scale=0.1):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("n", [1024, 800, 7])
def test_hann_window_equals_jax(n):
    np.testing.assert_array_equal(stft.hann_window(n), jstft.hann_window(n))
    assert stft.hann_window(n).dtype == np.float32


@pytest.mark.parametrize("sr,n_fft,n_mels,f_min,f_max", [
    (24000, 1024, 100, 0.0, None), (22050, 1024, 80, 0.0, 8000.0),
    (16000, 512, 40, 20.0, None)])
def test_mel_filterbank_equals_jax(sr, n_fft, n_mels, f_min, f_max):
    ours = stft.mel_filterbank(sr, n_fft, n_mels, f_min, f_max)
    np.testing.assert_array_equal(
        ours, jstft.mel_filterbank(sr, n_fft, n_mels, f_min, f_max))
    assert ours.shape == (n_fft // 2 + 1, n_mels) and ours.dtype == np.float32


def test_stft_magnitude_matches_jax():
    """1 s of noise, a batch of 2: [B, frames, n_freqs] = [2, 94, 513]."""
    x = _noise((2, SR))
    ours = stft.stft_magnitude(torch.from_numpy(x))
    ref = np.asarray(jstft.stft_magnitude(jnp.asarray(x)))
    assert ours.shape == ref.shape == (2, 94, 513)
    assert ours.device == torch.device("cpu") and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-4)


@pytest.mark.parametrize("shape", [(SR,), (2, 3, 5000)], ids=["1d", "3d"])
def test_log_mel_spectrogram_matches_jax(shape):
    x = _noise(shape, seed=1)
    ours = stft.log_mel_spectrogram(torch.from_numpy(x))
    ref = np.asarray(jstft.log_mel_spectrogram(jnp.asarray(x)))
    assert ours.shape == ref.shape == shape[:-1] + (1 + shape[-1] // 256,
                                                     100)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-4)


def test_log_linear_spectrogram_matches_jax():
    x = _noise((1, SR), seed=2)
    ours = stft.log_linear_spectrogram(torch.from_numpy(x))
    ref = np.asarray(jstft.log_linear_spectrogram(jnp.asarray(x)))
    assert ours.shape == ref.shape == (1, 94, 513)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-4)


def test_stft_clips_silence_and_keeps_the_caller_device():
    """log(clip(., 1e-7)) of silence; a window shorter than n_fft is
    centred as JAX centres it."""
    silent = stft.log_mel_spectrogram(torch.zeros(1, 4096))
    assert torch.equal(silent, torch.full_like(silent, float(np.log(
        np.float32(1e-7)))))
    x = _noise((2, 4000), seed=3)
    ours = stft.stft_magnitude(torch.from_numpy(x), n_fft=512, hop_length=128,
                               win_length=400)
    ref = np.asarray(jstft.stft_magnitude(jnp.asarray(x), n_fft=512,
                                          hop_length=128, win_length=400))
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-4)


def test_host_log_mel_and_log_linear_match_jax():
    x = _noise(SR, seed=4)
    np.testing.assert_allclose(audio.log_mel(x), jaudio.log_mel(x),
                               atol=2e-4)
    np.testing.assert_allclose(audio.log_linear(x), jaudio.log_linear(x),
                               atol=2e-4)
    assert audio.log_mel(x).shape == (94, 100)
    assert audio.log_mel(x).dtype == np.float32
    # the host path and the tensor path agree
    np.testing.assert_allclose(
        audio.log_mel(x), stft.log_mel_spectrogram(torch.from_numpy(x))
        .numpy(), atol=2e-4)


@pytest.mark.parametrize("sr_in,sr_out", [(22050, 24000), (48000, 24000),
                                          (24000, 24000)])
def test_resample_matches_jax(sr_in, sr_out):
    x = _noise(sr_in // 2, seed=5)
    ours = audio.resample(x, sr_in, sr_out)
    np.testing.assert_array_equal(ours, jaudio.resample(x, sr_in, sr_out))
    assert ours.dtype == np.float32 and len(ours) == sr_out // 2


def test_write_read_wav_round_trip_int16(tmp_path):
    x = np.clip(_noise(2400, seed=6, scale=0.3), -1, 1)
    x[:3] = [1.5, -2.0, 0.0]                   # clipped to [-1, 1]
    path = str(tmp_path / "a.wav")
    audio.write_wav(path, x, sr=SR)
    sr, raw = wavfile.read(path)
    assert sr == SR and raw.dtype == np.int16
    back, sr = audio.read_wav(path)
    assert sr == SR and back.dtype == np.float32 and back.shape == x.shape
    np.testing.assert_allclose(back, np.clip(x, -1, 1), atol=2 / 32768)
    jax_back, _ = jaudio.read_wav(path)
    np.testing.assert_array_equal(back, jax_back)


@pytest.mark.parametrize("kind", ["int32", "uint8", "float32", "stereo"])
def test_read_wav_scales_each_format_as_jax(tmp_path, kind):
    rng = np.random.default_rng(7)
    data = {"int32": rng.integers(-2 ** 31, 2 ** 31 - 1, 500, np.int64)
            .astype(np.int32),
            "uint8": rng.integers(0, 256, 500).astype(np.uint8),
            "float32": _noise(500, seed=8),
            "stereo": rng.integers(-2 ** 15, 2 ** 15 - 1, (500, 2))
            .astype(np.int16)}[kind]
    path = str(tmp_path / f"{kind}.wav")
    wavfile.write(path, 16000, data)
    ours, sr = audio.read_wav(path)
    ref, ref_sr = jaudio.read_wav(path)
    assert sr == ref_sr == 16000 and ours.shape == (500,)
    np.testing.assert_array_equal(ours, ref)
    assert np.abs(ours).max() <= 1.0
