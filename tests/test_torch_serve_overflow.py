"""The port's BatchSynthesizer reports an utterance whose stochastic
duration, drawn again inside ``synthesize``, fills a mel bucket below the
largest (its mel is cut to the bucket), on the CPU at the tiny config with
the sdp duration predictor. With ``length_scale`` 1e-4 every kept token
lasts exactly one frame, so each utterance's drawn frame count is its
text length: the duration pass (10% headroom) then never overflows, and
a pass made to predict one frame for each overflows the utterances longer
than the smallest bucket."""
import dataclasses

import numpy as np
import pytest
import torch

from diff_vits_tpu_torch.infer.serve import BatchSynthesizer
from diff_vits_tpu_torch.models.diff_vits import DiffVits
from diff_vits_tpu_torch.text.symbols import symbols
from test_torch_common import tiny_configs

torch.set_num_threads(2)

LENGTHS = (5, 9, 12)
MEL_BUCKETS = (8, 16, 32)


def _synthesizer():
    _, cfg = tiny_configs()
    cfg = dataclasses.replace(cfg, vits=dataclasses.replace(
        cfg.vits, duration_predictor="sdp"))
    torch.manual_seed(0)
    state = DiffVits(cfg, len(symbols), device="cpu").state_dict()
    return BatchSynthesizer(cfg, state, batch_size=2, steps=2,
                            text_buckets=(16,), refer_frames=10,
                            mel_buckets=MEL_BUCKETS, length_scale=1e-4,
                            dtype=torch.float32, device="cpu")


def _requests():
    rng = np.random.default_rng(0)
    return [(f"utt{i}", rng.integers(1, len(symbols), n),
             rng.integers(0, 11, n), rng.integers(0, 3, n),
             rng.normal(size=(12, 100)).astype(np.float32))
            for i, n in enumerate(LENGTHS)]


@pytest.mark.parametrize("overflow", [False, True])
def test_sdp_overflow_of_a_bucket_is_reported(overflow, capsys):
    syn = _synthesizer()
    if overflow:
        syn.model.vits.predict_lengths = lambda x, *a, **kw: torch.ones(
            x.shape[0], dtype=torch.int32)
    results = syn.synthesize_all(_requests(), seed=1)
    out = capsys.readouterr().out
    frames = [len(r[1]) for r in results]
    if overflow:
        # all in the smallest bucket: the two longer ones are cut to it
        assert frames == [5, 8, 8]
        assert "warning: utt0" not in out
        for utt in ("utt1", "utt2"):
            assert f"warning: {utt} filled its mel bucket 8" in out
    else:
        assert frames == list(LENGTHS)
        assert "warning" not in out
