"""The port's BatchSynthesizer with a vocoder, on the CPU at the tiny
config with a narrow Vocos (dim 32, 1 layer): 5 requests over 2 text
buckets and 2 mel buckets come back in request order as (utt_id, mel,
wav); each wav is the vocoder's decode of the whole bucket batch its
request rode in, trimmed to n * hop samples; the mels equal those of the
same run without a vocoder, which returns (utt_id, mel) pairs as
before."""
import numpy as np
import torch

from diff_vits_tpu_torch.infer.serve import BatchSynthesizer
from diff_vits_tpu_torch.models.diff_vits import DiffVits
from diff_vits_tpu_torch.models.vocoder import Vocos
from diff_vits_tpu_torch.text.symbols import symbols
from diff_vits_tpu_torch.utils.init import init_random
from test_torch_common import tiny_configs
from test_torch_serve import BATCH, REFER, TEXT_BUCKETS, _requests

torch.set_num_threads(2)


def _synthesizer(cfg, state, vocoder=None):
    return BatchSynthesizer(cfg, state, batch_size=BATCH,
                            text_buckets=TEXT_BUCKETS, refer_frames=REFER,
                            mel_buckets=(6, 24), noise_scale=0.5,
                            vocoder=vocoder, dtype=torch.float32,
                            device="cpu")


def test_batch_synthesizer_returns_trimmed_waveforms():
    _, cfg = tiny_configs()
    torch.manual_seed(0)
    state = DiffVits(cfg, len(symbols), device="cpu").state_dict()
    voc = init_random(Vocos(dim=32, intermediate_dim=64, num_layers=1,
                            device="cpu"), torch.Generator().manual_seed(1))
    decoded = []

    def record(module, args, out):
        decoded.append((args[0].clone(), out.clone()))
    voc.register_forward_hook(record)
    syn = _synthesizer(cfg, state, voc)
    assert syn.vocoder is voc and not voc.training
    reqs = _requests()
    results = syn.synthesize_all(reqs, seed=3)
    plain = _synthesizer(cfg, state).synthesize_all(reqs, seed=3)

    hop = cfg.data.hop_length
    assert [r[0] for r in results] == [r[0] for r in reqs]
    assert all(len(r) == 3 for r in results)
    assert [len(r) for r in plain] == [2] * len(reqs)
    # one decode a bucket batch, the whole padded batch at its shape
    assert 2 <= len(decoded) <= len(reqs)
    assert {m.shape[1] for m, _ in decoded} == {6, 24}
    for mel_in, wav in decoded:
        assert mel_in.dtype == torch.float32 and mel_in.shape[0] == BATCH
        assert wav.shape == (BATCH, (mel_in.shape[1] - 1) * hop)
    for (utt, mel, wav), (p_utt, p_mel) in zip(results, plain):
        n = mel.shape[0]
        assert utt == p_utt
        np.testing.assert_array_equal(mel, p_mel)
        assert wav.dtype == np.float32 and wav.ndim == 1
        # the row of the batch that carried this request
        hits = [(m, w) for m, w in decoded for j in range(BATCH)
                if m.shape[1] >= n and torch.equal(m[j, :n],
                                                   torch.from_numpy(mel))
                and torch.equal(w[j, :len(wav)], torch.from_numpy(wav))]
        assert hits, utt
        m_full, w_full = hits[0]
        assert len(wav) == min(n * hop, w_full.shape[1])
        # and the decode is the vocoder on that batch
        with torch.no_grad():
            torch.testing.assert_close(voc(m_full), w_full, rtol=0, atol=0)
    # n * hop samples, or the bucket's (T - 1) * hop where that is shorter
    # (a request that filled its bucket: utt3 is clamped to 24 frames)
    assert any(len(w) == m.shape[0] * hop for _, m, w in results)
    assert any(len(w) < m.shape[0] * hop for _, m, w in results)
