"""Port's BatchSynthesizer on the CPU: 5 tokenised requests over 2 text
buckets and 2 mel buckets come back in request order, each equal to a
direct ``synthesize`` of the padded bucket batch it rode in."""
import numpy as np
import pytest
import torch

from diff_vits_tpu_torch.infer.serve import (
    BatchSynthesizer, pad_to, pick_bucket)
from diff_vits_tpu_torch.models.diff_vits import synthesize
from diff_vits_tpu_torch.text.symbols import symbols
from test_torch_common import tiny_configs

torch.set_num_threads(2)

TEXT_BUCKETS = (8, 16)
BATCH, REFER = 2, 10


def _requests():
    rng = np.random.default_rng(0)
    out = []
    for i, n in enumerate([5, 12, 3, 16, 7]):
        out.append((f"utt{i}", rng.integers(1, len(symbols), n),
                    rng.integers(0, 11, n), rng.integers(0, 3, n),
                    rng.normal(size=(8 + 3 * i, 100)).astype(np.float32)))
    return out


def _padded(group, t_bucket):
    """The batch the server builds: rows padded to the bucket, the batch
    padded with repeats of its last row, prompts cut/padded to REFER."""
    full = group + [group[-1]] * (BATCH - len(group))
    ref = [r[4][:REFER] if len(r[4]) >= REFER else pad_to(r[4], REFER)
           for r in full]
    return [torch.from_numpy(a) for a in (
        np.stack([pad_to(r[1], t_bucket) for r in full]),
        np.array([len(r[1]) for r in full]), np.stack(ref),
        np.full(BATCH, REFER), np.stack([pad_to(r[2], t_bucket)
                                         for r in full]),
        np.stack([pad_to(r[3], t_bucket) for r in full]))]


def test_pick_bucket_and_pad_to():
    assert pick_bucket(8, (16, 8)) == 8 and pick_bucket(9, (8, 16)) == 16
    with pytest.raises(ValueError):
        pick_bucket(17, (8, 16))
    np.testing.assert_array_equal(pad_to(np.ones((2, 3)), 4),
                                  np.concatenate([np.ones((2, 3)),
                                                  np.zeros((2, 3))]))


def test_batch_synthesizer_buckets_and_order():
    _, cfg = tiny_configs()
    torch.manual_seed(0)
    from diff_vits_tpu_torch.models.diff_vits import DiffVits
    state = DiffVits(cfg, len(symbols), device="cpu").state_dict()
    syn = BatchSynthesizer(cfg, state, batch_size=BATCH, text_buckets=
                           TEXT_BUCKETS, refer_frames=REFER,
                           mel_buckets=(4, 1024), noise_scale=0.5,
                           dtype=torch.float32, device="cpu")
    reqs = _requests()
    by_text = {}
    for i, r in enumerate(reqs):
        by_text.setdefault(pick_bucket(len(r[1]), TEXT_BUCKETS), []).append(i)
    # the duration pass, as the server batches it; put the mel-bucket
    # boundary between the predicted lengths so both buckets are used
    predicted = {}
    with torch.no_grad():
        for t_bucket, idx in by_text.items():
            for off in range(0, len(idx), BATCH):
                chunk = idx[off:off + BATCH]
                lens = syn.model.vits.predict_lengths(
                    *_padded([reqs[i] for i in chunk], t_bucket))
                predicted.update({i: int(lens[j])
                                  for j, i in enumerate(chunk)})
    cut = sorted(predicted.values())[2]
    syn.mel_buckets = (cut, max(predicted.values()) + 8)
    results = syn.synthesize_all(reqs, seed=3)
    assert [r[0] for r in results] == [r[0] for r in reqs]

    groups = {}
    for t_bucket, idx in sorted(by_text.items()):
        for i in idx:
            m_bucket = pick_bucket(predicted[i], syn.mel_buckets)
            groups.setdefault((t_bucket, m_bucket), []).append(i)
    assert len({m for _, m in groups}) == 2
    for (t_bucket, m_bucket), idx in sorted(groups.items()):
        for off in range(0, len(idx), BATCH):
            chunk = idx[off:off + BATCH]
            fold = ((t_bucket * 131 + m_bucket) * 100003 + off) % 2 ** 31
            gen = torch.Generator().manual_seed(3 * 2 ** 31 + fold)
            mel, lens = synthesize(
                syn.model, *_padded([reqs[i] for i in chunk], t_bucket),
                generator=gen, noise_scale=0.5, max_len=m_bucket,
                device="cpu")
            for j, i in enumerate(chunk):
                assert int(lens[j]) == min(predicted[i], m_bucket)
                np.testing.assert_array_equal(
                    results[i][1], mel[j, :int(lens[j])].numpy())
