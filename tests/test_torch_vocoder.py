"""The port's Vocos (``models/vocoder``) against the JAX package's at
float32: ``istft`` on a random half-spectrum (and against torch.istft),
``ConvNeXtBlock`` and a narrow ``Vocos`` (dim 64, 2 layers) with the JAX
parameters carried by ``utils.convert.convert_tree``, the full-width
``Vocos`` (512 / 1536 / 8) on a 16-frame mel from a synthetic state dict in
the published torch layout (the port's ``convert_torch_vocos`` against the
JAX package's, waveforms within 1e-3 x max(1, max |wav|), the bound of
tests/test_vocoder.py), the converter's tree equal to the JAX one's, and
``load_vocoder``'s routes: a torch state dict, random weights from a
generator, a refused checkpoint of any other kind, no silent CPU path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.models import vocoder as jvoc
from diff_vits_tpu_torch.core.config import Config
from diff_vits_tpu_torch.models import vocoder
from diff_vits_tpu_torch.utils.convert import convert_tree
from test_torch_common import assert_close, fill, flax_shapes

torch.set_num_threads(2)


def _published_state_dict(dim, inter, n_layers, n_mels=100, n_fft=1024,
                          seed=0):
    """Random weights in charactr/vocos-mel-24khz's torch layout (numpy),
    scaled as tests/test_vocoder.py scales them, plus the non-parameter
    entries the published file also holds."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.02, base=0.0):
        return (base + rng.normal(size=shape) * scale).astype(np.float32)
    sd = {"backbone.embed.weight": r(dim, n_mels, 7, scale=0.05),
          "backbone.embed.bias": r(dim),
          "backbone.norm.weight": r(dim, base=1.0),
          "backbone.norm.bias": r(dim),
          "backbone.final_layer_norm.weight": r(dim, base=1.0),
          "backbone.final_layer_norm.bias": r(dim),
          "head.out.weight": r(n_fft + 2, dim),
          "head.out.bias": r(n_fft + 2),
          "head.istft.window": np.hanning(n_fft).astype(np.float32)}
    for i in range(n_layers):
        blk = f"backbone.convnext.{i}"
        sd.update({f"{blk}.dwconv.weight": r(dim, 1, 7, scale=0.05),
                   f"{blk}.dwconv.bias": r(dim),
                   f"{blk}.norm.weight": r(dim, base=1.0),
                   f"{blk}.norm.bias": r(dim),
                   f"{blk}.pwconv1.weight": r(inter, dim),
                   f"{blk}.pwconv1.bias": r(inter),
                   f"{blk}.pwconv2.weight": r(dim, inter),
                   f"{blk}.pwconv2.bias": r(dim),
                   f"{blk}.gamma": r(dim, scale=0.01, base=1.0 / 8)})
    return sd


def _as_torch(sd):
    """The numpy state dict as the torch tensors a checkpoint file holds."""
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _mel(b, t, seed=1):
    return np.random.default_rng(seed).normal(size=(b, t, 100)) \
        .astype(np.float32)


@pytest.mark.parametrize("length", [None, 5000])
def test_istft_matches_jax_and_torch(length):
    """A random half-spectrum [2, 40, 513] (the imaginary parts of DC and
    Nyquist included: both versions drop them)."""
    rng = np.random.default_rng(0)
    real = rng.normal(size=(2, 40, 513)).astype(np.float32)
    imag = rng.normal(size=(2, 40, 513)).astype(np.float32)
    ours = vocoder.istft(torch.from_numpy(real), torch.from_numpy(imag),
                         1024, 256, length=length)
    ref = np.asarray(jvoc.istft(jnp.asarray(real), jnp.asarray(imag), 1024,
                                256, length=length))
    assert ours.shape == ref.shape == (2, length or 39 * 256)
    assert_close(ours, ref, atol=1e-4)
    spec = torch.complex(torch.from_numpy(real), torch.from_numpy(imag))
    spec[..., 0].imag = 0
    spec[..., -1].imag = 0
    want = torch.istft(spec.transpose(1, 2), 1024, 256, 1024,
                       torch.hann_window(1024), center=True, length=length)
    assert_close(ours, want.numpy(), atol=1e-4)


def test_convnext_block_matches_jax():
    dim, inter = 32, 96
    jm = jvoc.ConvNeXtBlock(dim, inter)
    x = np.random.default_rng(2).normal(size=(2, 11, dim)).astype(np.float32)
    tree = fill(flax_shapes(jm, jnp.asarray(x)))
    assert tree["dwconv"]["kernel"].shape == (7, 1, dim)
    port = vocoder.ConvNeXtBlock(dim, inter)
    port.load_state_dict(convert_tree(tree), strict=True)
    assert port.dwconv.weight.shape == (dim, 1, 7)
    ref = jm.apply({"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        assert_close(port(torch.from_numpy(x)), ref, atol=1e-5)


def test_narrow_vocos_matches_jax():
    """dim 64, intermediate 192, 2 layers: every leaf of the flax tree
    lands in the port's state dict, and the waveforms agree."""
    kw = dict(dim=64, intermediate_dim=192, num_layers=2)
    jm = jvoc.Vocos(**kw)
    mel = _mel(2, 12)
    tree = fill(flax_shapes(jm, jnp.asarray(mel)), seed=3)
    port = vocoder.Vocos(**kw, device="cpu")
    sd = convert_tree(tree)
    assert set(sd) == set(port.state_dict())
    assert len(sd) == len(jax.tree_util.tree_leaves(tree))
    port.load_state_dict(sd, strict=True)
    ref = np.asarray(jm.apply({"params": tree}, jnp.asarray(mel)))
    with torch.no_grad():
        wav = port.eval()(torch.from_numpy(mel))
    assert wav.shape == ref.shape == (2, 11 * 256)
    assert wav.dtype == torch.float32
    scale = max(1.0, float(np.abs(ref).max()))
    assert_close(wav, ref, atol=1e-4 * scale)


def test_full_width_vocos_from_the_published_layout_matches_jax():
    """512 / 1536 / 8 on a 16-frame mel: the port loads the published
    state dict through its converter, JAX through its own."""
    sd = _published_state_dict(512, 1536, 8)
    mel = _mel(1, 16, seed=4)
    params = jvoc.convert_torch_vocos(sd)
    ref = np.asarray(jvoc.Vocos().apply({"params": params},
                                        jnp.asarray(mel)))
    port = vocoder.Vocos(device="cpu")
    port.load_state_dict(vocoder.convert_torch_vocos(_as_torch(sd)),
                         strict=True)
    with torch.no_grad():
        wav = port.eval()(torch.from_numpy(mel))
    assert wav.shape == ref.shape == (1, 15 * 256)
    assert bool(torch.isfinite(wav).all())
    scale = max(1.0, float(np.abs(ref).max()))
    assert_close(wav, ref, atol=1e-3 * scale)


@pytest.mark.parametrize("n_layers", [1, 3])
def test_convert_torch_vocos_equals_the_jax_conversion(n_layers):
    """Every ConvNeXt block the file holds, and no more."""
    sd = _published_state_dict(16, 48, n_layers, seed=5)
    want = convert_tree(jvoc.convert_torch_vocos(sd))
    got = vocoder.convert_torch_vocos(_as_torch(sd))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], v), k
    port = vocoder.Vocos(dim=16, intermediate_dim=48, num_layers=n_layers,
                         device="cpu")
    port.load_state_dict(got, strict=True)


def test_load_vocoder_routes(tmp_path, monkeypatch):
    """A .bin / .pt state dict in the published layout loads through the
    converter; no path gives seeded random weights; any other file is a
    checkpoint, and one in neither the torch nor the flax msgpack format
    is refused (the JAX package's msgpack checkpoint loads:
    tests/test_torch_ckpt_msgpack.py); no device and no card raises."""
    cfg = Config()
    sd = _published_state_dict(512, 1536, 8, seed=6)
    path = tmp_path / "pytorch_model.bin"
    torch.save(_as_torch(sd), path)
    voc = vocoder.load_vocoder(cfg, str(path), device="cpu")
    assert not voc.training
    assert all(p.dtype == torch.float32 and p.device.type == "cpu"
               for p in voc.parameters())
    for k, v in vocoder.convert_torch_vocos(_as_torch(sd)).items():
        assert torch.equal(voc.state_dict()[k], v), k

    a = vocoder.load_vocoder(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(3))
    b = vocoder.load_vocoder(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(3))
    c = vocoder.load_vocoder(cfg, device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                  b.parameters()))
    assert not torch.equal(a.out.weight, c.out.weight)
    assert a.embed.weight.shape == (512, cfg.data.n_mel_channels, 7)
    assert a.out.weight.shape == (cfg.data.window_size + 2, 512)

    (tmp_path / "model-100.ckpt").write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="neither a torch.save"):
        vocoder.load_vocoder(cfg, str(tmp_path / "model-100.ckpt"),
                             device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vocoder.load_vocoder(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vocoder.Vocos()
