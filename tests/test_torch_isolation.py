"""The port stands alone: no JAX import anywhere in it or in
chip_smoke.py, no silent CPU path at its entry points, the same configs,
and a parameter conversion that consumes every leaf of the JAX model it
mirrors, the training-only posterior encoder included."""
import ast
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.core import config as jconfig
from diff_vits_tpu.models.diff_vits import DiffVits as JDiffVits
from diff_vits_tpu_torch.core import config as tconfig
from diff_vits_tpu_torch.models.diff_vits import DiffVits
from diff_vits_tpu_torch.text.symbols import symbols
from diff_vits_tpu_torch.utils.convert import from_flax_params
from test_torch_common import flax_shapes, tiny_configs

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "diff_vits_tpu")


def _port_files():
    return sorted((ROOT / "diff_vits_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_jax_package():
    files = _port_files()
    assert len(files) > 20
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imported(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_walk_covers_the_sequence_parallel_and_pipeline_modules():
    """The modules of sequence parallelism and the pipeline are in the
    walk above."""
    names = {f.relative_to(ROOT).as_posix() for f in _port_files()}
    assert {"diff_vits_tpu_torch/parallel/activations.py",
            "diff_vits_tpu_torch/parallel/ring_attention.py",
            "diff_vits_tpu_torch/parallel/pipeline.py"} <= names


def test_walk_covers_the_audio_modules():
    """The vocoder and the audio front end are in the walk above."""
    names = {f.relative_to(ROOT).as_posix() for f in _port_files()}
    assert {"diff_vits_tpu_torch/models/vocoder.py",
            "diff_vits_tpu_torch/ops/stft.py",
            "diff_vits_tpu_torch/data/audio.py"} <= names


def test_walk_covers_the_frontend_cli_and_checkpoint_modules():
    """The text frontend, the command lines, the samplers and the msgpack
    reader are in the walk above; the reader needs no msgpack package."""
    names = {f.relative_to(ROOT).as_posix() for f in _port_files()}
    assert {"diff_vits_tpu_torch/text/frontend.py",
            "diff_vits_tpu_torch/text/english_lts.py",
            "diff_vits_tpu_torch/text/pinyin_lexicon.py",
            "diff_vits_tpu_torch/text/tone_sandhi.py",
            "diff_vits_tpu_torch/infer/tts_infer.py",
            "diff_vits_tpu_torch/infer/serve.py",
            "diff_vits_tpu_torch/diffusion/dpm_solver.py",
            "diff_vits_tpu_torch/diffusion/schedule.py",
            "diff_vits_tpu_torch/utils/msgpack_ckpt.py"} <= names
    bad = [(f.relative_to(ROOT), m) for f in _port_files()
           for m in _imported(f) if m.split(".")[0] == "msgpack"]
    assert bad == []


def test_walk_covers_the_data_and_training_modules():
    """The datasets, the native loader (and its C++ source, a copy of the
    JAX package's), preprocessing, logging and the training command line
    are in the walk above."""
    names = {f.relative_to(ROOT).as_posix() for f in _port_files()}
    assert {"diff_vits_tpu_torch/data/dataset.py",
            "diff_vits_tpu_torch/data/native_loader.py",
            "diff_vits_tpu_torch/data/preprocess.py",
            "diff_vits_tpu_torch/data/aishell.py",
            "diff_vits_tpu_torch/utils/logging.py",
            "diff_vits_tpu_torch/train/cli.py"} <= names
    assert (ROOT / "diff_vits_tpu_torch" / "csrc" / "loader.cc").read_bytes() \
        == (ROOT / "csrc" / "loader.cc").read_bytes()


def test_walk_covers_the_sampler_library_and_utils_modules():
    """The whole sampler library and the f0, content and hparams helpers
    are in the walk above, and the content helper reaches for no
    ``transformers`` (its HuBERT loader is not ported)."""
    names = {f.relative_to(ROOT).as_posix() for f in _port_files()}
    assert {"diff_vits_tpu_torch/diffusion/noise_schedule.py",
            "diff_vits_tpu_torch/diffusion/dpm_solver.py",
            "diff_vits_tpu_torch/diffusion/uni_pc.py",
            "diff_vits_tpu_torch/utils/f0.py",
            "diff_vits_tpu_torch/utils/content.py",
            "diff_vits_tpu_torch/utils/hparams.py"} <= names
    bad = [(f.relative_to(ROOT), m) for f in _port_files()
           for m in _imported(f) if m.split(".")[0] == "transformers"]
    assert bad == []


def test_entry_points_raise_without_a_card(monkeypatch):
    from diff_vits_tpu_torch.infer.serve import BatchSynthesizer
    from diff_vits_tpu_torch.models.diff_vits import synthesize
    from diff_vits_tpu_torch.nn.unet1d import UNet1DConditionModel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = tiny_configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DiffVits(cfg, len(symbols))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UNet1DConditionModel(8, 4, (16, 16, 32, 32), cross_attention_dim=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchSynthesizer(cfg, {})
    model = DiffVits(cfg, len(symbols), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthesize(model, *([None] * 6))


@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.json")),
                         ids=lambda p: p.name)
def test_configs_load_equal_in_both_packages(path):
    theirs = jconfig.load_config(str(path))
    ours = tconfig.load_config(str(path))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert json.loads(json.dumps(ours.to_dict())) == json.loads(
        json.dumps(theirs.to_dict()))


@pytest.mark.parametrize("variant", [{}, dict(duration_predictor="sdp",
                                                use_flow=True),
                                     dict(duration_predictor="sdp",
                                          use_flow=True,
                                          use_phoneme_vae=True)],
                         ids=["model3", "sdp_flow", "bv2"])
def test_from_flax_params_consumes_every_leaf_but_the_skip_list(variant):
    """Against the whole JAX model tree, training parts included (the tree
    of the training forward, read with eval_shape; for the stochastic
    duration predictor it holds the posterior flows' ``post_*`` leaves):
    the skip list is empty, every leaf lands in the port's state dict."""
    jcfg, pcfg = tiny_configs()
    jcfg = dataclasses.replace(jcfg, vits=dataclasses.replace(jcfg.vits,
                                                              **variant))
    pcfg = dataclasses.replace(pcfg, vits=dataclasses.replace(pcfg.vits,
                                                              **variant))
    jm = JDiffVits(jcfg, n_vocab=len(symbols))
    b, tx, ty, s = 2, 7, 20, 11
    shapes = flax_shapes(
        jm, jnp.ones((b, tx), jnp.int32), jnp.array([7, 5]),
        jnp.zeros((b, ty, 100)), jnp.array([20, 15]),
        jnp.zeros((b, s, 100)), jnp.array([11, 9]),
        jnp.zeros((b, tx), jnp.int32), jnp.zeros((b, tx), jnp.int32),
        rng=jax.random.PRNGKey(2))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda sd: rng.normal(size=sd.shape).astype(np.float32), shapes)
    assert set(tree) == {"vits", "diff_model"}
    assert "enc_q" in tree["vits"]
    sd = from_flax_params(tree, pcfg)
    want = DiffVits(pcfg, len(symbols), device="cpu").state_dict()
    assert set(sd) == set(want)
    assert any(k.startswith("vits.enc_q.") for k in sd)
    for k, v in want.items():
        assert sd[k].shape == v.shape, k
    assert len(sd) == len(jax.tree_util.tree_leaves(tree))
    if variant.get("use_phoneme_vae"):
        assert {"ph_encoder_q", "phoneme_flow", "ph_enc_p"} == set(
            tree["vits"]["phoneme_vae"])
        assert any(k.startswith("vits.phoneme_vae.ph_enc_p.layer_3.")
                   for k in sd)
    if variant:
        assert {"post_pre", "post_flow_0"} <= set(tree["vits"]["dp"])
        assert "flow" in tree["vits"]
        # a depthwise Conv kernel [k, 1, C] -> grouped Conv1d [C, 1, k]
        dw = tree["vits"]["dp"]["convs"]["conv_sep_0"]["kernel"]
        np.testing.assert_array_equal(
            sd["vits.dp.convs.conv_sep_0.weight"].numpy(),
            dw.transpose(2, 1, 0))
    # Dense [in, out] -> Linear [out, in]; Conv [k, in, out] -> [out, in, k]
    dense = tree["vits"]["dp"]["pre"]["kernel"]
    np.testing.assert_array_equal(sd["vits.dp.pre.weight"].numpy(), dense.T)
    conv = tree["diff_model"]["unet"]["conv_in"]["kernel"]
    np.testing.assert_array_equal(sd["diff_model.unet.conv_in.weight"].numpy(),
                                  conv.transpose(2, 1, 0))


def test_from_flax_params_takes_the_phoneme_vae_tree():
    """The bv2 configuration, which the port refused before its phoneme
    VAE was ported, converts and loads strict: every VAE leaf lands."""
    jcfg, pcfg = tiny_configs()
    jcfg, pcfg = (dataclasses.replace(c, vits=dataclasses.replace(
        c.vits, use_phoneme_vae=True, n_flow_layer=2)) for c in (jcfg, pcfg))
    b, tx, ty = 2, 7, 20
    shapes = flax_shapes(
        JDiffVits(jcfg, n_vocab=len(symbols)), jnp.ones((b, tx), jnp.int32),
        jnp.array([7, 5]), jnp.zeros((b, ty, 100)), jnp.array([20, 15]),
        jnp.zeros((b, 11, 100)), jnp.array([11, 9]),
        jnp.zeros((b, tx), jnp.int32), jnp.zeros((b, tx), jnp.int32),
        rng=jax.random.PRNGKey(2))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes)
    model = DiffVits(pcfg, len(symbols), device="cpu")
    sd = from_flax_params(tree, pcfg)
    model.load_state_dict(sd, strict=True)
    vae = [k for k in sd if k.startswith("vits.phoneme_vae.")]
    assert len(vae) == len(jax.tree_util.tree_leaves(
        tree["vits"]["phoneme_vae"])) > 0


def test_walk_covers_the_parallel_modules():
    """The mesh and its rules, the expert rules, the state sharding and
    the rank functions are in the walk above; the rules are the port's own
    copy (JAX's hint lists written out, not imported)."""
    names = {f.relative_to(ROOT).as_posix() for f in _port_files()}
    assert {"diff_vits_tpu_torch/parallel/mesh.py",
            "diff_vits_tpu_torch/parallel/moe.py",
            "diff_vits_tpu_torch/parallel/sharding.py",
            "diff_vits_tpu_torch/parallel/launch.py"} <= names
    src = (ROOT / "diff_vits_tpu_torch" / "parallel" / "mesh.py").read_text()
    assert "_COLUMN_HINTS = (" in src and "_ROW_HINTS = (" in src
    assert "def expert_sharding_rules" in (
        ROOT / "diff_vits_tpu_torch" / "parallel" / "moe.py").read_text()


def test_walk_covers_the_checkpoint_bridge_and_phoneme_vae_modules():
    """The transplant, the converters and the phoneme VAE are in the walk
    above; the transplant is the port's own copy, not an import."""
    names = {f.relative_to(ROOT).as_posix() for f in _port_files()}
    assert {"diff_vits_tpu_torch/utils/transplant.py",
            "diff_vits_tpu_torch/utils/convert_checkpoint.py",
            "diff_vits_tpu_torch/utils/convert.py",
            "diff_vits_tpu_torch/utils/msgpack_ckpt.py",
            "diff_vits_tpu_torch/train/checkpoint.py",
            "diff_vits_tpu_torch/models/phoneme_vae.py"} <= names
    src = (ROOT / "diff_vits_tpu_torch" / "utils" / "transplant.py"
           ).read_text()
    assert "def diff_vits_params_from_config" in src


def test_walk_covers_the_modules_off_the_main_path():
    """The block zoo, LoRA and the functional SDPA are in the walk above,
    and every module this slice extended (masking, embeddings, layers,
    fairseq, the UNet's norms, the encoders, the converter, the trainer)
    still is."""
    names = {f.relative_to(ROOT).as_posix() for f in _port_files()}
    assert {"diff_vits_tpu_torch/nn/unet1d_blocks.py",
            "diff_vits_tpu_torch/nn/lora.py",
            "diff_vits_tpu_torch/ops/attention.py",
            "diff_vits_tpu_torch/core/masking.py",
            "diff_vits_tpu_torch/nn/embeddings.py",
            "diff_vits_tpu_torch/nn/layers.py",
            "diff_vits_tpu_torch/nn/fairseq.py",
            "diff_vits_tpu_torch/nn/unet1d.py",
            "diff_vits_tpu_torch/models/encoders.py",
            "diff_vits_tpu_torch/utils/convert.py",
            "diff_vits_tpu_torch/train/trainer.py"} <= names
