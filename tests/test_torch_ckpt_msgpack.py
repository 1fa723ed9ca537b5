"""The port reads the JAX package's flax msgpack checkpoints without flax
(``utils/msgpack_ckpt``, ``train/checkpoint.load_checkpoint``):

* every msgpack type flax writes (each int and float width, str, bin,
  nil, bool, arrays and maps of each length class, ext types 1 and 3, the
  bfloat16 dtype name) decodes as ``msgpack`` + flax decode it;
* a tiny model's trainer state written by JAX's ``save_checkpoint``
  (params with one bfloat16 leaf, an optax AdamW state, the step) reads
  back leaf for leaf as ``flax.serialization.msgpack_restore`` reads it
  (the model it gives synthesizes as JAX's:
  tests/test_torch_ckpt_msgpack_model.py);
* ``Trainer.load`` resumes that state;
* a JAX vocoder ``.ckpt`` loads through ``load_vocoder`` and decodes
  within 1e-3 x max(1, max |wav|) of JAX's ``load_vocoder`` of it;
* a truncated file, a chunked leaf, an unknown ext type and a file in
  neither format are refused."""
import dataclasses

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from diff_vits_tpu.models import vocoder as jvoc
from diff_vits_tpu.train import checkpoint as jckpt
from diff_vits_tpu_torch.core.config import Config
from diff_vits_tpu_torch.models import vocoder
from diff_vits_tpu_torch.models.diff_vits import DiffVits
from diff_vits_tpu_torch.text.symbols import symbols
from diff_vits_tpu_torch.train import checkpoint
from diff_vits_tpu_torch.utils import msgpack_ckpt
from test_torch_common import tiny_configs
from test_torch_synthesize import tiny_models
from test_torch_vocoder import _mel, _published_state_dict

torch.set_num_threads(2)

# one value of each msgpack encoding class flax's packer can emit
VALUES = {
    "fixint": 5, "negative_fixint": -7, "uint8": 200, "uint16": 60000,
    "uint32": 2 ** 31, "uint64": 2 ** 63 + 5, "int8": -100,
    "int16": -30000, "int32": -2 ** 31, "int64": -2 ** 40,
    "float64": 1.25e-300, "nil": None, "true": True, "false": False,
    "fixstr": "abc", "str8": "x" * 40, "str16": "y" * 300,
    "bin8": b"\x00\x01", "bin16": b"z" * 300,
    "fixarray": [1, "a", None], "array16": list(range(20)),
    "map16": {str(i): i for i in range(20)},
    "nested": {"a": {"b": [1, {"c": 2.5}]}},
}


@pytest.mark.parametrize("name", sorted(VALUES))
def test_decodes_every_plain_type(name):
    blob = msgpack.packb({"v": VALUES[name]}, use_bin_type=True)
    got = msgpack_ckpt.unpack(blob)["v"]
    if isinstance(VALUES[name], bytes):
        got = bytes(got)
    assert got == VALUES[name]
    assert msgpack_ckpt.is_msgpack_map(blob)


def test_decodes_float32():
    blob = msgpack.packb({"v": 1.5}, use_single_float=True)
    assert blob[3] == 0xCA
    assert msgpack_ckpt.unpack(blob) == {"v": 1.5}


@pytest.mark.parametrize("dtype", ["float32", "float16", "int32", "int8",
                                   "uint8", "bool", "float64", "bfloat16"])
@pytest.mark.parametrize("shape", [(), (3,), (2, 3, 4), (0, 5)])
def test_arrays_and_scalars_decode_as_flax_does(dtype, shape):
    rng = np.random.default_rng(0)
    a = (rng.normal(size=shape) * 10).astype(
        jnp.bfloat16 if dtype == "bfloat16" else dtype)
    tree = {"array": a}
    if a.size:
        tree["scalar"] = a.reshape(-1)[0]      # an npscalar (ext type 3)
    blob = serialization.msgpack_serialize(tree)
    want = serialization.msgpack_restore(blob)
    got = msgpack_ckpt.unpack(blob)
    for k in tree:
        if dtype == "bfloat16":
            assert isinstance(got[k], torch.Tensor)
            assert got[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got[k].float().numpy(), np.asarray(want[k], np.float32))
        else:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
            np.testing.assert_array_equal(got[k], want[k])
            assert np.shape(got[k]) == np.shape(want[k])


def _trainer_state(tree):
    """A JAX trainer payload: params (one bias leaf in bfloat16), an optax
    AdamW state and EMA params, as JAX's ``Trainer.save`` builds it."""
    params = jax.tree_util.tree_map(np.asarray, tree)
    bias = params["vits"]["dp"]["pre"]["bias"]
    params["vits"]["dp"]["pre"]["bias"] = bias.astype(jnp.bfloat16)
    opt_state = optax.adamw(1e-3).init(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params))
    return {"params": params, "opt_state": opt_state, "ema_params": params}


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A trainer state of the tiny model written by JAX's save_checkpoint."""
    _, jparams, _ = tiny_models(seed=5)
    return jckpt.save_checkpoint(str(tmp_path_factory.mktemp("ckpt")), 1234,
                                 _trainer_state(jparams["params"]), keep=0)


def test_trainer_state_reads_back_as_flax_restores_it(jax_checkpoint):
    path = jax_checkpoint
    step, state = checkpoint.load_checkpoint(path)
    with open(path, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    assert step == 1234 == int(want["step"])
    # the step is a 0-d ndarray (ext type 1), not an npscalar
    assert np.asarray(want["step"]).shape == ()
    # optax's tuple states are maps keyed "0", "1", ...
    assert set(state["opt_state"]) == set(want["state"]["opt_state"]) \
        == {"0", "1", "2"}
    got = dict(jax.tree_util.tree_leaves_with_path(
        state, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    ref = dict(jax.tree_util.tree_leaves_with_path(want["state"]))
    assert set(got) == set(ref) and len(ref) > 100
    n_bf16 = 0
    for k, v in ref.items():
        if isinstance(got[k], torch.Tensor):
            n_bf16 += 1
            assert got[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          np.asarray(v, np.float32))
        else:
            assert got[k].dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(got[k], v)
    assert n_bf16 == 2     # params and ema_params


def test_jax_vocoder_checkpoint_loads_and_decodes_as_jax(tmp_path):
    params = jvoc.convert_torch_vocos(_published_state_dict(512, 1536, 8,
                                                           seed=7))
    path = jckpt.save_checkpoint(str(tmp_path), 3, {"params": params},
                                 keep=0)
    voc, vparams = jvoc.load_vocoder(Config(), path)
    port = vocoder.load_vocoder(Config(), path, device="cpu")
    mel = _mel(1, 16, seed=8)
    ref = np.asarray(voc.apply({"params": vparams}, jnp.asarray(mel)))
    with torch.no_grad():
        wav = port(torch.from_numpy(mel)).numpy()
    assert wav.shape == ref.shape == (1, 15 * 256)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(wav - ref).max())
    print(f"max |wav diff| = {err:.2e} (atol {1e-3 * scale:.2e})")
    np.testing.assert_allclose(wav, ref, atol=1e-3 * scale)


def test_refuses_truncated_and_unknown_files(tmp_path, jax_checkpoint):
    blob = open(jax_checkpoint, "rb").read()
    cut = tmp_path / "cut.ckpt"
    cut.write_bytes(blob[:len(blob) // 2])
    with pytest.raises(ValueError, match="truncated"):
        checkpoint.load_checkpoint(str(cut))
    other = tmp_path / "other.ckpt"
    other.write_bytes(b"\x00\x01not a checkpoint")
    with pytest.raises(ValueError, match="neither a torch.save"):
        checkpoint.load_checkpoint(str(other))
    with pytest.raises(ValueError, match="bytes after"):
        msgpack_ckpt.unpack(msgpack.packb({"a": 1}) + b"\x00")
    with pytest.raises(ValueError, match="ext type 2"):
        msgpack_ckpt.unpack(msgpack.packb({"a": msgpack.ExtType(2, b"xy")}))
    chunked = {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 1}}}
    with pytest.raises(ValueError, match="chunked"):
        msgpack_ckpt.unpack(msgpack.packb(chunked))
    no_state = tmp_path / "model-1.ckpt"
    no_state.write_bytes(msgpack.packb({"params": {}}))
    with pytest.raises(ValueError, match="not a checkpoint"):
        checkpoint.load_checkpoint(str(no_state))


def test_port_checkpoints_still_load(tmp_path):
    _, cfg = tiny_configs()
    model = DiffVits(cfg, len(symbols), device="cpu")
    path = checkpoint.save_checkpoint(str(tmp_path), 7,
                                      {"model": model.state_dict()})
    step, state = checkpoint.load_checkpoint(path)
    assert step == 7
    got = checkpoint.load_model_state_dict(path, cfg)
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v), k
    other = checkpoint.save_checkpoint(str(tmp_path), 8, {"other": 1})
    with pytest.raises(ValueError, match="neither 'model'"):
        checkpoint.load_model_state_dict(other, cfg)


def test_trainer_resumes_a_jax_trainer_state(jax_checkpoint):
    """``Trainer.load`` resumes the JAX trainer state: its params (the
    bfloat16 leaf widened exactly) and EMA through ``from_flax_params``,
    optax.adamw's moments and count as AdamW's state, its step; the same
    file still serves through ``load_model_state_dict``."""
    from diff_vits_tpu_torch.train.trainer import Trainer
    _, cfg = tiny_configs()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             use_ema=True))
    trainer = Trainer(cfg, [], device="cpu")
    trainer.load(jax_checkpoint)
    assert trainer.step == 1234
    sd = checkpoint.load_model_state_dict(jax_checkpoint, cfg)
    assert set(sd) == set(trainer.model.state_dict())
    bias = trainer.model.vits.dp.pre.bias
    assert torch.equal(bias, sd["vits.dp.pre.bias"])
    assert torch.equal(bias, bias.bfloat16().float())     # a widened bf16
    for (name, p), e in zip(trainer.model.named_parameters(), trainer.ema):
        assert torch.equal(p.detach(), sd[name]), name
        assert torch.equal(e, sd[name]), name
        st = trainer.optimizer.state[p]
        assert float(st["step"]) == 0.0
        assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()
