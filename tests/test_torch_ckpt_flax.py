"""The port writes the JAX package's checkpoints and resumes its trainer
states, without flax (``utils/msgpack_ckpt.pack``,
``train/checkpoint.save_flax_checkpoint``, ``Trainer.save_flax`` /
``Trainer.load``):

* ``pack`` is byte-identical to ``flax.serialization.msgpack_serialize``
  on a tree of float32, bfloat16, int32 and int64 arrays, 0-d arrays,
  numpy scalars, str, int, float, bool, None, empty and nested dicts
  (torch tensors written as the arrays they hold), and refuses a leaf
  flax would chunk (over 2^30 bytes) and what flax's tree is not;
* ``save_flax_checkpoint`` writes the bytes of JAX's ``save_checkpoint``;
* a JAX trainer state with a non-trivial ``opt_state`` (``tx.init`` and
  two ``tx.update``s of ``make_optimizer``'s optax.adamw on seeded
  gradients) written by JAX's ``save_checkpoint`` resumes in the port with
  exactly its parameters, ``exp_avg`` / ``exp_avg_sq`` / step and EMA, and
  one more update on the same gradients agrees with optax (rtol 1e-5,
  atol 1e-6, the standard of test_torch_trainer.py's optax test);
* the port's ``save_flax`` after two training steps is restored by JAX's
  ``load_checkpoint`` and ``serialization.from_state_dict`` against the
  JAX init's parameter tree and ``tx.init`` of it (what JAX's
  ``Trainer.load`` does), leaf for leaf, and JAX's next optax update on it
  agrees with the port's AdamW step on the same gradients.

The optax updates run on the leaves concatenated into one vector (adamw
is elementwise, so the update is that of the tree, and it compiles in a
second)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from flax.traverse_util import flatten_dict, unflatten_dict

from diff_vits_tpu.core.config import TrainConfig as JTrainConfig
from diff_vits_tpu.models.diff_vits import DiffVits as JDiffVits
from diff_vits_tpu.train import checkpoint as jckpt
from diff_vits_tpu.train import trainer as jtrainer
from diff_vits_tpu_torch.text.symbols import symbols
from diff_vits_tpu_torch.train import checkpoint
from diff_vits_tpu_torch.train.trainer import Trainer
from diff_vits_tpu_torch.utils import msgpack_ckpt
from diff_vits_tpu_torch.utils.convert import convert_tree, to_flax_params
from test_torch_common import flax_shapes, tiny_configs
from test_torch_trainer import _batch, _cfg

torch.set_num_threads(2)


def _tree():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "bf16": rng.normal(size=(2, 5)).astype(jnp.bfloat16),
        "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
        "i64": np.arange(-3, 3, dtype=np.int64),
        "zero_d": np.asarray(7), "zero_d_f": np.asarray(1.5, np.float32),
        "np_f32": np.float32(2.5), "np_i32": np.int32(-9),
        "np_bf16": np.asarray(0.75, jnp.bfloat16)[()],
        "np_bool": np.bool_(True),
        "str": "x" * 40, "short": "ab", "none": None, "t": True, "f": False,
        "float": 1.25e-300,
        "ints": {str(i): v for i, v in enumerate(
            [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63 + 5,
             -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1])},
        "empty": {}, "empty_array": np.zeros((0, 3), np.float32),
        "nested": {f"layer_{i}": {"kernel": np.full((2, 2), i, np.float32),
                                  "empty": {}} for i in range(18)},
        "big": np.zeros(300, np.float32),
    }


def test_pack_is_byte_identical_to_flax_msgpack_serialize():
    tree = _tree()
    want = serialization.msgpack_serialize(tree)
    assert msgpack_ckpt.pack(tree) == want
    # torch tensors write as the arrays they hold, bfloat16 included
    as_torch = dict(tree, f32=torch.from_numpy(tree["f32"]),
                    bf16=torch.from_numpy(np.asarray(
                        tree["bf16"], np.float32)).bfloat16())
    assert msgpack_ckpt.pack(as_torch) == want
    back = msgpack_ckpt.unpack(want)
    assert back["zero_d"].shape == () and back["np_i32"] == -9
    assert back["nested"]["layer_3"]["empty"] == {}


def test_pack_refuses_what_flax_chunks_and_what_is_no_flax_tree():
    huge = np.broadcast_to(np.float32(0), (2 ** 28 + 1,))   # no memory
    with pytest.raises(ValueError, match="2\\^30"):
        msgpack_ckpt.pack({"w": huge})
    with pytest.raises(TypeError, match="tuple"):
        msgpack_ckpt.pack({"w": (1, 2)})
    with pytest.raises(TypeError, match="not a str"):
        msgpack_ckpt.pack({1: 2})


def test_save_flax_checkpoint_writes_the_bytes_of_jax_save_checkpoint(
        tmp_path):
    tree = _tree()
    for step in (3, 5, 9):
        ours = checkpoint.save_flax_checkpoint(str(tmp_path / "port"), step,
                                               tree, keep=2)
        theirs = jckpt.save_checkpoint(str(tmp_path / "jax"), step, tree,
                                       keep=2)
        assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        ["model-5.ckpt", "model-9.ckpt"]


def _jcfg(cfg):
    """The JAX config of the tiny port config ``cfg``."""
    jcfg, _ = tiny_configs()
    return dataclasses.replace(
        jcfg, train=JTrainConfig(**dataclasses.asdict(cfg.train)))


def _flat(tree):
    return np.concatenate([np.asarray(v, np.float32).ravel()
                           for v in flatten_dict(tree).values()])


def _unflat(vec, like):
    """``vec`` cut into the leaves of ``like`` (flatten_dict order)."""
    out, i = {}, 0
    for path, v in flatten_dict(like).items():
        n = int(np.prod(v.shape))
        out[path] = np.asarray(vec[i:i + n]).reshape(v.shape)
        i += n
    return unflatten_dict(out)


def _adam_state(tx_state, like):
    """optax.adamw's state of the flat vector as the state of the tree
    ``like`` (what ``tx.init(tree)`` and its updates give)."""
    adam = tx_state[0]
    return (optax.ScaleByAdamState(count=adam.count,
                                   mu=_unflat(adam.mu, like),
                                   nu=_unflat(adam.nu, like)),
            *tx_state[1:])


def _step_fn(tx):
    @jax.jit
    def step(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state
    return step


def _port_update(trainer, grad_tree):
    """One AdamW step of ``trainer`` on the gradients ``grad_tree``."""
    grads = convert_tree(grad_tree)
    for n, p in trainer.model.named_parameters():
        p.grad = grads[n].clone()
    trainer.optimizer.step()


def _assert_params(trainer, tree, **tol):
    want = convert_tree(tree)
    for n, p in trainer.model.named_parameters():
        if tol:
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       err_msg=n, **tol)
        else:
            assert torch.equal(p.detach(), want[n]), n


def test_port_resumes_a_jax_trainer_state_and_steps_as_optax(tmp_path,
                                                              capsys):
    cfg = _cfg(use_ema=True, train_lr=1e-2, eps=1e-2)
    tr = Trainer(cfg, [], device="cpu")
    like = to_flax_params(tr.model)
    tx = jtrainer.make_optimizer(_jcfg(cfg))
    step = _step_fn(tx)
    rng = np.random.default_rng(3)
    params = jnp.asarray(_flat(like))
    opt_state = tx.init(params)
    grads = [jnp.asarray(rng.normal(size=params.shape).astype(np.float32))
             for _ in range(3)]
    ema = params
    for g in grads[:2]:
        params, opt_state = step(g, opt_state, params)
        ema = 0.9 * ema + 0.1 * params
    state = {"params": _unflat(params, like),
             "opt_state": _adam_state(opt_state, like),
             "ema_params": _unflat(ema, like)}
    path = jckpt.save_checkpoint(str(tmp_path), 2, state, keep=0)

    port = Trainer(cfg, [], device="cpu")
    port.load(path)
    out = capsys.readouterr().out
    assert f"resumed from {path} at step 2" in out
    assert "JAX trainer state" in out
    assert port.step == 2
    _assert_params(port, state["params"])
    mu, nu = (convert_tree(state["opt_state"][0].mu),
              convert_tree(state["opt_state"][0].nu))
    emas = convert_tree(state["ema_params"])
    for (n, p), e in zip(port.model.named_parameters(), port.ema):
        st = port.optimizer.state[p]
        assert torch.equal(st["exp_avg"], mu[n]), n
        assert torch.equal(st["exp_avg_sq"], nu[n]), n
        assert float(st["step"]) == 2.0
        assert torch.equal(e, emas[n]), n
        assert e.untyped_storage().data_ptr() != \
            p.untyped_storage().data_ptr()

    params, _ = step(grads[2], opt_state, params)
    _port_update(port, _unflat(grads[2], like))
    _assert_params(port, _unflat(params, like), rtol=1e-5, atol=1e-6)


def test_jax_restores_the_port_save_flax_and_steps_as_the_port(tmp_path):
    cfg = _cfg(use_ema=True, train_lr=1e-2, eps=1e-2)
    tr = Trainer(cfg, [], device="cpu", workdir=str(tmp_path))
    for seed in (1, 2):
        tr.train_step(_batch(seed))
    path = tr.save_flax(tr.step)

    step, saved = jckpt.load_checkpoint(path)
    jm = JDiffVits(_jcfg(cfg), n_vocab=len(symbols))
    b = _batch(1)
    template = flax_shapes(jm, *map(jnp.asarray, (
        b.text, b.text_lengths, b.spec, b.spec_lengths, b.refer1,
        b.refer1_lengths, b.tone, b.language)), rng=jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   template)
    tx = jtrainer.make_optimizer(_jcfg(cfg))
    params = serialization.from_state_dict(zeros, saved["params"])
    opt_state = serialization.from_state_dict(tx.init(zeros),
                                              saved["opt_state"])
    ema = serialization.from_state_dict(zeros, saved["ema_params"])
    assert step == 2 and int(opt_state[0].count) == 2
    assert np.asarray(opt_state[0].count).dtype == np.int32
    _assert_params(tr, params)
    mu, nu, emas = (convert_tree(opt_state[0].mu),
                    convert_tree(opt_state[0].nu), convert_tree(ema))
    for (n, p), e in zip(tr.model.named_parameters(), tr.ema):
        st = tr.optimizer.state[p]
        assert torch.equal(st["exp_avg"], mu[n]), n
        assert torch.equal(st["exp_avg_sq"], nu[n]), n
        assert torch.equal(e, emas[n]), n

    grads = np.random.default_rng(4).normal(
        size=_flat(params).shape).astype(np.float32)
    flat_state = (optax.ScaleByAdamState(
        count=opt_state[0].count, mu=jnp.asarray(_flat(opt_state[0].mu)),
        nu=jnp.asarray(_flat(opt_state[0].nu))), *opt_state[1:])
    new, _ = _step_fn(tx)(jnp.asarray(grads), flat_state,
                          jnp.asarray(_flat(params)))
    _port_update(tr, _unflat(grads, params))
    _assert_params(tr, _unflat(new, params), rtol=1e-5, atol=1e-6)


def test_save_flax_gives_zero_moments_to_a_parameter_without_a_step(
        tmp_path):
    cfg = _cfg(use_ema=False)
    tr = Trainer(cfg, [], device="cpu", workdir=str(tmp_path))
    path = tr.save_flax(0)
    step, state = checkpoint.load_checkpoint(path)
    assert step == 0 and set(state) == {"params", "opt_state"}
    adam = state["opt_state"]["0"]
    assert int(adam["count"]) == 0 and state["opt_state"]["1"] == {}
    assert all(not np.any(v) for v in flatten_dict(adam["mu"]).values())
    assert set(flatten_dict(adam["nu"])) == set(flatten_dict(state["params"]))
