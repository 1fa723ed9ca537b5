"""Rematerialisation of the port's training step (``train.remat_policy``,
``diff_vits_tpu_torch/nn/remat.py``) on the CPU.

* With dropout on (p 0.1 in the VITS encoders, 0.2 in the prompt
  encoders), a ``Trainer`` step under "dots" and under "full" gives the
  loss and the parameters of the "none" step (rtol 1e-5 / atol 1e-6).
* A region whose recompute does not replay its dropout generator draws
  other masks in the backward: that step differs from "none" (the check
  above would catch it).
* "full" keeps fewer activation bytes for the backward than "none".
* An unknown policy raises, as JAX's ``make_loss_fn`` does.
* Against JAX: the port's step under "dots" and JAX's ``make_train_step``
  under "dots" (``jax.checkpoint_policies.checkpoint_dots``) on the tiny
  configuration of ``tests/test_remat.py``, in the deterministic mode (no
  dropout, no posterior or MAS noise, injected t and noise), from the same
  parameters: equal metrics and parameters (rtol 1e-5 / atol 1e-6; lr
  1e-3 and eps 1e-2, so that the update depends on the gradient's value
  and float32 rounding of the gradient stays below the tolerance). The JAX
  step is compiled at XLA optimisation level 0 to stay well inside a
  minute; ``test_torch_remat_full.py`` does the same under "full".
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.core.config import (
    Config as JConfig, DataConfig as JData, DiffusionEncoderConfig as JDiff,
    TrainConfig as JTrain, VitsConfig as JVits)
from diff_vits_tpu.models.diff_vits import DiffVits as JDiffVits
from diff_vits_tpu.text.symbols import symbols as jsymbols
from diff_vits_tpu.train import trainer as jtrainer
from diff_vits_tpu_torch.core.config import (
    Config, DataConfig, DiffusionEncoderConfig, TrainConfig, VitsConfig)
from diff_vits_tpu_torch.data.batch import Batch
from diff_vits_tpu_torch.nn import remat
from diff_vits_tpu_torch.parallel import launch
from diff_vits_tpu_torch.train.trainer import Trainer
from diff_vits_tpu_torch.utils.convert import convert_tree, to_flax_params
from test_torch_trainer import _batch, _cfg

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _step(policy, batch):
    tr = Trainer(_cfg(remat_policy=policy), [], device="cpu")
    metrics = tr.train_step(batch)
    return ({k: float(v) for k, v in metrics.items()},
            [p.detach().clone() for p in tr.params])


@pytest.fixture(scope="module")
def none_step():
    return _step("none", _batch(0))


def _assert_same_step(a, b):
    assert set(a[0]) == set(b[0])
    for k in a[0]:
        np.testing.assert_allclose(a[0][k], b[0][k], rtol=RTOL, err_msg=k)
    for p, q in zip(a[1], b[1]):
        torch.testing.assert_close(p, q, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_policy_step_equals_the_none_step_with_dropout(policy, none_step):
    cfg = _cfg()
    assert cfg.vits.p_dropout > 0            # dropout draws in the regions
    _assert_same_step(_step(policy, _batch(0)), none_step)


def test_a_region_that_skips_the_generator_replay_differs(none_step,
                                                          monkeypatch):
    monkeypatch.setattr(remat, "_replaying", lambda fn, generator: fn)
    metrics, params = _step("full", _batch(0))
    assert max(float((p - q).abs().max())
               for p, q in zip(params, none_step[1])) > 100 * ATOL


def test_full_keeps_fewer_activation_bytes_than_none():
    b = _batch(1)

    def saved_bytes(policy):
        tr = Trainer(_cfg(remat_policy=policy), [], device="cpu")
        from diff_vits_tpu_torch.train.trainer import device_batch
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = tr.model(**device_batch(b, True, tr.device),
                               generator=tr.generator)
        loss.backward()
        return total[0]
    none, full = saved_bytes("none"), saved_bytes("full")
    print(f"bytes saved for the backward outside the regions: none {none}, "
          f"full {full}")
    assert full < none / 2


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown train.remat_policy"):
        Trainer(_cfg(remat_policy="dotz"), [], device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        remat.set_remat(torch.nn.Linear(2, 2), "everything")


# -- against JAX's make_train_step ------------------------------------------

def tiny(policy, duration_predictor="conv"):
    """(JAX Config, port Config): ``tests/test_remat.py``'s tiny
    configuration, lr 1e-3 and eps 1e-2, with the conv duration predictor
    by default (the UNet one more than doubles JAX's compile; its blocks'
    regions are held to "none" above)."""
    train = dict(train_batch_size=2, timesteps=20, compute_dtype="float32",
                 remat_policy=policy, train_lr=1e-3, eps=1e-2)
    data = dict(n_mel_channels=8, max_text_len=8, max_mel_len=16)
    diff = dict(in_channels=8, out_channels=8, hidden_channels=8, n_heads=2,
                block_out_channels=(8, 8), n_prompt_layers=1)
    vits = dict(inter_channels=8, hidden_channels=16, filter_channels=16,
                n_heads=2, n_layers=2, posterior_in_channels=8,
                posterior_n_layers=2, duration_predictor=duration_predictor)
    return (JConfig(train=JTrain(**train), data=JData(**data),
                    diffusion_encoder=JDiff(**diff), vits=JVits(**vits)),
            Config(train=TrainConfig(**train), data=DataConfig(**data),
                   diffusion_encoder=DiffusionEncoderConfig(**diff),
                   vits=VitsConfig(**vits)))


def tiny_batch(seed=0, t_x=6, t_y=16, s=8, text_lengths=(6, 4),
               spec_lengths=(16, 11)):
    """A port ``Batch`` (refer1 = refer2) and JAX's batch dict of it, one
    item for each length."""
    b = len(text_lengths)
    rng = np.random.default_rng(seed)
    keep = np.arange(t_x)[None] < np.asarray(text_lengths)[:, None]
    text = rng.integers(1, 50, (b, t_x)) * keep
    spec = rng.normal(size=(b, t_y, 8)).astype(np.float32)
    spec *= (np.arange(t_y)[None] < np.asarray(spec_lengths)[:, None]
             )[..., None]
    refer = rng.normal(size=(b, s, 8)).astype(np.float32)
    zeros = np.zeros((b, t_x), np.int64)
    port = Batch(text=text, tone=zeros, language=zeros, spec=spec,
                 refer1=refer, refer2=refer,
                 text_lengths=np.asarray(text_lengths),
                 spec_lengths=np.asarray(spec_lengths),
                 refer1_lengths=np.full(b, s), refer2_lengths=np.full(b, s))
    jax_batch = {
        "text": jnp.asarray(text, jnp.int32),
        "tone": jnp.asarray(zeros, jnp.int32),
        "language": jnp.asarray(zeros, jnp.int32),
        "spec": jnp.asarray(spec), "refer": jnp.asarray(refer),
        "text_lengths": jnp.asarray(text_lengths, jnp.int32),
        "spec_lengths": jnp.asarray(spec_lengths, jnp.int32),
        "refer_lengths": jnp.full(b, s, jnp.int32)}
    return port, jax_batch


def jax_step(jcfg, params, batch, t, noise):
    """JAX's ``make_train_step`` (the policy of ``jcfg`` applied by its
    ``make_loss_fn``) on a model whose ``apply`` takes the deterministic
    parity mode: injected t and noise, no rng. Returns (new params,
    metrics)."""
    model = JDiffVits(jcfg, n_vocab=len(jsymbols))

    class Injected:
        def apply(self, variables, *args, rng=None, mas_noise_scale=0.0,
                  deterministic=False, rngs=None):
            return model.apply(variables, *args, rng=None,
                               t=jnp.asarray(t), noise=jnp.asarray(noise),
                               deterministic=True)
    tx = jtrainer.make_optimizer(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = {"params": params, "opt_state": tx.init(params),
             "step": jnp.asarray(0, jnp.int32),
             "rng": jax.random.PRNGKey(0)}
    step = jax.jit(jtrainer.make_train_step(Injected(), tx, jcfg))
    compiled = step.lower(state, batch).compile(
        compiler_options={"xla_backend_optimization_level": "0"})
    new, metrics = compiled(state, batch)
    return new["params"], {k: float(v) for k, v in metrics.items()}


def check_against_jax(policy):
    jcfg, pcfg = tiny(policy)
    port_batch, jbatch = tiny_batch()
    rng = np.random.default_rng(1)
    t = np.array([3, 17])
    noise = rng.normal(size=(2, 16, 8)).astype(np.float32)
    start = to_flax_params(Trainer(pcfg, [], device="cpu").model)
    port, port_metrics = launch.train_step(pcfg, [port_batch],
                                           inject=[(t, noise)])
    ref, ref_metrics = jax_step(jcfg, start, jbatch, t, noise)
    assert set(port_metrics) == set(ref_metrics)
    for k in ref_metrics:
        np.testing.assert_allclose(port_metrics[k], ref_metrics[k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    ref, start = convert_tree(jax.device_get(ref)), convert_tree(start)
    assert set(ref) == set(port)
    moved = 0
    for name, a in port.items():
        np.testing.assert_allclose(a, ref[name].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        moved += not np.array_equal(a, start[name].numpy())
    assert moved > len(port) // 2


def test_dots_step_equals_jax_make_train_step():
    check_against_jax("dots")

