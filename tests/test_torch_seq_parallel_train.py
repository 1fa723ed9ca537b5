"""One training step under sequence parallelism, as JAX's
``tests/test_seq_parallel.py`` runs it: eight gloo ranks on the CPU on a
``data`` 2 x ``seq`` 2 x ``model`` 2 mesh, ZeRO-3 scattered over ``seq``
(``Trainer(fsdp_axis="seq", sequence_parallel=True)``, the sharding
rules' ``min_size`` 0), on ``__graft_entry__._tiny_config()`` (its batch
of two, T=48 mel frames: each ``seq`` rank runs 24 of them through the
diffusion UNet; everything else runs whole on both) with lr 1e-3 and
AdamW eps 1e-2, so that one step moves each parameter in proportion to its
gradient (at eps 1e-9 the first step is lr times the gradient's sign,
which turns rounding into whole steps).

* In the deterministic mode (injected t and noise, no dropout) the ranks'
  loss is JAX's single-device loss on the same parameters (the loss its
  ``make_train_step`` reports) within rel 1e-4, and their parameters
  after the step are the port's one process's within rtol 1e-5 /
  atol 1e-6;
* with the one process's draws (each rank draws the whole batch's noise
  and keeps its rows; the UNet cuts its frames) the same;
* the ranks hold seq shards of the state.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from diff_vits_tpu.models.diff_vits import DiffVits as JDiffVits
from diff_vits_tpu.text.symbols import symbols as jsymbols
from diff_vits_tpu_torch.core import config as tconfig
from diff_vits_tpu_torch.data.batch import Batch
from diff_vits_tpu_torch.parallel import launch
from diff_vits_tpu_torch.train.trainer import Trainer
from diff_vits_tpu_torch.utils.convert import convert_tree, to_flax_params
from test_torch_dp import assert_metrics_equal, assert_params_equal

torch.set_num_threads(2)

AXES, SHAPE = ("data", "seq", "model"), (2, 2, 2)


def port_config(jcfg, **train):
    """The port's Config with the fields of the JAX one, ``train``
    replaced."""
    parts = {f.name: getattr(tconfig, type(getattr(jcfg, f.name)).__name__)(
        **dataclasses.asdict(getattr(jcfg, f.name)))
        for f in dataclasses.fields(jcfg)}
    parts["train"] = dataclasses.replace(parts["train"], **train)
    return tconfig.Config(**parts)


def batch():
    b = ge._tiny_batch()
    return Batch(text=b["text"], text_lengths=b["text_lengths"],
                 spec=b["spec"], spec_lengths=b["spec_lengths"],
                 refer1=b["refer"], refer1_lengths=b["refer_lengths"],
                 refer2=b["refer"], refer2_lengths=b["refer_lengths"],
                 tone=b["tone"], language=b["language"])


def jax_loss(jcfg, params, t, noise):
    """JAX's single-device training loss (deterministic mode)."""
    b = ge._tiny_batch()
    model = JDiffVits(jcfg, n_vocab=len(jsymbols))

    def loss(p):
        return model.apply(
            {"params": p}, b["text"], b["text_lengths"], b["spec"],
            b["spec_lengths"], b["refer"], b["refer_lengths"], b["tone"],
            b["language"], rng=None, t=jnp.asarray(t),
            noise=jnp.asarray(noise), deterministic=True)[0]
    params = jax.tree_util.tree_map(jnp.asarray, params)
    fn = jax.jit(loss).lower(params).compile(
        compiler_options={"xla_backend_optimization_level": "0"})
    return float(fn(params))


@pytest.fixture(scope="module")
def numbers():
    jcfg = ge._tiny_config()
    one = port_config(jcfg, train_lr=1e-3, eps=1e-2)
    cfg = dataclasses.replace(one, train=dataclasses.replace(
        one.train, mesh_axes=AXES, mesh_shape=SHAPE))
    t = np.array([3, 17])
    noise = np.random.default_rng(0).normal(size=(2, 48, 32)).astype(
        np.float32)
    start = to_flax_params(Trainer(one, [], device="cpu").model)
    sp = dict(fsdp_axis="seq", seq_parallel=True)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(jax_loss, jcfg, start, t, noise)
        ranks = launch.run_ranks(launch.calls, 8, [
            (launch.train_step, (cfg, [batch()], "cpu", [(t, noise)], 0),
             sp),
            (launch.train_step, (cfg, [batch()], "cpu", None, 0, True), sp)],
            timeout=240)
        single = [launch.train_step(one, [batch()], "cpu", [(t, noise)]),
                  launch.train_step(one, [batch()], "cpu")]
        jloss = ref.result()
    return dict(ranks=ranks, single=single, jax_loss=jloss,
                start=convert_tree(start))


def test_seq_parallel_step_loss_matches_jax(numbers):
    for parity, _ in numbers["ranks"]:
        np.testing.assert_allclose(parity[1]["loss/all"],
                                   numbers["jax_loss"], rtol=1e-4)


@pytest.mark.parametrize("mode", [0, 1], ids=["parity", "draws"])
def test_seq_parallel_step_equals_one_process(numbers, mode):
    params, metrics = numbers["single"][mode]
    for r in numbers["ranks"]:
        got = r[mode][:2]
        assert_params_equal(got[0], params, numbers["start"])
        assert_metrics_equal(got[1], metrics)


def test_ranks_hold_seq_shards(numbers):
    for _, (_, _, info) in numbers["ranks"]:
        split = [n for n, s in info["shapes"].items()
                 if s["param"] != numbers["start"][n].shape]
        assert len(split) > len(info["shapes"]) // 4
        assert info["sites"]        # model-parallel sites on their heads
