"""Tensor parallelism of the port's ``Trainer`` over a ``model`` axis of
two gloo ranks on the CPU (``parallel.sharding``, spawned by
``parallel.launch.run_ranks``), one optimizer step on the global batch of
``test_torch_dp.py`` (4 items, unequal halves) at the tiny configuration
of ``test_torch_remat.py`` with EMA on and the sharding rules' ``min_size``
at 0, so that every site of the tiny model is split:

* the ranks' step equals one process's step on the whole batch, with the
  dropout, posterior, MAS and diffusion noise that process draws (the
  ranks share rows; each draws the global batch's tensors and keeps its
  rows; the FFN's dropout inside a split site draws the whole width);
* in the deterministic mode (no dropout or noise, injected t) it equals
  JAX's ``make_train_step`` on the whole batch from the same parameters;
* every rank holds exactly the shard JAX's ``state_sharding_rules`` give
  it, of every parameter, AdamW moment and EMA leaf, and its held bytes
  are their sum; the split sites run on their shards.

Parameters within rtol 1e-5 / atol 1e-6. ``test_torch_shard_fsdp.py``,
``test_torch_shard_ep.py`` and ``test_torch_shard_composite.py`` run the
same checks over ``fsdp``, ``expert`` and ``fsdp`` x ``model``.
"""
import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest
import torch

from diff_vits_tpu.parallel import mesh as jmesh
from diff_vits_tpu_torch.models.diff_vits import DiffVits
from diff_vits_tpu_torch.parallel import launch
from diff_vits_tpu_torch.text.symbols import symbols
from diff_vits_tpu_torch.train.trainer import Trainer
from diff_vits_tpu_torch.utils.convert import (
    convert_tree, flax_leaves, to_flax_params)
from test_torch_dp import (
    SPEC_LENGTHS, TEXT_LENGTHS, assert_metrics_equal, assert_params_equal)
from test_torch_remat import jax_step, tiny, tiny_batch
from test_torch_shard_rules import jax_mesh, jax_tree

torch.set_num_threads(2)


def configs(axes, shape, moe=0, policy="none"):
    """(JAX Config, port Config): the tiny pair, batch 4, EMA, the mesh,
    ``moe`` experts in the denoiser's transformer blocks, the remat
    ``policy``."""
    jcfg, pcfg = tiny(policy)
    out = []
    for c in (jcfg, pcfg):
        train = dict(train_batch_size=4, use_ema=True)
        if c is pcfg:
            train.update(mesh_axes=axes, mesh_shape=shape)
        out.append(dataclasses.replace(
            c, train=dataclasses.replace(c.train, **train),
            diffusion_encoder=dataclasses.replace(c.diffusion_encoder,
                                                  moe_experts=moe)))
    return tuple(out)


def expected_shapes(jcfg, pcfg, axes, shape):
    """Port parameter name -> (the local shape JAX's
    ``state_sharding_rules`` (min_size 0) give each rank of the mesh, the
    whole shape)."""
    tree = jax_tree(jcfg)
    specs = jmesh.state_sharding_rules(jax_mesh(axes, shape), tree,
                                       min_size=0)
    flat = {"/".join(str(getattr(k, "key", k)) for k in keys): sh.spec
            for keys, sh in jax.tree_util.tree_flatten_with_path(specs)[0]}
    sizes = dict(zip(axes, shape))
    model = DiffVits(pcfg, len(symbols), device="meta")
    params = dict(model.named_parameters())
    out = {}
    for name, (path, dims) in flax_leaves(model).items():
        local = list(params[name].shape)
        for i, a in enumerate(flat[path]):
            if a is not None:
                local[dims[i]] //= sizes[a]
        out[name] = tuple(local), tuple(params[name].shape)
    return out


def run(axes, shape, moe=0, extra=()):
    """Every number the checks compare for one mesh; ``extra`` meshes (of
    as many ranks; (axes, shape) or (axes, shape, remat policy)) take the
    step with the one process's draws in the same ranks
    (``numbers["extra"]``: each one's rank results)."""
    jcfg, pcfg = configs(axes, shape, moe)
    port_batch, jbatch = tiny_batch(seed=0, text_lengths=TEXT_LENGTHS,
                                    spec_lengths=SPEC_LENGTHS)
    rng = np.random.default_rng(9)
    t = np.array([3, 17, 9, 12])
    noise = rng.normal(size=(4, 16, 8)).astype(np.float32)
    start = to_flax_params(Trainer(pcfg, [], device="cpu").model)
    # JAX compiles its step while the ranks run
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_ref = pool.submit(jax_step, jcfg, start, jbatch, t, noise)
        ranks = launch.run_ranks(launch.calls, int(np.prod(shape)), [
            (launch.train_step, (pcfg, [port_batch], "cpu", None, 0, True)),
            (launch.train_step, (pcfg, [port_batch], "cpu", [(t, noise)],
                                 0))] + [
            (launch.train_step, (configs(*x[:2], moe, *x[2:])[1],
                                 [port_batch], "cpu", None, 0, True))
            for x in extra])
        single = launch.train_step(pcfg, [port_batch])
        ref, ref_metrics = jax_ref.result()
    return dict(ranks=[r[:2] for r in ranks], single=single,
                extra=[[r[2 + i] for r in ranks] for i in range(len(extra))],
                start=convert_tree(start),
                jax=(convert_tree(ref), ref_metrics),
                shapes=expected_shapes(jcfg, pcfg, axes, shape))


def check_ranks_equal_one_process(numbers, ranks=None):
    """The ranks' step with the one process's draws (``ranks``: each
    rank's ``train_step`` result, default the main mesh's) equals that
    process's step; every rank ends with the same whole parameters."""
    params, metrics = numbers["single"]
    ranks = ranks or [draws for draws, _ in numbers["ranks"]]
    assert_params_equal(ranks[0][0], params, numbers["start"])
    assert_metrics_equal(ranks[0][1], metrics)
    for draws in ranks[1:]:
        for name, a in ranks[0][0].items():
            np.testing.assert_array_equal(a, draws[0][name], err_msg=name)


def check_parity_ranks_equal_jax(numbers):
    ref, ref_metrics = numbers["jax"]
    for _, parity in numbers["ranks"]:
        assert_params_equal(parity[0], ref, numbers["start"])
        assert_metrics_equal(parity[1], ref_metrics)


def check_each_rank_holds_its_shard(numbers, sites):
    """Shapes of every held tensor against JAX's rules, the held bytes
    their sum, and the sites that ran on their shards."""
    want = numbers["shapes"]
    assert any(local != whole for local, whole in want.values())
    for (_, _, info), _ in numbers["ranks"]:
        assert set(info["shapes"]) == set(want)
        total = 0
        for name, shapes in info["shapes"].items():
            assert set(shapes) >= {"param", "ema"}, name
            for kind, s in shapes.items():
                assert s == want[name][0], (name, kind, s, want[name])
                total += 4 * int(np.prod(s))
        assert info["held_bytes"] == total
        assert set(info["sites"]) == sites


@pytest.fixture(scope="module")
def numbers():
    return run(("data", "model"), (1, 2))


def test_tp_step_equals_one_process(numbers):
    check_ranks_equal_one_process(numbers)


def test_tp_step_equals_jax_global_step(numbers):
    check_parity_ranks_equal_jax(numbers)


def test_tp_ranks_hold_their_shards(numbers):
    check_each_rank_holds_its_shard(numbers, {
        "CrossAttention", "GEGLUFeedForward", "EncSALayer",
        "TransformerFFNLayer"})
