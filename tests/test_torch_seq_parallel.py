"""The diffusion UNet under ``parallel.activations.sequence_parallel`` on
two gloo ranks on the CPU (``parallel.launch.seq_unet``), against the JAX
package's UNet run unsharded: ``tests/test_seq_parallel.py``'s widths
(block_out (16, 16, 32, 32), 8 groups, 2 heads) and inputs (b=2, 12
context frames with a random keep mask). T=48 splits 24 + 24 frames;
T=56 splits 32 + 24 (boundaries on multiples of 8, the last shard
shorter). Each rank runs its frames through the halo convs, the merged
GroupNorms and the ring self-attention; the gathered output matches JAX
within rtol 2e-4 / atol 2e-5, in eval mode (the fused ops' plain routes
with ``seq=``) and in training mode (the modules' own route). The
backward (sum(out * w)) summed over the ranks matches the port's one
process within 1e-4 of each gradient's largest magnitude, for every
parameter and the input. The same on eight ranks of a ``data`` 2 x
``seq`` 2 x ``model`` 2 mesh (T=56, training mode). A T that gives a
rank no frame is refused; the scope is a no-op without a ``seq`` axis of
more than one rank.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_vits_tpu.nn.unet1d import UNet1DConditionModel as JUNet
from diff_vits_tpu_torch.parallel import activations, launch
from diff_vits_tpu_torch.parallel.activations import SeqShard
from diff_vits_tpu_torch.parallel.sharding import Group
from diff_vits_tpu_torch.utils.convert import convert_tree
from test_torch_common import fill, flax_shapes, to_jax

torch.set_num_threads(2)

KW = dict(in_channels=16, out_channels=8, block_out_channels=(16, 16, 32, 32),
          layers_per_block=1, norm_num_groups=8, cross_attention_dim=16,
          attention_head_dim=2)
CASES = [(48, False), (48, True), (56, False), (56, True)]
MESH3_AXES, MESH3_SHAPE = ("data", "seq", "model"), (2, 2, 2)


def inputs(t):
    rng = np.random.default_rng(0)
    b, s, c = 2, 12, 16
    x = rng.normal(size=(b, t, c)).astype(np.float32)
    ctx = rng.normal(size=(b, s, 16)).astype(np.float32)
    smask = rng.integers(0, 2, (b, s)).astype(np.int32)
    smask[:, 0] = 1
    return x, np.array([3.0, 7.0], np.float32), ctx, smask


def weights(t):
    return np.random.default_rng(1).normal(size=(2, t, 8)).astype(np.float32)


def close(got, want, scale=1.0):
    err = np.abs(got - want).max()
    assert err <= scale * max(1.0, np.abs(want).max()), err


@pytest.fixture(scope="module")
def numbers():
    jm = JUNet(**KW)
    x, ts, ctx, keep = inputs(48)
    tree = fill(flax_shapes(jm, *map(jnp.asarray, (x, ts, ctx, keep))),
                seed=3)
    sd = convert_tree(tree)
    jobs = [(launch.seq_unet, (sd, KW, inputs(t), weights(t), train))
            for t, train in CASES]
    ranks = launch.run_ranks(launch.calls, 2, jobs, timeout=120)
    mesh3 = launch.run_ranks(launch.seq_unet, 8, *jobs[-1][1], MESH3_AXES,
                             MESH3_SHAPE, timeout=120)
    one = launch.calls(jobs)
    apply = jax.jit(jm.apply)
    ref = {t: np.asarray(apply(to_jax(tree), *map(jnp.asarray, inputs(t))))
           for t in (48, 56)}
    return dict(ranks=ranks, one=one, jax=ref, mesh3=mesh3)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_unet_seq_sharded_matches_jax_unsharded(numbers, case):
    t, _ = CASES[case]
    for rank in numbers["ranks"]:
        out = rank[case]["out"]
        assert out.shape == (2, t, 8)
        np.testing.assert_allclose(out, numbers["jax"][t], rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_unet_seq_sharded_backward_matches_one_process(numbers, case):
    one = numbers["one"][case]
    np.testing.assert_allclose(one["out"], numbers["jax"][CASES[case][0]],
                               rtol=2e-4, atol=2e-5)
    for rank in numbers["ranks"]:
        got = rank[case]
        assert set(got["grads"]) == set(one["grads"])
        for name, g in one["grads"].items():
            close(got["grads"][name], g, 1e-4)
        close(got["dx"], one["dx"], 1e-4)


def test_unet_on_a_data_seq_model_mesh_matches_jax_and_one_process(
        numbers):
    one = numbers["one"][-1]
    for got in numbers["mesh3"]:
        np.testing.assert_allclose(got["out"], numbers["jax"][56],
                                   rtol=2e-4, atol=2e-5)
        for name, g in one["grads"].items():
            close(got["grads"][name], g, 1e-4)
        close(got["dx"], one["dx"], 1e-4)


def test_shards_fall_on_multiples_of_eight_and_refuse_an_empty_rank():
    two = Group(("seq",), None, 2, 1, [0, 1])
    assert SeqShard(two, 56, 4).bounds[0] == [(0, 32), (32, 56)]
    assert SeqShard(two, 56, 4).bounds[3] == [(0, 4), (4, 7)]
    assert SeqShard(two, 48, 4).bounds[0] == [(0, 24), (24, 48)]
    with pytest.raises(ValueError):
        SeqShard(Group(("seq",), None, 4, 0, [0, 1, 2, 3]), 20, 4)


def test_scope_is_a_no_op_without_seq_ranks():
    """JAX's rule: nothing is sharded unless a mesh with a ``seq`` axis of
    more than one rank is active (here no process group: one rank)."""
    x = torch.ones(2, 48, 4)
    with activations.sequence_parallel({"data": 1, "seq": 2}):
        assert activations.seq_group() is None
        assert activations.constrain_seq(x) is x
        assert activations.shard(48, 4) is None
    with activations.sequence_parallel(None):
        assert activations.constrain_seq(x) is x
    with pytest.raises(ValueError, match="no 'seq' axis"):
        activations.enable_sequence_parallel({"data": 2})
    activations.disable_sequence_parallel()
    assert activations.seq_group() is None
