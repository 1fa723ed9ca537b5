"""The port's sharding rules (``parallel/mesh.py``, ``parallel/moe.py``)
against JAX's, leaf by leaf and axis by axis.

JAX's ``state_sharding_rules`` / ``expert_sharding_rules`` run on meshes
of the 8 virtual CPU devices (``tests/conftest.py``) over the params tree
of ``jax.eval_shape`` (no weights); the port's rules run on the flax
paths and flax-layout shapes of the port's ``DiffVits`` built on the meta
device (``utils.convert.flax_leaves``). Trees: the tiny configuration of
``test_torch_remat.py`` with ``min_size`` 0 (so that every leaf of 2 or
more dims is a candidate) and model3 (``configs/reference_parity.json``)
with JAX's default 1 << 16, each also with the MoE feed-forward (4
experts). Meshes: ``model``, ``fsdp``, ``fsdp`` x ``model``, ``expert``
(and experts over ``model`` when there is no ``expert`` axis), and
``fsdp_axis="seq"`` on a ``data`` x ``seq`` x ``model`` mesh. Also:
``make_mesh`` takes every axis JAX's ``Trainer`` takes and refuses
other names; the rank coordinates are ``create_device_mesh``'s.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from diff_vits_tpu.core.config import load_config as jload_config
from diff_vits_tpu.models.diff_vits import DiffVits as JDiffVits
from diff_vits_tpu.parallel import mesh as jmesh
from diff_vits_tpu.parallel import moe as jmoe
from diff_vits_tpu_torch.core.config import load_config
from diff_vits_tpu_torch.models.diff_vits import DiffVits
from diff_vits_tpu_torch.parallel import mesh, moe
from diff_vits_tpu_torch.text.symbols import symbols
from diff_vits_tpu_torch.utils.convert import flax_leaves
from test_torch_common import flax_shapes
from test_torch_remat import tiny

ROOT = Path(__file__).resolve().parents[1]


def _with_moe(cfg, experts):
    return dataclasses.replace(cfg, diffusion_encoder=dataclasses.replace(
        cfg.diffusion_encoder, moe_experts=experts))


def jax_tree(jcfg):
    """The JAX DiffVits params tree of ``jcfg`` as shapes."""
    b, tx, ty, s = 2, 7, 20, 11
    c = jcfg.data.n_mel_channels
    return flax_shapes(
        JDiffVits(jcfg, n_vocab=len(symbols)), jnp.ones((b, tx), jnp.int32),
        jnp.array([7, 5]), jnp.zeros((b, ty, c)), jnp.array([20, 15]),
        jnp.zeros((b, s, c)), jnp.array([11, 9]),
        jnp.zeros((b, tx), jnp.int32), jnp.zeros((b, tx), jnp.int32),
        rng=jax.random.PRNGKey(2))


def port_leaves(pcfg):
    """flax path -> flax shape of the port's DiffVits(pcfg), on meta."""
    model = DiffVits(pcfg, len(symbols), device="meta")
    params = dict(model.named_parameters())
    return {path: tuple(params[n].shape[d] for d in dims)
            for n, (path, dims) in flax_leaves(model).items()}


def jax_specs(shardings, shapes):
    """flax path -> JAX's spec, one entry a dim (PartitionSpec padded)."""
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    out = {}
    for keys, sh in flat:
        path = "/".join(str(getattr(k, "key", k)) for k in keys)
        spec = tuple(sh.spec)
        out[path] = spec + (None,) * (len(shapes[path]) - len(spec))
    return out


def jax_mesh(axes, shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)


@pytest.fixture(scope="module")
def trees():
    """{name: (JAX shapes tree, port leaves, min_size)}."""
    jt, pt = tiny("none")
    jm = jload_config(str(ROOT / "configs" / "reference_parity.json"))
    pm = load_config(str(ROOT / "configs" / "reference_parity.json"))
    out = {}
    for name, (jc, pc, min_size) in {
            "tiny": (jt, pt, 0), "tiny_moe": (_with_moe(jt, 4),
                                             _with_moe(pt, 4), 0),
            "model3": (jm, pm, 1 << 16),
            "model3_moe": (_with_moe(jm, 4), _with_moe(pm, 4), 1 << 16)
            }.items():
        out[name] = (jax_tree(jc), port_leaves(pc), min_size)
    return out


MESHES = {
    "model": (("data", "model"), (1, 2), "fsdp"),
    "fsdp": (("data", "fsdp"), (1, 2), "fsdp"),
    "fsdp_x_model": (("fsdp", "model"), (2, 2), "fsdp"),
    "expert": (("data", "expert"), (1, 2), "fsdp"),
    "expert_x_model": (("data", "model", "expert"), (1, 2, 2), "fsdp"),
    "fsdp_axis_seq": (("data", "seq", "model"), (2, 2, 2), "seq"),
}


@pytest.mark.parametrize("tree", ["tiny", "tiny_moe", "model3",
                                  "model3_moe"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_state_rules_equal_jax_leaf_by_leaf(trees, tree, mesh_name):
    shapes, leaves, min_size = trees[tree]
    axes, shape, fsdp_axis = MESHES[mesh_name]
    flat_shapes = {"/".join(str(getattr(k, "key", k)) for k in keys): s.shape
                   for keys, s in jax.tree_util.tree_flatten_with_path(
                       shapes)[0]}
    assert flat_shapes == leaves
    want = jax_specs(jmesh.state_sharding_rules(
        jax_mesh(axes, shape), shapes, min_size=min_size,
        fsdp_axis=fsdp_axis), flat_shapes)
    got = mesh.state_sharding_rules(dict(zip(axes, shape)), leaves,
                                    min_size=min_size, fsdp_axis=fsdp_axis)
    assert got == want
    split = [p for p, s in got.items() if any(s)]
    # an expert axis splits the MoE leaves only
    assert bool(split) == (mesh_name != "expert" or "moe" in tree)
    if "moe" in tree and "expert" in mesh_name:
        assert any(got[p][0] == "expert" for p in got if "ff_moe" in p)


@pytest.mark.parametrize("tree", ["tiny_moe", "model3_moe"])
@pytest.mark.parametrize("size", [2, 4])
def test_expert_rules_equal_jax(trees, tree, size):
    shapes, leaves, _ = trees[tree]
    flat_shapes = {"/".join(str(getattr(k, "key", k)) for k in keys): s.shape
                   for keys, s in jax.tree_util.tree_flatten_with_path(
                       shapes)[0]}
    want = jax_specs(jmoe.expert_sharding_rules(
        jax_mesh(("expert",), (size,)), shapes), flat_shapes)
    got = moe.expert_sharding_rules({"expert": size}, leaves)
    assert got == want
    assert sum(s[0] == "expert" for s in got.values() if s) >= 4


def test_fsdp_rules_of_the_jax_tests():
    """``tests/test_ring_attention.py``'s FSDP cases, through the port."""
    m = {"data": 2, "fsdp": 4}
    got = mesh.state_sharding_rules(
        m, {"big/kernel": (256, 512), "tiny/kernel": (4, 4),
            "odd/kernel": (7, 13), "x/kernel": (7, 8)}, min_size=0)
    assert got == {"big/kernel": ("fsdp", None), "tiny/kernel": ("fsdp",
                                                                 None),
                   "odd/kernel": (None, None), "x/kernel": (None, "fsdp")}
    got = mesh.state_sharding_rules({"data": 2, "fsdp": 2, "model": 2},
                                    {"attn/to_q/kernel": (64, 64)},
                                    min_size=0)
    assert got == {"attn/to_q/kernel": ("fsdp", "model")}


@pytest.mark.parametrize("axes,shape,world,want", [
    (("data", "fsdp", "model", "expert", "seq"), (1, 2, 2, 1, 1), 4,
     {"data": 1, "fsdp": 2, "model": 2, "expert": 1, "seq": 1}),
    (("data", "model"), (1, 2), 2, {"data": 1, "model": 2}),
    (("data", "expert"), (2, 2), 2, {"data": 2, "expert": 1}),
    (("data", "seq"), (1, 2), 1, {"data": 1, "seq": 1}),
])
def test_make_mesh_takes_every_jax_trainer_axis(axes, shape, world, want):
    assert mesh.make_mesh(shape, axes, world=world) == want


@pytest.mark.parametrize("axes", [("data", "pipe"), ("data", "data")])
def test_make_mesh_refuses_other_names(axes):
    with pytest.raises(ValueError, match="mesh axes"):
        mesh.make_mesh((1, 1), axes, world=1)


def test_rank_coordinates_are_create_device_mesh_s():
    axes, shape = ("data", "fsdp", "model"), (2, 2, 2)
    jm = jax_mesh(axes, shape)
    m = dict(zip(axes, shape))
    for idx, dev in np.ndenumerate(jm.devices):
        c = mesh.coords(m, dev.id)
        assert tuple(c[a] for a in axes) == idx
        # rows go over data (major) and fsdp (minor); model shares them
        assert mesh.data_index(m, dev.id) == idx[0] * 2 + idx[1]
    assert mesh.data_size(m) == 4


def test_flax_leaves_walk_is_convert_s_layout():
    """The walk's dims turn each port leaf into the flax leaf that
    ``to_flax_params`` writes."""
    from diff_vits_tpu_torch.utils.convert import to_flax_params
    _, pcfg = tiny("none")
    model = DiffVits(pcfg, len(symbols), device="cpu")
    tree = to_flax_params(model)
    params = dict(model.named_parameters())
    for name, (path, dims) in flax_leaves(model).items():
        node = tree
        for k in path.split("/"):
            node = node[k]
        want = params[name].detach().permute(*dims).numpy()
        np.testing.assert_array_equal(node, want, err_msg=name)
