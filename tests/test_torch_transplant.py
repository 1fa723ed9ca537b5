"""The reference's checkpoints in the port: ``utils/transplant`` (the
port's copy) against the JAX package's, and the converters' command lines.

The repository holds no reference checkpoint, so the state dicts are
synthetic, in the reference's layout: ``chip_smoke.reference_state_dict``
drives a transplant module with its helpers replaced by recorders, which
gives each flax leaf's reference key and layout, and fills those keys
from a flax tree (``module.`` prefixes, the posterior encoder's WN layers
as ``weight_g`` / ``weight_v``). On that dict:

* tiny widths: both transplants give bitwise equal trees, equal to the
  JAX ``DiffVits`` training init's tree in structure and shapes, and to
  the filled tree bitwise but for the weight-normed leaves (rel 1e-6);
  ``from_flax_params`` of it loads strict into the port's ``DiffVits``;
* ``reference_parity`` widths (shapes from ``jax.eval_shape``, zero-stride
  arrays, nothing filled): both transplants read the same key set, every
  key of the dict, and give the JAX init's tree;
* ``utils.convert.main`` and ``utils.convert_checkpoint.convert`` write
  the port's params-only checkpoint, equal bitwise to what the JAX CLI
  writes from the same ``.pt``, and print the converted line;
* a tree the reference cannot hold (an FFN conv's tap 0, the bv2 VAE) is
  refused by the helper."""
import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import chip_smoke
from diff_vits_tpu.core.config import load_config as jload_config
from diff_vits_tpu.models.diff_vits import DiffVits as JDiffVits
from diff_vits_tpu.utils import convert as jconvert
from diff_vits_tpu.utils import transplant as jtp
from diff_vits_tpu_torch.core.config import load_config
from diff_vits_tpu_torch.models.diff_vits import DiffVits
from diff_vits_tpu_torch.text.symbols import symbols
from diff_vits_tpu_torch.train import checkpoint
from diff_vits_tpu_torch.utils import convert, convert_checkpoint
from diff_vits_tpu_torch.utils import transplant as ptp
from diff_vits_tpu_torch.utils.convert import from_flax_params
from test_torch_common import fill, flax_shapes, tiny_configs

torch.set_num_threads(2)

WN = "vits.enc_q.enc."
CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _shapes(jcfg):
    jm = JDiffVits(jcfg, n_vocab=len(symbols))
    b, tx, ty, s = 2, 7, 20, 11
    return flax_shapes(
        jm, jnp.ones((b, tx), jnp.int32), jnp.array([7, 5]),
        jnp.zeros((b, ty, 100)), jnp.array([20, 15]),
        jnp.zeros((b, s, 100)), jnp.array([11, 9]),
        jnp.zeros((b, tx), jnp.int32), jnp.zeros((b, tx), jnp.int32),
        rng=jax.random.PRNGKey(2))


def _zero_ffn_tap0(tree):
    """The reference has no weight for tap 0 of an EncSALayer's FFN conv
    (transplant.ffn1_conv_params)."""
    flat = flatten_dict(tree)
    for path, v in flat.items():
        if path[-2:] == ("ffn_1", "kernel"):
            v[0] = 0.0
    return tree


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, filled tree, reference-layout dict)."""
    jcfg, pcfg = tiny_configs()
    tree = _zero_ffn_tap0(fill(_shapes(jcfg), seed=4))
    return jcfg, pcfg, tree, chip_smoke.reference_state_dict(tree, jcfg,
                                                             tp=jtp)


def test_port_transplant_is_bitwise_jax_on_a_reference_layout_dict(tiny):
    jcfg, pcfg, tree, ref = tiny
    assert all(k.startswith("module.") for k in ref)
    assert any(k.endswith(".weight_g") for k in ref)
    state = {k.removeprefix("module."): v for k, v in ref.items()}
    want = flatten_dict(jtp.diff_vits_params_from_config(state, jcfg))
    got = flatten_dict(ptp.diff_vits_params_from_config(state, pcfg))
    assert set(got) == set(want) == set(flatten_dict(tree))
    n_wn = 0
    for path, v in flatten_dict(tree).items():
        assert got[path].dtype == want[path].dtype == np.float32
        np.testing.assert_array_equal(got[path], want[path])
        if ".".join(path).startswith(WN):
            n_wn += 1
            np.testing.assert_allclose(got[path], v, rtol=1e-6,
                                       atol=1e-6 * np.abs(v).max())
        else:
            np.testing.assert_array_equal(got[path], v)
    assert n_wn > 0
    model = DiffVits(pcfg, len(symbols), device="cpu")
    model.load_state_dict(from_flax_params(
        ptp.diff_vits_params_from_config(state, pcfg), pcfg), strict=True)


def test_both_transplants_read_the_same_keys_at_reference_parity_widths(
        monkeypatch):
    path = CONFIGS / "reference_parity.json"
    jcfg, pcfg = jload_config(str(path)), load_config(str(path))
    shapes = _shapes(jcfg)
    tree = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    with np.errstate(all="ignore"):
        ref = chip_smoke.reference_state_dict(tree, jcfg, tp=jtp, prefix="",
                                              as_tensors=False)
    trees = {}
    for name, tp, cfg in (("jax", jtp, jcfg), ("port", ptp, pcfg)):
        read = []

        def get(state, key, read=read):
            read.append(key)
            return state[key]
        monkeypatch.setattr(tp, "_get", get)
        with np.errstate(all="ignore"):
            trees[name] = flatten_dict(tp.diff_vits_params_from_config(ref,
                                                                       cfg))
        trees[name + "_read"] = read
    assert trees["jax_read"] == trees["port_read"]
    assert set(trees["port_read"]) == set(ref)
    assert len(ref) > 1500
    want = {p: s.shape for p, s in flatten_dict(shapes).items()}
    for name in ("jax", "port"):
        assert {p: v.shape for p, v in trees[name].items()} == want


def test_convert_cli_writes_what_the_jax_cli_writes(tiny, tmp_path,
                                                    monkeypatch, capsys):
    jcfg, pcfg, tree, ref = tiny
    pt = tmp_path / "model-123.pt"
    torch.save({"step": 123, "model": ref}, pt)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(pcfg.to_dict()))
    path = convert.main(["--ref_ckpt", str(pt), "-c", str(cfg_path),
                         "--out_dir", str(tmp_path / "port")])
    out = capsys.readouterr().out
    got = checkpoint.load_model_state_dict(path, pcfg)
    n = sum(v.numel() for v in got.values())
    assert f"converted {pt} (step 123, {n / 1e6:.1f}M params) -> {path}" \
        in out
    step, state = checkpoint.load_checkpoint(path)
    assert step == 123 and set(state) == {"model"}

    monkeypatch.setattr(sys, "argv", [
        "convert", "--ref_ckpt", str(pt), "-c", str(cfg_path),
        "--out_dir", str(tmp_path / "jax")])
    jconvert.main()
    jpath = tmp_path / "jax" / "model-123.ckpt"
    want = checkpoint.load_model_state_dict(str(jpath), pcfg)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k

    seeded = from_flax_params(tree, pcfg)
    for k, v in seeded.items():
        if k.startswith(WN):
            torch.testing.assert_close(got[k], v, rtol=1e-6,
                                       atol=1e-6 * float(v.abs().max()))
        else:
            assert torch.equal(got[k], v), k

    other = convert_checkpoint.convert(str(pt), str(tmp_path / "other"),
                                       pcfg)
    assert f"converted {pt} (step 123) -> {other}" in capsys.readouterr().out
    again = checkpoint.load_model_state_dict(other, pcfg)
    assert all(torch.equal(again[k], v) for k, v in got.items())


def test_the_helper_refuses_what_the_reference_cannot_hold(tiny):
    jcfg, pcfg, tree, _ = tiny
    bad = jax.tree_util.tree_map(np.copy, tree)
    flatten_dict(bad)[("vits", "o_proj", "layer_0", "ffn", "ffn_1",
                       "kernel")][0] = 1.0
    with pytest.raises(ValueError, match="tap 0"):
        chip_smoke.reference_state_dict(bad, jcfg)
    bv2 = dataclasses.replace(jcfg, vits=dataclasses.replace(
        jcfg.vits, use_phoneme_vae=True))
    with pytest.raises(ValueError, match="reads no reference key"):
        chip_smoke.reference_state_dict(
            _zero_ffn_tap0(fill(_shapes(bv2), seed=1)), bv2)
