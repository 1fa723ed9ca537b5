"""Predict what each rank holds when the port's Trainer shards model3's
state: the parameters, the two AdamW moments and the EMA (float32) that
``parallel.mesh.state_sharding_rules`` leave on a rank, at JAX's
``min_size`` (1 << 16), for the meshes of ``chip_smoke.py``'s shard phase
and ``fsdp`` 2 x ``model`` 2, with and without the MoE feed-forward.
Runs on the CPU (the model is built on the meta device).

Usage: python tools/torch_shard_predict.py [-c configs/reference_parity.json]
"""
import argparse
import dataclasses
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from diff_vits_tpu_torch.core.config import load_config  # noqa: E402
from diff_vits_tpu_torch.models.diff_vits import DiffVits  # noqa: E402
from diff_vits_tpu_torch.parallel import mesh  # noqa: E402
from diff_vits_tpu_torch.text.symbols import symbols  # noqa: E402
from diff_vits_tpu_torch.utils.convert import flax_leaves  # noqa: E402

MESHES = ((("data", "model"), (1, 2)), (("data", "fsdp"), (1, 2)),
          (("data", "expert"), (1, 2)), (("fsdp", "model"), (2, 2)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-c", "--config", default=str(
        Path(__file__).resolve().parents[1] / "configs"
        / "reference_parity.json"))
    cfg = load_config(ap.parse_args(argv).config)
    for experts in (0, 4):
        c = dataclasses.replace(cfg, diffusion_encoder=dataclasses.replace(
            cfg.diffusion_encoder, moe_experts=experts))
        model = DiffVits(c, len(symbols), device="meta")
        params = dict(model.named_parameters())
        leaves = {path: tuple(params[n].shape[d] for d in dims)
                  for n, (path, dims) in flax_leaves(model).items()}
        whole = sum(math.prod(s) for s in leaves.values())
        print(f"MoE experts {experts}: {len(leaves)} leaves, {whole} "
              f"parameters, whole state {16 * whole} B (params, 2 moments, "
              "EMA; float32)")
        for axes, shape in MESHES:
            m = dict(zip(axes, shape))
            specs = mesh.state_sharding_rules(m, leaves)
            held = sum(math.prod(leaves[p])
                       // math.prod(m[a] for a in s if a)
                       for p, s in specs.items())
            split = sum(any(s) for s in specs.values())
            print(f"  {m}: {split} leaves split; a rank holds {held} "
                  f"parameters, {16 * held} B = {16 * held / 1e9:.4f} GB, "
                  f"{held / whole:.4f} of the whole")


if __name__ == "__main__":
    main()
