"""Multi-rank relevancy evaluation on the port: the scaling example.

    python -m transformer_mm_explainability_tpu_torch.examples.sharded_relevancy \\
        [--devices N] [--batch 16] [--fused]

Counterpart of the repo-root ``examples/sharded_relevancy.py``. It starts
one rank per card over NCCL (``parallel/launch.RankPool``), builds a (dp,
tp) mesh (``parallel/mesh.make_mesh``), and computes the relevancy maps of
one batch on it: by default the plain ``models/vit.relevancy`` on
tensor-parallel weights (``shard_params``: heads and the MLP split over
tp, one all-reduce per residual branch) with the batch split over dp;
with ``--fused``, ``relevancy_fused`` (the attention kernels #7 and #8 on
the card) on replicated weights through ``dp_shard_map``, each rank on its
local batch. The maps come back whole on every rank.

``--devices N`` runs N spawned CPU ranks over gloo instead, the
counterpart of the JAX example's forced N-device virtual CPU mesh, with a
tiny ViT (width 64, 2 layers, 4 heads); on the cards the model is
ViT-B/16 with random weights.

The reference's DDP bring-up (VisualBERT/mmf/utils/distributed.py:221-251,
DETR/util/misc.py:406-426) shards only the batch; here the weights shard
too.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from transformer_mm_explainability_tpu_torch.models import vit
from transformer_mm_explainability_tpu_torch.parallel import mesh as pmesh

TINY = vit.ViTConfig(image_size=32, patch_size=8, width=64, depth=2,
                     num_heads=4, mlp_ratio=4, num_classes=16)


# the paths run tensor-parallel on shard_params' weights; the others (the
# kernel paths) run on replicated weights, each rank on its local batch
TP_PATHS = ("relevancy", "relevancy_streamed_row")


def place(model: vit.ViT, mesh, path: str = "relevancy") -> vit.ViT:
    """This rank's weights for ``path``: ``shard_params(model)`` for
    ``TP_PATHS``, else ``replicated(model)``."""
    return (pmesh.shard_params(model, mesh) if path in TP_PATHS
            else pmesh.replicated(model, mesh))


def sharded_maps(model: vit.ViT, images: torch.Tensor,
                 targets: torch.Tensor, mesh, path: str = "relevancy"
                 ) -> torch.Tensor:
    """The ``[B, S-1]`` maps of ``models/vit.<path>`` for the whole batch,
    whole on every rank: the batch split over dp through ``dp_shard_map``,
    on ``place(model, mesh, path)``'s weights."""
    return pmesh.dp_shard_map(getattr(vit, path), mesh)(
        place(model, mesh, path), images, targets)


def run(mesh, cfg: vit.ViTConfig, batch: int, path: str) -> dict:
    """One rank's part: seeded weights placed once, a seeded batch, one warm
    call and one timed call of ``path`` through ``dp_shard_map``."""
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    model = vit.init_params(0, cfg, device)
    dp = pmesh.axis_size(mesh, "dp")
    B = batch - batch % dp or dp
    rng = np.random.RandomState(0)
    images = torch.as_tensor(rng.randn(B, cfg.image_size, cfg.image_size, 3)
                             .astype(np.float32), device=device)
    targets = torch.as_tensor(rng.randint(0, cfg.num_classes, (B,)),
                              device=device)
    params = place(model, mesh, path)
    call = pmesh.dp_shard_map(getattr(vit, path), mesh)
    call(params, images, targets)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    maps = call(params, images, targets)
    checksum = float(maps.abs().sum())      # waits for the device
    return {"maps": maps, "seconds": time.perf_counter() - t0,
            "checksum": checksum, "dp": dp,
            "tp": pmesh.axis_size(mesh, "tp")}


def main(argv=None) -> int:
    from transformer_mm_explainability_tpu_torch._device import resolve_device
    from transformer_mm_explainability_tpu_torch.parallel.launch import (
        MeshArg, RankPool)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="N spawned CPU ranks over gloo (default: one rank "
                         "per card over NCCL)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--fused", action="store_true",
                    help="relevancy_fused (the attention kernels) through "
                         "dp_shard_map")
    args = ap.parse_args(argv)
    if args.devices:
        world, backend, device, cfg = args.devices, "gloo", "cpu", TINY
        kind = "cpu"
    else:
        resolve_device("cuda")
        world, backend, device = torch.cuda.device_count(), "nccl", "cuda"
        cfg, kind = vit.VIT_B_16, torch.cuda.get_device_name(0)
    with RankPool(world, backend, device, timeout_s=600) as pool:
        outs = pool.run(run, MeshArg(), cfg, args.batch,
                        "relevancy_fused" if args.fused else "relevancy")
    first = outs[0]
    maps = first["maps"]
    print(f"{world} rank(s) ({kind}, {backend}); mesh dp={first['dp']} "
          f"tp={first['tp']}")
    for out in outs[1:]:
        if not torch.equal(out["maps"], maps):
            print("ranks returned different maps")
            return 1
    B = maps.shape[0]
    print(f"relevancy maps: {tuple(maps.shape)} whole on every rank; {B} "
          f"maps in {first['seconds'] * 1e3:.1f} ms "
          f"({B / first['seconds']:.0f} maps/s), checksum "
          f"{first['checksum']:.4e}")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
