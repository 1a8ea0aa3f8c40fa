"""ViT relevancy maps through the port's ``models/vit.relevancy_fused_block2``.

The inputs are ``pool_batches`` batches of ``batch`` images (normal
pixels, the normalised range) and target classes, drawn on the device from
the seed; batch i explains pool entry i mod ``pool_batches``. Targets are
given, so no argmax decides a map. A batch's record is its maps on the
host, copied there right behind the batch's kernels (``loop.Posted``).

The configuration's ``precision`` has to be the fp32 contract, the only one
the reference's limits and its control are set for: fp32 tensors,
``fast_dots`` off, TF32 off. Anything else raises before a run.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.core import judge, loop, seeds
from portbench.flops import vit as flops
from portbench.reference import vit as ref


def port_config(cfg: Dict):
    from transformer_mm_explainability_tpu_torch.models import vit
    return vit.ViTConfig(
        image_size=cfg["image_size"], patch_size=cfg["patch_size"],
        width=cfg["hidden_size"], depth=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        mlp_ratio=cfg["intermediate_size"] // cfg["hidden_size"],
        num_classes=cfg["num_classes"], ln_eps=cfg["layer_norm_eps"])


def port_model(cfg: Dict, w: Dict[str, torch.Tensor], device):
    """The port's ``ViT`` holding copies of the benchmark's weights."""
    from transformer_mm_explainability_tpu_torch.models import vit
    model = vit.ViT(port_config(cfg), device)
    top = {"patch_w": "patch_w", "patch_b": "patch_b", "cls_token": "cls",
           "pos_embed": "pos", "norm_scale": "norm_scale",
           "norm_bias": "norm_bias", "head_w": "head_w", "head_b": "head_b"}
    with torch.no_grad():
        for name, key in top.items():
            getattr(model, name).copy_(w[key].view_as(getattr(model, name)))
        for l, blk in enumerate(model.blocks):
            for name, p in blk.named_parameters():
                p.copy_(w[f"{l}.{name}"])
    return model


FP32 = {"dtype": "float32", "tf32": False, "fast_dots": False}


def check_precision(cfg: Dict) -> None:
    """Raises unless the configuration states the fp32 contract that the
    drivers run and the limits were set for."""
    if cfg.get("precision") != FP32:
        raise ValueError(
            f"configuration {cfg['name']!r} states precision "
            f"{cfg.get('precision')!r}; the drivers, the reference's limits "
            f"and the control are for {FP32!r} only")


class Explain:
    unit = "maps"

    def __init__(self, cfg, mix, seed, device, control: bool = False):
        check_precision(cfg)
        self.cfg, self.seed, self.device = cfg, seed, device
        B, P, size = mix["batch"], mix["pool_batches"], cfg["image_size"]
        self.batch_units, self.pool = B, P
        self.images = torch.randn(
            (P, B, size, size, 3), device=device,
            generator=seeds.generator(seed, "images", device))
        self.targets = torch.randint(
            0, cfg["num_classes"], (P, B), device=device,
            generator=seeds.generator(seed, "targets", device))
        w = ref.weights(cfg, seed, device)
        if control:
            self.call = lambda im, t: ref.relevancy(w, cfg, im, t, tf32=True)
        else:
            from transformer_mm_explainability_tpu_torch.models import vit
            model = port_model(cfg, w, device)
            del w
            self.call = lambda im, t: vit.relevancy_fused_block2(model, im, t)

    def submit(self, i: int):
        p = i % self.pool
        return p, loop.Posted(self.call(self.images[p], self.targets[p]))

    def settle(self, handle):
        p, posted = handle
        (maps,) = posted.get()
        return p, maps

    def release(self) -> None:
        self.call = None

    def judge(self, kept) -> Dict[str, float]:
        """``map_err``: the largest max|Δ| / max|ref| of a kept map."""
        w = ref.weights(self.cfg, self.seed, self.device)
        refs = {p: ref.relevancy(w, self.cfg, self.images[p],
                                 self.targets[p]).cpu().numpy()
                for p in sorted({p for _, (p, _) in kept})}
        return {"map_err": max(judge.row_err(maps, refs[p])
                               for _, (p, maps) in kept)}

    def flops_per_unit(self) -> float:
        return flops.explain_per_map(self.cfg)


TASKS = {"explain": Explain}
