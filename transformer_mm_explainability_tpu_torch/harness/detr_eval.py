"""DETR explanation-segmentation evaluation loop (engine.evaluate's
--masks path), in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/harness/detr_eval.py``:
drives ``data/coco.CocoDetection`` through ``harness/detr_segm.
explain_image`` and scores with the COCOeval-faithful evaluator
(``harness/coco_eval``, the reference protocol's pycocotools
``CocoEvaluator``, DETR/engine.py:153-216; ``iou_thresholds`` lets the
band be lowered).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from transformer_mm_explainability_tpu_torch.data.coco import (
    CocoDetection,
    eval_ground_truths,
)
from transformer_mm_explainability_tpu_torch.harness import detr_segm
from transformer_mm_explainability_tpu_torch.harness.coco_eval import CocoEval
from transformer_mm_explainability_tpu_torch.models import detr as detr_model
from transformer_mm_explainability_tpu_torch.ops import image as img_ops


def prepare_image(raw: np.ndarray, shortest: int = 800,
                  longest: int = 1333, size_divisor: int = 32,
                  device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """DETR val preprocessing of an RGB uint8 ``[H, W, 3]`` image on
    ``device``: resize the shortest edge (bilinear, the longest capped),
    ImageNet-normalise, pad bottom / right to a multiple of
    ``size_divisor``. Returns ``(padded image, valid mask)``."""
    img = torch.from_numpy(np.array(raw, np.float32)).to(device) / 255.0
    img = img_ops.resize_shortest_edge(img, shortest, longest)
    img = img_ops.normalize(img, img_ops.IMAGENET_MEAN, img_ops.IMAGENET_STD)
    h, w = img.shape[:2]
    ph = (h + size_divisor - 1) // size_divisor * size_divisor
    pw = (w + size_divisor - 1) // size_divisor * size_divisor
    return img_ops.pad_to(img, ph, pw)


def nearest_index(n_out: int, n_in: int) -> np.ndarray:
    """Source index of each of ``n_out`` outputs of a nearest resize from
    ``n_in``: ``floor((i + 0.5) · n_in / n_out)``, as ``jax.image.resize``
    'nearest' (``np.round(x − 0.5)`` would round exact ties down a pixel)."""
    return np.clip(np.floor((np.arange(n_out) + 0.5) * n_in / n_out)
                   .astype(np.int64), 0, n_in - 1)


def evaluate(
    params,
    dataset: CocoDetection,
    cfg: detr_model.DETRConfig = detr_model.DETR_R50,
    segm_cfg: detr_segm.SegmConfig = detr_segm.SegmConfig(),
    max_images: Optional[int] = None,
    shortest: int = 800,
    iou_thresholds: Optional[np.ndarray] = None,
    printer=print,
) -> Dict[str, float]:
    """Per image: preprocess → detect → batched per-query relevancy → Otsu
    masks → COCOeval-faithful scoring, on the device that holds
    ``params``. Returns the 12-stat dict."""
    device = params["input_proj"]["w"].device
    evaluator = CocoEval(iou_type="segm", iou_thrs=iou_thresholds)
    ids = dataset.image_ids[:max_images]
    for n, image_id in enumerate(ids):
        raw = dataset.load_image(image_id)
        img, valid = prepare_image(raw, shortest, device=device)
        out = detr_segm.explain_image(params, img, cfg, segm_cfg,
                                      pad_valid=valid, pack_masks=True)
        H, W = raw.shape[:2]
        # GT masks are rasterised at the original size: crop the padded
        # grid to the resized image and resize the masks back on the host
        scale = shortest / min(H, W)
        if max(H, W) * scale > 1333:
            scale = 1333 / max(H, W)
        rh, rw = int(round(H * scale)), int(round(W * scale))
        dense = detr_segm.unpack_mask_bits(out["masks_packed"],
                                           out["mask_hw"][1])[:, :rh, :rw]
        yi, xi = nearest_index(H, rh), nearest_index(W, rw)
        pred_masks = dense[:, yi[:, None], xi[None, :]]
        # evaluator-side GT: non-crowd AND crowd annotations (crowds
        # become ignore regions in CocoEval)
        gts = []
        for entry in eval_ground_truths(dataset, image_id):
            gts.append({"category_id": int(entry["category_id"]),
                        "iscrowd": entry["iscrowd"],
                        "area": float(entry["area"]),
                        "mask": entry.get("mask",
                                          np.zeros((H, W), np.uint8))})
        dts = [{"category_id": int(c), "score": float(s), "mask": m}
               for c, s, m in zip(out["classes"], out["scores"],
                                  pred_masks)]
        evaluator.add_image(gts, dts, image_id=int(image_id))
        if (n + 1) % 50 == 0:
            printer(f"[{n + 1}/{len(ids)}] images explained")
    evaluator.accumulate()
    stats = evaluator.summarize()
    printer(f"segm AP: {stats['AP']:.4f}  AP50: {stats['AP50']:.4f}  "
            f"AP75: {stats['AP75']:.4f}")
    return stats
