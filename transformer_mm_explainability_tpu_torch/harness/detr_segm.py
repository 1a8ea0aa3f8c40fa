"""DETR segmentation-from-explanation harness, in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/harness/detr_segm.py``
(DETR/mask_generator.py + engine.evaluate's segm path): run DETR, keep the
detections whose max softmax confidence exceeds the threshold
(mask_generator.py:50-51), explain every kept query with the chosen method
(all of them from one forward and one K-batched backward,
``explain/detr.generate``), min-max → Otsu-binarise each row at the encoder
feature resolution (:116-121), upsample to the image (PostProcessSegm's
bilinear + 0.5 threshold, models/segmentation.py:218-243), and score
against ground-truth instance masks.

The JAX package's compile caches (``_forward_jit``, ``_generate_jit``,
``_masks_jit``) and its compiled-memory probe (``MEM_PROBE``) have no
counterpart: the port calls the functions directly, the detection forward
under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from transformer_mm_explainability_tpu_torch.explain import detr as expl_detr
from transformer_mm_explainability_tpu_torch.models import detr as detr_model
from transformer_mm_explainability_tpu_torch.ops.image import resize_linear
from transformer_mm_explainability_tpu_torch.ops.otsu import otsu_binarize


@dataclasses.dataclass(frozen=True)
class SegmConfig:
    confidence_threshold: float = 0.5
    # the reference explains EVERY conf>0.5 query of the 100
    # (mask_generator.py:50-51); the cap bounds one image's work
    max_detections: int = 100
    method: str = "ours_no_lrp"
    # crowded images are explained in passes of ≤ this many queries: the
    # gradient taps are [L, K, H, S, S], 139 MB per query at the
    # protocol's S = 850. Each pass shares one forward
    # (models/detr.capture_multi). The JAX package also pads K up to a
    # bucket to bound its compiled shapes; eager PyTorch has none, so
    # every pass explains exactly its kept queries.
    max_queries_per_pass: int = 32


def keep_detections(pred_logits: np.ndarray, threshold: float,
                    max_keep: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Queries whose max non-background softmax probability exceeds
    ``threshold`` (mask_generator.py:50-51), by descending score (numpy's
    ``argsort(-scores)``), padded to ``max_keep``.
    Returns ``(query_idx [K], class_idx [K], valid [K])``."""
    prob = torch.softmax(torch.as_tensor(np.asarray(pred_logits)), -1).numpy()
    scores = prob[:, :-1].max(-1)
    classes = prob[:, :-1].argmax(-1)
    order = np.argsort(-scores)
    kept = order[scores[order] > threshold][:max_keep]
    K = len(kept)
    q = np.zeros((max_keep,), np.int32)
    c = np.zeros((max_keep,), np.int32)
    v = np.zeros((max_keep,), bool)
    q[:K] = kept
    c[:K] = classes[kept]
    v[:K] = True
    return q, c, v


def masks_from_relevancy(rel_rows: torch.Tensor, feat_hw: Tuple[int, int],
                         out_hw: Tuple[int, int]) -> torch.Tensor:
    """``[K, S]`` per-query relevancy → ``[K, H, W]`` binary float32 masks:
    Otsu at the feature resolution, linear upsample (``jax.image.resize``'s),
    0.5 threshold."""
    m = otsu_binarize(rel_rows.reshape((-1,) + tuple(feat_hw)))
    return (resize_linear(m, out_hw) > 0.5).float()


def pack_mask_bits(masks: torch.Tensor) -> torch.Tensor:
    """``[K, H, W]`` {0, 1} → ``[K, H, ceil(W/8)]`` uint8 bit-planes
    (``np.unpackbits``-compatible, bitorder 'big'), on the masks' device:
    at 800 px, 100 binary masks are 348 MB as fp32 and 10.9 MB as bits."""
    K, H, W = masks.shape
    pad = (-W) % 8
    if pad:
        masks = torch.nn.functional.pad(masks, (0, pad))
    mb = masks.reshape(K, H, (W + pad) // 8, 8).to(torch.int32)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=masks.device)
    return (mb * weights).sum(-1).to(torch.uint8)


def unpack_mask_bits(packed: np.ndarray, width: int) -> np.ndarray:
    """Host inverse of ``pack_mask_bits`` → ``[K, H, width]`` uint8."""
    return np.unpackbits(np.asarray(packed), axis=-1)[..., :width]


def feature_hw(image_hw: Tuple[int, int],
               cfg: detr_model.DETRConfig) -> Tuple[int, int]:
    """The backbone's feature grid, ceil(side / stride): each stride-2
    stage of the ResNet (padded by (k−1)//2) outputs ceil(h/2)."""
    return (-(-image_hw[0] // cfg.stride), -(-image_hw[1] // cfg.stride))


def explain_image(
    params,
    image: torch.Tensor,
    cfg: detr_model.DETRConfig = detr_model.DETR_R50,
    segm_cfg: SegmConfig = SegmConfig(),
    pad_valid: Optional[torch.Tensor] = None,
    mesh=None,
    sp_axis: str = "tp",
    pack_masks: bool = False,
) -> Dict[str, np.ndarray]:
    """Full per-image pipeline → dict with the kept detections
    (``query_idx``, ``classes``, ``scores``, ``boxes``; K of each) and
    their binary masks.

    ``pack_masks=True`` returns ``masks_packed`` (``[K, H, ceil(W/8)]``
    uint8 bit-planes, see ``pack_mask_bits``) and ``mask_hw`` in place of
    dense ``masks``: what crosses to the host is 32 times smaller.

    ``mesh`` routes the "ours" relevancy chains sequence-parallel over
    ``mesh[sp_axis]`` (``explain/detr.generate``, ``parallel/sp``): at the
    protocol's 800 px the encoder taps are [6, K, 8, S, S] with S = 850 to
    1,050, and each rank keeps only its row block of them."""
    batch_valid = None if pad_valid is None else pad_valid[None]
    with torch.no_grad():
        out = detr_model.forward(params, image[None], batch_valid, cfg)
    logits = out["pred_logits"][0].cpu().numpy()
    boxes = out["pred_boxes"][0].cpu().numpy()
    q, c, valid = keep_detections(
        logits, segm_cfg.confidence_threshold, segm_cfg.max_detections)
    n_kept = int(valid.sum())
    q, c = q[:n_kept], c[:n_kept]
    chunk = max(1, segm_cfg.max_queries_per_pass)
    rel = [expl_detr.generate(segm_cfg.method, params, image,
                              q[s:s + chunk], c[s:s + chunk], cfg,
                              pad_valid, mesh=mesh, sp_axis=sp_axis)
           for s in range(0, n_kept, chunk)]

    H, W = image.shape[:2]
    prob = torch.softmax(torch.as_tensor(logits), -1).numpy()
    result = {"query_idx": q, "classes": c, "scores": prob[q, c],
              "boxes": boxes[q]}
    masks = (masks_from_relevancy(torch.cat(rel), feature_hw((H, W), cfg),
                                  (H, W)) if rel else
             torch.zeros((0, H, W), device=image.device))
    if pack_masks:
        result["masks_packed"] = pack_mask_bits(masks).cpu().numpy()
        result["mask_hw"] = (H, W)
    else:
        result["masks"] = masks.cpu().numpy()
    return result


# ---------------------------------------------------------------------------
# Mask AP evaluation (pycocotools-free COCO-style segm mAP)
# ---------------------------------------------------------------------------

def mask_iou(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """``[K, H, W]`` × ``[G, H, W]`` binary → ``[K, G]`` IoU."""
    pred_f = pred.reshape(pred.shape[0], -1).astype(bool)
    gt_f = gt.reshape(gt.shape[0], -1).astype(bool)
    inter = (pred_f[:, None] & gt_f[None]).sum(-1)
    union = (pred_f[:, None] | gt_f[None]).sum(-1)
    return inter / np.maximum(union, 1)


def average_precision(detections: List[Dict], iou_threshold: float) -> float:
    """COCO-style AP at one IoU threshold, averaged over the classes
    present in the ground truth (greedy score-ordered matching). Each
    entry: ``scores [K]``, ``classes [K]``, ``iou [K, G]``,
    ``gt_classes [G]``."""
    all_classes = sorted({int(c) for d in detections
                          for c in d["gt_classes"]})
    aps = []
    for cls in all_classes:
        scores, tps = [], []
        n_gt = 0
        for d in detections:
            gt_idx = np.where(d["gt_classes"] == cls)[0]
            n_gt += len(gt_idx)
            det_idx = np.where(d["classes"] == cls)[0]
            if len(det_idx) == 0:
                continue
            order = det_idx[np.argsort(-d["scores"][det_idx])]
            taken = np.zeros(len(gt_idx), bool)
            for di in order:
                scores.append(d["scores"][di])
                best, best_iou = -1, iou_threshold
                for gi_pos, gi in enumerate(gt_idx):
                    if not taken[gi_pos] and d["iou"][di, gi] >= best_iou:
                        best, best_iou = gi_pos, d["iou"][di, gi]
                if best >= 0:
                    taken[best] = True
                    tps.append(1.0)
                else:
                    tps.append(0.0)
        if n_gt == 0:
            continue
        if not scores:
            aps.append(0.0)
            continue
        order = np.argsort(-np.asarray(scores))
        tp = np.asarray(tps)[order]
        fp = 1.0 - tp
        tp_cum, fp_cum = np.cumsum(tp), np.cumsum(fp)
        recall = tp_cum / n_gt
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
        # COCO 101-point interpolation
        ap = 0.0
        for r in np.linspace(0, 1, 101):
            p = precision[recall >= r].max() if (recall >= r).any() else 0.0
            ap += p / 101
        aps.append(ap)
    return float(np.mean(aps)) if aps else 0.0


def segm_map(detections: List[Dict],
             iou_thresholds: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Segm mAP over IoU thresholds. The reference protocol lowers the
    COCO band 0.5:0.95 to 0.2:0.95 (README.rst:116-145)."""
    if iou_thresholds is None:
        iou_thresholds = np.arange(0.2, 1.0, 0.05)  # lowered band
    per_t = {float(t): average_precision(detections, float(t))
             for t in iou_thresholds}
    return {"segm_mAP": float(np.mean(list(per_t.values()))),
            **{f"AP@{t:.2f}": v for t, v in per_t.items()}}
