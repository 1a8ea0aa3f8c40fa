"""DETR panoptic postprocessing + PQ metric (C17's panoptic leg).

The port's own copy of ``transformer_mm_explainability_tpu/harness/
panoptic.py`` (importing that module would import the JAX package).

``post_process_panoptic`` reproduces the reference's
``PostProcessPanoptic`` (DETR/models/segmentation.py:245-366): keep
non-background queries above the confidence threshold, assign every
pixel to the argmax mask, merge stuff segments of the same class,
nearest-resize the id map to the target size, and iteratively drop
segments whose area collapses to ≤ 4 pixels.

``pq_compute`` reproduces panopticapi's PQ evaluation
(DETR/datasets/panoptic_eval.py → panopticapi.evaluation.pq_compute):
segments match when same-category IoU > 0.5 with the VOID-corrected
union; crowd ground truths never count as FN; predictions mostly
covered by VOID + same-class crowd are not FP;
PQ = Σ IoU_TP / (|TP| + |FP|/2 + |FN|/2) per category, averaged over
categories (All / Things / Stuff splits).

Host-side numpy by construction: the pixel-assignment/merge loop is
data-dependent postprocessing of a single image, not chip work.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

VOID = 0  # panopticapi's unlabeled id


def _resize_nearest(ids: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """PIL-NEAREST-equivalent resize of an integer id map."""
    h, w = ids.shape
    oh, ow = out_hw
    # PIL NEAREST samples at (i + 0.5) * scale, floored
    ys = np.minimum((np.arange(oh) + 0.5) * (h / oh), h - 1).astype(np.int64)
    xs = np.minimum((np.arange(ow) + 0.5) * (w / ow), w - 1).astype(np.int64)
    return ids[ys[:, None], xs[None, :]]


def _bilinear_resize(masks: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """torch F.interpolate(mode='bilinear', align_corners=False) on
    [K, h, w] mask logits."""
    K, h, w = masks.shape
    oh, ow = out_hw
    # float32 throughout: argmax over near-tied mask values at segment
    # boundaries must break ties exactly like torch's f32 kernel
    masks = masks.astype(np.float32)
    ys = np.clip((np.arange(oh, dtype=np.float32) + np.float32(0.5))
                 * np.float32(h / oh) - np.float32(0.5), 0, h - 1)
    xs = np.clip((np.arange(ow, dtype=np.float32) + np.float32(0.5))
                 * np.float32(w / ow) - np.float32(0.5), 0, w - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0).astype(np.float32)[None, :, None]
    wx = (xs - x0).astype(np.float32)[None, None, :]
    a = masks[:, y0][:, :, x0]
    b = masks[:, y0][:, :, x1]
    c = masks[:, y1][:, :, x0]
    d = masks[:, y1][:, :, x1]
    one = np.float32(1.0)
    return (a * (one - wy) * (one - wx) + b * (one - wy) * wx
            + c * wy * (one - wx) + d * wy * wx)


def post_process_panoptic(
    pred_logits: np.ndarray,      # [Q, C+1] (background LAST)
    pred_masks: np.ndarray,       # [Q, h, w] mask logits
    processed_size: Tuple[int, int],
    is_thing_map: Dict[int, bool],
    target_size: Optional[Tuple[int, int]] = None,
    threshold: float = 0.85,
) -> Dict[str, object]:
    """One image → {"id_map" [H, W] int64 (segment index per pixel,
    -1 where no segment), "segments_info" list}."""
    if target_size is None:
        target_size = processed_size
    prob = _softmax(pred_logits)
    scores = prob.max(-1)
    labels = prob.argmax(-1)
    keep = (labels != pred_logits.shape[-1] - 1) & (scores > threshold)
    cur_scores = scores[keep]
    cur_classes = labels[keep]
    cur_masks = _bilinear_resize(pred_masks[keep], processed_size)
    h, w = processed_size

    # stuff segments of the same class get merged into the first
    stuff_equiv: Dict[int, List[int]] = {}
    for k, label in enumerate(cur_classes):
        if not is_thing_map[int(label)]:
            stuff_equiv.setdefault(int(label), []).append(k)

    def get_ids_area(masks, dedup=False):
        if masks.shape[0] == 0:
            m_id = np.zeros((h, w), np.int64)
        else:
            m_id = masks.reshape(masks.shape[0], -1).argmax(0)
        if dedup:
            for equiv in stuff_equiv.values():
                if len(equiv) > 1:
                    for eq in equiv:
                        m_id[m_id == eq] = equiv[0]
        m_id = _resize_nearest(m_id.reshape(h, w), target_size)
        area = [int((m_id == i).sum()) for i in range(masks.shape[0])]
        return area, m_id

    area, m_id = get_ids_area(cur_masks, dedup=True)
    if len(cur_classes) > 0:
        while True:
            small = np.asarray([a <= 4 for a in area])
            if not small.any():
                break
            cur_scores = cur_scores[~small]
            cur_classes = cur_classes[~small]
            cur_masks = cur_masks[~small]
            area, m_id = get_ids_area(cur_masks)
    else:
        cur_classes = np.ones((1,), np.int64)

    segments_info = [
        {"id": i, "isthing": bool(is_thing_map[int(c)]),
         "category_id": int(c), "area": int(a)}
        for i, (a, c) in enumerate(zip(area, cur_classes))
    ]
    if len(area) == 0:
        m_id = np.full(target_size, -1, np.int64)
    return {"id_map": m_id, "segments_info": segments_info,
            "scores": cur_scores}


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


# ---------------------------------------------------------------------------
# PQ metric (panopticapi.evaluation semantics)
# ---------------------------------------------------------------------------

def pq_compute(
    gt_images: Sequence[Tuple[np.ndarray, List[dict]]],
    pred_images: Sequence[Tuple[np.ndarray, List[dict]]],
    categories: Dict[int, dict],
) -> Dict[str, Dict[str, float]]:
    """PQ over per-image (id_map, segments_info) pairs.

    ``id_map``: int segment ids per pixel, VOID (0) = unlabeled. Each
    segments_info entry: {"id", "category_id", "iscrowd"? (gt only),
    "area"?}. ``categories``: {cat_id: {"isthing": bool}}.
    Returns {"All"/"Things"/"Stuff": {"pq", "sq", "rq", "n"}} plus
    ``per_class``.
    """
    OFFSET = 256 * 256 * 256
    iou_sum: Dict[int, float] = {}
    tp: Dict[int, int] = {}
    fp: Dict[int, int] = {}
    fn: Dict[int, int] = {}

    for (gt_map, gt_info), (pr_map, pr_info) in zip(gt_images, pred_images):
        gt_segs = {s["id"]: s for s in gt_info}
        pr_segs = {s["id"]: s for s in pr_info}
        # areas from the maps (panopticapi recomputes pred areas)
        lab, cnt = np.unique(pr_map, return_counts=True)
        pr_area = dict(zip(lab.tolist(), cnt.tolist()))
        for sid, seg in pr_segs.items():
            seg = dict(seg)
            seg["area"] = pr_area.get(sid, 0)
            pr_segs[sid] = seg
        lab, cnt = np.unique(gt_map, return_counts=True)
        gt_area = dict(zip(lab.tolist(), cnt.tolist()))
        for sid, seg in gt_segs.items():
            seg = dict(seg)
            seg.setdefault("area", gt_area.get(sid, 0))
            seg["area"] = gt_area.get(sid, seg["area"])
            gt_segs[sid] = seg

        combined = gt_map.astype(np.int64) * OFFSET + pr_map.astype(np.int64)
        lab, cnt = np.unique(combined, return_counts=True)
        inter: Dict[Tuple[int, int], int] = {}
        for l, c in zip(lab.tolist(), cnt.tolist()):
            inter[(l // OFFSET, l % OFFSET)] = c

        matched_gt, matched_pr = set(), set()
        for (gid, pid), i in inter.items():
            if gid not in gt_segs or pid not in pr_segs:
                continue
            g, p = gt_segs[gid], pr_segs[pid]
            if g.get("iscrowd", 0) == 1:
                continue
            if g["category_id"] != p["category_id"]:
                continue
            union = (p["area"] + g["area"] - i
                     - inter.get((VOID, pid), 0))
            iou = i / union if union > 0 else 0.0
            if iou > 0.5:
                cat = g["category_id"]
                iou_sum[cat] = iou_sum.get(cat, 0.0) + iou
                tp[cat] = tp.get(cat, 0) + 1
                matched_gt.add(gid)
                matched_pr.add(pid)

        crowd_by_cat: Dict[int, int] = {}
        for gid, g in gt_segs.items():
            if g.get("iscrowd", 0) == 1:
                crowd_by_cat[g["category_id"]] = gid
                continue
            if gid not in matched_gt:
                fn[g["category_id"]] = fn.get(g["category_id"], 0) + 1
        for pid, p in pr_segs.items():
            if pid in matched_pr:
                continue
            # intersection with VOID + same-class crowd regions
            ignored = inter.get((VOID, pid), 0)
            crowd_id = crowd_by_cat.get(p["category_id"])
            if crowd_id is not None:
                ignored += inter.get((crowd_id, pid), 0)
            if p["area"] > 0 and ignored / p["area"] > 0.5:
                continue
            fp[p["category_id"]] = fp.get(p["category_id"], 0) + 1

    per_class = {}
    for cat in sorted(set(iou_sum) | set(tp) | set(fp) | set(fn)
                      | set(categories)):
        t, f_p, f_n = tp.get(cat, 0), fp.get(cat, 0), fn.get(cat, 0)
        if t + f_p + f_n == 0:
            continue
        sq = iou_sum.get(cat, 0.0) / t if t else 0.0
        rq = t / (t + 0.5 * f_p + 0.5 * f_n)
        per_class[cat] = {"pq": sq * rq, "sq": sq, "rq": rq}

    def agg(pred):
        cats = [c for c in per_class
                if c in categories and pred(categories[c])]
        n = len(cats)
        if n == 0:
            return {"pq": 0.0, "sq": 0.0, "rq": 0.0, "n": 0}
        return {
            "pq": sum(per_class[c]["pq"] for c in cats) / n,
            "sq": sum(per_class[c]["sq"] for c in cats) / n,
            "rq": sum(per_class[c]["rq"] for c in cats) / n,
            "n": n,
        }

    return {
        "All": agg(lambda c: True),
        "Things": agg(lambda c: c["isthing"]),
        "Stuff": agg(lambda c: not c["isthing"]),
        "per_class": per_class,
    }


def to_pq_format(result: Dict[str, object]) -> Tuple[np.ndarray, List[dict]]:
    """Adapt a ``post_process_panoptic`` result (segment ids 0-based,
    -1 = no segment — the reference PostProcessPanoptic convention) to
    the panopticapi convention ``pq_compute`` consumes (id 0 = VOID,
    segments 1-based).  Without this shift, segment 0 would be read as
    VOID and silently corrupt IoU unions and the FP-suppression rule."""
    id_map = np.asarray(result["id_map"], np.int64) + 1
    segments = [dict(s, id=s["id"] + 1) for s in result["segments_info"]]
    return id_map, segments
