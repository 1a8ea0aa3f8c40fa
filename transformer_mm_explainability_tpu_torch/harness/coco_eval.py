"""COCOeval-faithful detection/segmentation scoring in pure numpy.

The port's own copy of ``transformer_mm_explainability_tpu/harness/
coco_eval.py`` (importing that module would import the JAX package).

The reference scores the DETR explanation-segmentation benchmark with
pycocotools' ``COCOeval`` via ``CocoEvaluator`` (DETR/engine.py:153-216,
DETR/datasets/coco_eval.py). This module reproduces COCOeval's exact
evaluation semantics without pycocotools (absent from this image):

  * parameter grids: iouThrs 0.50:0.05:0.95, recThrs 0:0.01:1,
    maxDets (1, 10, 100), area ranges all/small/medium/large;
  * per-(image, category) greedy matching in detection-score order,
    preferring higher IoU, with crowd ground truths matchable by
    multiple detections;
  * ignore semantics: gt outside the area range (or iscrowd) never
    counts as a miss; a detection matched to an ignored gt — or
    unmatched and itself outside the area range — is removed from the
    PR curve instead of counting as a false positive;
  * crowd IoU: intersection over DETECTION area (maskUtils.iou);
  * accumulate: per-cell score-sorted cumulative TP/FP, precision
    envelope (running max from the right), 101-point interpolation by
    left-searchsorted recall thresholds; cells with no ground truth are
    -1 and excluded from the means;
  * summarize: the standard 12-number stats vector.

The IoU band is parameterisable: the paper's protocol keeps the
standard COCO band (the lowered band in DETR/engine.py:164 is
commented out), but ``iou_thrs`` accepts any grid.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def mask_iou(dt_masks: np.ndarray, gt_masks: np.ndarray,
             gt_crowd: np.ndarray) -> np.ndarray:
    """[D, H, W] × [G, H, W] binary → [D, G] IoU with crowd semantics:
    for a crowd gt the denominator is the DETECTION area."""
    D, G = len(dt_masks), len(gt_masks)
    if D == 0 or G == 0:
        return np.zeros((D, G))
    d = dt_masks.reshape(D, -1).astype(bool)
    g = gt_masks.reshape(G, -1).astype(bool)
    inter = (d[:, None] & g[None]).sum(-1).astype(np.float64)
    da = d.sum(-1).astype(np.float64)
    ga = g.sum(-1).astype(np.float64)
    union = np.where(gt_crowd[None, :], da[:, None],
                     da[:, None] + ga[None, :] - inter)
    return inter / np.maximum(union, 1e-12)


def bbox_iou(dt: np.ndarray, gt: np.ndarray,
             gt_crowd: np.ndarray) -> np.ndarray:
    """xywh boxes [D, 4] × [G, 4] → [D, G] with crowd semantics."""
    D, G = len(dt), len(gt)
    if D == 0 or G == 0:
        return np.zeros((D, G))
    dx0, dy0 = dt[:, 0], dt[:, 1]
    dx1, dy1 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx0, gy0 = gt[:, 0], gt[:, 1]
    gx1, gy1 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.maximum(0, np.minimum(dx1[:, None], gx1[None]) -
                    np.maximum(dx0[:, None], gx0[None]))
    ih = np.maximum(0, np.minimum(dy1[:, None], gy1[None]) -
                    np.maximum(dy0[:, None], gy0[None]))
    inter = iw * ih
    da = (dt[:, 2] * dt[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None, :]
    union = np.where(gt_crowd[None, :], da, da + ga - inter)
    return inter / np.maximum(union, 1e-12)


@dataclasses.dataclass
class _ImgEval:
    """evaluateImg result for one (image, category): matching state on
    the score-sorted detections at maxDets[-1] truncation."""
    dt_scores: np.ndarray        # [D]
    dt_matched: np.ndarray       # [T, D] bool
    dt_ignore_base: np.ndarray   # [T, D] bool (matched-to-ignored-gt)
    dt_out_of_area: np.ndarray   # [D] bool (for unmatched-dt ignoring)
    gt_ignore: np.ndarray        # [G] bool
    n_gt: int                    # non-ignored gt count


class CocoEval:
    """pycocotools.COCOeval equivalent over in-memory annotations.

    Ground truths: dicts with ``category_id``, ``iscrowd`` (0/1), and
    either ``mask`` ([H, W] binary, iou_type="segm") or ``bbox``
    (xywh, iou_type="bbox"); optional ``area`` (defaults to mask area /
    w*h). Detections: same plus ``score``.
    """

    def __init__(self, iou_type: str = "segm",
                 iou_thrs: Optional[Sequence[float]] = None,
                 rec_thrs: Optional[Sequence[float]] = None,
                 max_dets: Tuple[int, ...] = (1, 10, 100),
                 area_ranges: Optional[Dict[str, Tuple[float, float]]] = None):
        self.iou_type = iou_type
        self.iou_thrs = np.asarray(
            iou_thrs if iou_thrs is not None
            else np.linspace(0.5, 0.95, 10))
        self.rec_thrs = np.asarray(
            rec_thrs if rec_thrs is not None else np.linspace(0.0, 1.0, 101))
        self.max_dets = tuple(max_dets)
        self.area_ranges = dict(area_ranges or AREA_RANGES)
        # evals[(img, cat, area_label)] = _ImgEval
        self._evals: Dict[Tuple[int, int, str], _ImgEval] = {}
        self._cats: set = set()
        self._imgs: set = set()
        self._n_img = 0

    # -- per-image ---------------------------------------------------------

    def _area(self, ann) -> float:
        if "area" in ann and ann["area"] is not None:
            return float(ann["area"])
        if self.iou_type == "segm":
            return float(np.asarray(ann["mask"]).astype(bool).sum())
        b = ann["bbox"]
        return float(b[2] * b[3])

    def add_image(self, gts: List[dict], dts: List[dict],
                  image_id: Optional[int] = None) -> None:
        """Evaluate one image's annotations (evaluateImg for every
        (category, area range) cell)."""
        img = self._n_img if image_id is None else image_id
        self._n_img += 1
        self._imgs.add(img)
        cats = sorted({int(a["category_id"]) for a in gts}
                      | {int(a["category_id"]) for a in dts})
        for cat in cats:
            self._cats.add(cat)
            g = [a for a in gts if int(a["category_id"]) == cat]
            d = [a for a in dts if int(a["category_id"]) == cat]
            self._eval_img_cat(img, cat, g, d)

    def _eval_img_cat(self, img, cat, gts, dts):
        T = len(self.iou_thrs)
        scores = np.asarray([d["score"] for d in dts], np.float64)
        order = np.argsort(-scores, kind="mergesort")[: self.max_dets[-1]]
        dts = [dts[i] for i in order]
        scores = scores[order]
        crowd = np.asarray([int(g.get("iscrowd", 0)) for g in gts], bool)
        if self.iou_type == "segm":
            ious_all = mask_iou(
                np.asarray([np.asarray(d["mask"]) for d in dts])
                if dts else np.zeros((0, 1, 1)),
                np.asarray([np.asarray(g["mask"]) for g in gts])
                if gts else np.zeros((0, 1, 1)),
                crowd)
        else:
            ious_all = bbox_iou(
                np.asarray([d["bbox"] for d in dts], np.float64).reshape(-1, 4),
                np.asarray([g["bbox"] for g in gts], np.float64).reshape(-1, 4),
                crowd)
        g_area = np.asarray([self._area(g) for g in gts])
        d_area = np.asarray([self._area(d) for d in dts])

        for label, (lo, hi) in self.area_ranges.items():
            gt_ig = crowd | (g_area < lo) | (g_area > hi)
            # gts sorted: non-ignored first (stable)
            g_ord = np.argsort(gt_ig, kind="mergesort")
            ious = ious_all[:, g_ord] if len(gts) else ious_all
            gig = gt_ig[g_ord] if len(gts) else gt_ig
            crowd_s = crowd[g_ord] if len(gts) else crowd

            D, G = len(dts), len(gts)
            dtm = np.zeros((T, D), np.int64) - 1     # matched gt index
            gtm = np.zeros((T, G), bool)
            dt_ig = np.zeros((T, D), bool)
            for ti, t in enumerate(self.iou_thrs):
                for di in range(D):
                    best = min(t, 1.0 - 1e-10)
                    m = -1
                    for gi in range(G):
                        if gtm[ti, gi] and not crowd_s[gi]:
                            continue
                        # best non-ignored match found and remaining gts
                        # are ignored: stop
                        if m > -1 and not gig[m] and gig[gi]:
                            break
                        if ious[di, gi] < best:
                            continue
                        best = ious[di, gi]
                        m = gi
                    if m == -1:
                        continue
                    dtm[ti, di] = m
                    gtm[ti, m] = True
                    dt_ig[ti, di] = gig[m]
            self._evals[(img, cat, label)] = _ImgEval(
                dt_scores=scores,
                dt_matched=dtm >= 0,
                dt_ignore_base=dt_ig,
                dt_out_of_area=(d_area < lo) | (d_area > hi),
                gt_ignore=gig,
                n_gt=int((~gig).sum()),
            )

    # -- accumulate / summarize ---------------------------------------------

    def accumulate(self) -> Dict[str, np.ndarray]:
        T = len(self.iou_thrs)
        R = len(self.rec_thrs)
        cats = sorted(self._cats)
        K = len(cats)
        A = len(self.area_ranges)
        M = len(self.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores_out = -np.ones((T, R, K, A, M))
        imgs = sorted(self._imgs)
        for ki, cat in enumerate(cats):
            for ai, label in enumerate(self.area_ranges):
                evals = [self._evals.get((img, cat, label))
                         for img in imgs]
                evals = [e for e in evals if e is not None]
                if not evals:
                    continue
                npig = sum(e.n_gt for e in evals)
                if npig == 0:
                    continue
                for mi, max_det in enumerate(self.max_dets):
                    dt_scores = np.concatenate(
                        [e.dt_scores[:max_det] for e in evals])
                    o = np.argsort(-dt_scores, kind="mergesort")
                    dt_scores = dt_scores[o]
                    def _ig(e):
                        m = e.dt_matched[:, :max_det]
                        oa = e.dt_out_of_area[:max_det]
                        return (e.dt_ignore_base[:, :max_det]
                                | (~m & oa[None, :]))

                    matched = np.concatenate(
                        [e.dt_matched[:, :max_det] for e in evals],
                        axis=1)[:, o]
                    ignored = np.concatenate(
                        [_ig(e) for e in evals], axis=1)[:, o]
                    tps = matched & ~ignored
                    fps = ~matched & ~ignored
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if nd else 0.0
                        # precision envelope (monotone from the right)
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, self.rec_thrs,
                                               side="left")
                        q = np.zeros(R)
                        s = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi >= nd:
                                break
                            q[ri] = pr[pi]
                            s[ri] = dt_scores[pi]
                        precision[:, :, ki, ai, mi][ti] = q
                        scores_out[:, :, ki, ai, mi][ti] = s
        self._precision = precision
        self._recall = recall
        return {"precision": precision, "recall": recall,
                "scores": scores_out}

    def _mean(self, x) -> float:
        valid = x[x > -1]
        return float(valid.mean()) if valid.size else -1.0

    def summarize(self) -> Dict[str, float]:
        """The standard 12-stat vector (plus a dict view)."""
        p, r = self._precision, self._recall
        mdi = len(self.max_dets) - 1
        ar = list(self.area_ranges)

        def ap(iou=None, area="all", mi=mdi):
            ai = ar.index(area)
            x = p[:, :, :, ai, mi]
            if iou is not None:
                ti = int(np.argmin(np.abs(self.iou_thrs - iou)))
                x = x[ti:ti + 1]
            return self._mean(x)

        def arec(area="all", mi=mdi):
            ai = ar.index(area)
            return self._mean(r[:, :, ai, mi])

        stats = {
            "AP": ap(),
            "AP50": ap(iou=0.5),
            "AP75": ap(iou=0.75),
            "AP_small": ap(area="small"),
            "AP_medium": ap(area="medium"),
            "AP_large": ap(area="large"),
            "AR_1": arec(mi=0) if len(self.max_dets) > 0 else -1,
            "AR_10": arec(mi=min(1, mdi)),
            "AR_100": arec(mi=mdi),
            "AR_small": arec(area="small"),
            "AR_medium": arec(area="medium"),
            "AR_large": arec(area="large"),
        }
        return stats
