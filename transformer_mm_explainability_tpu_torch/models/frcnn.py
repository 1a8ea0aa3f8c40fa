"""Faster R-CNN visual frontend (the LXMERT feature extractor), in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/frcnn.py``, the
reference's detectron2 port (ResNet-101 C4 backbone, RPN with anchors,
NMS, torchvision **RoIPool**, the VG res5 head, do_nms and the attribute
head), producing 36 RoI features (2048-d) and normalised boxes for LXMERT.
Every stage keeps the JAX package's static shapes: top-K and validity
masks instead of dynamic filtering, a fixed-iteration argmax-suppress NMS
and padded outputs.

``roi_pool_impl`` keeps the JAX names so that one config serves both
packages: ``"pallas"`` is the CUDA kernel's wrapper,
``ops/roi_pool_pallas.roi_pool_pallas`` (its plain version on the CPU), and
``"xla"`` is ``roi_pool`` here, the plain PyTorch path. **The port's
default is ``"pallas"``** (the JAX package's is ``"xla"``), so the main
path runs the kernel on the card.

Traps of the translation, each handled where it arises:
``jnp.meshgrid``'s default ``indexing="xy"``; ``jax.lax.top_k`` and
``jnp.argsort``, which put equal values in index order (a stable
descending ``torch.sort`` here); ``jnp.repeat`` → ``repeat_interleave``.

Layouts: images and feature maps ``[H, W, C]`` at the public functions,
NCHW channels_last inside (``models/resnet``), so the ``[Hf, Wf, 1024]``
map that RoIPool takes is a contiguous view.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from transformer_mm_explainability_tpu_torch.models import resnet
from transformer_mm_explainability_tpu_torch.ops import image as img_ops
from transformer_mm_explainability_tpu_torch.ops import roi_pool_pallas
from transformer_mm_explainability_tpu_torch.ops.roi_pool_pallas import (
    roi_pool_plain,
)

NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class FrcnnConfig:
    # backbone: ResNet-101 C4 (res2-res4 features; res5 = RoI head)
    stages: Tuple[int, ...] = (3, 4, 23, 3)
    stride_in_1x1: bool = True
    caffe_maxpool: bool = True        # MODEL.MAX_POOL (caffe stem pool)
    feat_stride: int = 16
    # anchors (ANCHOR_GENERATOR.*; OFFSET=0.0 is the detectron2 default)
    anchor_sizes: Tuple[float, ...] = (32, 64, 128, 256, 512)
    aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    anchor_offset: float = 0.0
    # RPN (RPN.* + PROPOSAL_GENERATOR.*)
    rpn_hidden_dim: int = 512         # VG config HIDDEN_CHANNELS
    pre_nms_topk: int = 6000          # PRE_NMS_TOPK_TEST
    post_nms_topk: int = 1000         # POST_NMS_TOPK_TEST
    rpn_nms_thresh: float = 0.7
    # RoI heads
    pooler_resolution: int = 14
    res5_halve: bool = False          # VG: stride-1 res5 + dilation 2
    num_classes: int = 1600
    num_attrs: int = 400
    score_thresh: float = 0.2         # accepted + ignored, like do_nms
    detection_nms_thresh: float = 0.5
    max_detections: int = 36          # MIN_DETECTIONS == MAX_DETECTIONS
    cls_agnostic_bbox_reg: bool = False
    # box transform weights (RPN.BBOX_REG_WEIGHTS / ROI_BOX_HEAD.*)
    rpn_box_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    box_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0)
    # RoIPool: "pallas" (the CUDA kernel's wrapper, the port's default) or
    # "xla" (plain PyTorch); equal to the bit (tests/test_torch_frcnn.py)
    roi_pool_impl: str = "pallas"
    # NMS: "argmax" (max_out argmax + suppress iterations) or "blocked"
    # (score-sorted blocks); the same outputs
    nms_impl: str = "argmax"


FRCNN_VG = FrcnnConfig()


# ---------------------------------------------------------------------------
# anchors & box transform
# ---------------------------------------------------------------------------

def anchor_grid(feat_h: int, feat_w: int, cfg: FrcnnConfig,
                device="cpu") -> torch.Tensor:
    """[H*W*A, 4] xyxy anchors: cell-major (y, x), anchor-minor, with
    centre-0 bases (``grid_anchors`` / ``generate_cell_anchors``)."""
    bases = []
    for size in cfg.anchor_sizes:
        area = size * size
        for ratio in cfg.aspect_ratios:
            w = (area / ratio) ** 0.5
            h = w * ratio
            bases.append([-w / 2, -h / 2, w / 2, h / 2])
    bases = torch.tensor(bases, dtype=torch.float32, device=device)
    arange = lambda n: torch.arange(n, dtype=torch.float32, device=device)
    shifts_x = (arange(feat_w) + cfg.anchor_offset) * cfg.feat_stride
    shifts_y = (arange(feat_h) + cfg.anchor_offset) * cfg.feat_stride
    # jnp.meshgrid defaults to "xy": [H, W] grids
    sx, sy = torch.meshgrid(shifts_x, shifts_y, indexing="xy")
    shifts = torch.stack([sx, sy, sx, sy], dim=-1).reshape(-1, 1, 4)
    return (shifts + bases[None]).reshape(-1, 4)


def apply_deltas(boxes: torch.Tensor, deltas: torch.Tensor,
                 weights: Sequence[float],
                 scale_clamp: float = 4.135166556742356) -> torch.Tensor:
    """Box2BoxTransform.apply_deltas (dx, dy, dw, dh on cxcywh; the clamp
    default is ln(1000/16))."""
    wx, wy, ww, wh = weights
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    cx = boxes[:, 0] + 0.5 * w
    cy = boxes[:, 1] + 0.5 * h
    dx, dy, dw, dh = (deltas[:, 0] / wx, deltas[:, 1] / wy,
                      deltas[:, 2] / ww, deltas[:, 3] / wh)
    dw = torch.clamp(dw, max=scale_clamp)
    dh = torch.clamp(dh, max=scale_clamp)
    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack([pcx - pw / 2, pcy - ph / 2,
                        pcx + pw / 2, pcy + ph / 2], dim=1)


def clip_boxes(boxes: torch.Tensor, img_h: float,
               img_w: float) -> torch.Tensor:
    return torch.stack([boxes[:, 0].clamp(0, img_w),
                        boxes[:, 1].clamp(0, img_h),
                        boxes[:, 2].clamp(0, img_w),
                        boxes[:, 3].clamp(0, img_h)], dim=1)


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """_nonempty_boxes: both sides longer than ``threshold``."""
    return ((boxes[:, 2] - boxes[:, 0] > threshold)
            & (boxes[:, 3] - boxes[:, 1] > threshold))


def _masked(scores: torch.Tensor, valid: Optional[torch.Tensor]):
    if valid is None:
        return scores
    return torch.where(valid, scores, torch.full_like(scores, NEG_INF))


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[Na, Nb]`` IoU of xyxy boxes, the JAX NMS expression
    ``inter / (area_a + area_b − inter)`` (a zero-area pair gives NaN)."""
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area(a)[:, None] + area(b)[None, :] - inter)


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
              max_out: int, valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape NMS: ``max_out`` iterations of argmax + suppress, as
    torchvision ``nms`` (suppress on IoU strictly above the threshold,
    score-descending output, first index on ties). Returns (indices
    [max_out] int64, keep_valid [max_out] bool).

    The JAX version computes the winner's IoU row on the fly and stops when
    the candidates run out. Here the ``[N, N]`` suppression matrix is built
    once (the same fp32 IoU; 36 MB of bool, and about 1 GB of transient
    fp32, at the RPN's 6,000 boxes), with
    its diagonal set so that a pick also suppresses itself, and the loop
    always runs ``max_out`` iterations of three launches, never reading a
    value back to the host. The outputs are the same: once every score is
    −inf, ``max`` picks index 0 with a −inf value, so each remaining slot
    gets index 0 and ``False``, which is what the JAX version leaves in
    them."""
    s = _masked(scores, valid)
    sup = pairwise_iou(boxes, boxes) > iou_thresh
    sup.fill_diagonal_(True)
    picks, bests = [], []
    for _ in range(max_out):
        best, j = s.max(dim=0, keepdim=True)    # first index on ties
        picks.append(j)
        bests.append(best)
        s = s.masked_fill(sup.index_select(0, j)[0], NEG_INF)
    return torch.cat(picks), torch.cat(bests) > NEG_INF


def nms_blocked(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
                max_out: int, valid: Optional[torch.Tensor] = None,
                block: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nms_fixed``'s outputs from score-sorted blocks: boxes are first
    suppressed by the survivors of earlier blocks, then the within-block
    greedy recurrence is iterated to its fixpoint (one host read per
    iteration). The stable descending sort reproduces ``nms_fixed``'s
    first-index tie-break."""
    N = boxes.shape[0]
    dev = boxes.device
    s = _masked(scores, valid)
    order = torch.sort(s, descending=True, stable=True).indices
    sup = pairwise_iou(boxes[order], boxes[order]) > iou_thresh
    base = s[order] > NEG_INF
    keep = torch.zeros(N, dtype=torch.bool, device=dev)
    tidx = torch.arange(N, device=dev)
    for lo in range(0, N, block):
        hi = min(lo + block, N)
        # suppressed by a survivor of an earlier block
        cur_base = base[lo:hi] & ~(sup[lo:hi, :lo] & keep[None, :lo]).any(1)
        # within the block: S[u, t] ⇔ u precedes t and suppresses it
        S = sup[lo:hi, lo:hi] & (tidx[:hi - lo, None] < tidx[None, :hi - lo])
        alive = cur_base
        while True:
            new = cur_base & ~(S & alive[:, None]).any(dim=0)
            if torch.equal(new, alive):
                break
            alive = new
        keep[lo:hi] = alive
    rank = torch.cumsum(keep.long(), 0) - 1
    slot = torch.where(keep & (rank < max_out), rank,
                       torch.full_like(rank, max_out))
    idxs = torch.zeros(max_out + 1, dtype=torch.long, device=dev)
    idxs = idxs.scatter(0, slot, order)[:max_out]
    ok = torch.arange(max_out, device=dev) < torch.clamp(keep.sum(),
                                                         max=max_out)
    return idxs, ok


def roi_pool(features: torch.Tensor, boxes: torch.Tensor, output_size: int,
             spatial_scale: float) -> torch.Tensor:
    """torchvision ``roi_pool`` in plain PyTorch: ``[H, W, C]`` features ×
    ``[K, 4]`` xyxy boxes → ``[K, P, P, C]`` (the ``"xla"`` path; it is
    ``ops/roi_pool_pallas.roi_pool_plain``, the kernel's plain version)."""
    return roi_pool_plain(features, boxes, output_size, spatial_scale)


def roi_pool_fn(cfg: FrcnnConfig) -> Callable[..., torch.Tensor]:
    """The RoIPool that ``cfg.roi_pool_impl`` names: ``"pallas"``, the CUDA
    kernel's wrapper (``ops/roi_pool_pallas.roi_pool_pallas``, its plain
    version on a CPU tensor), or ``"xla"``, the plain version itself."""
    if cfg.roi_pool_impl == "pallas":
        return roi_pool_pallas.roi_pool_pallas
    if cfg.roi_pool_impl == "xla":
        return roi_pool
    raise ValueError(f"unknown roi_pool_impl {cfg.roi_pool_impl!r} "
                     "(expected 'xla' or 'pallas')")


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def init_params(seed: Union[int, torch.Generator] = 0,
                cfg: FrcnnConfig = FRCNN_VG, device="cuda") -> Dict[str, Any]:
    """Random weights in the JAX tree's structure (normal, std 0.01; the
    box regressor 0.001; the attribute class embedding 1.0; zero biases),
    drawn on the CPU from ``seed``; conv weights OIHW, channels_last.

    Two departures from the JAX init keep a random model's detections
    real: the stem's frozen BN scales by 1/64 (the caffe input is raw
    0-255 pixels minus the mean) and each residual branch of the backbone
    by 0.2 (its last frozen BN). With unit scales the res4 features of
    ResNet-101 grow to hundreds or more, the RPN's deltas push every
    proposal out of the image, and no RoI survives; with these the features
    stay near unit size and the RPN proposes boxes inside the image."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    nrm = lambda *shape, s=0.01: (torch.randn(shape, generator=gen) * s).to(
        device)
    conv_w = lambda *shape: nrm(*shape).contiguous(
        memory_format=resnet.CL)
    zeros = lambda n: torch.zeros(n, device=device)
    backbone = resnet.init_params(gen, cfg.stages, device=device)
    backbone["bn1"]["weight"].fill_(1 / 64)
    for blocks in backbone["layers"]:
        for bp in blocks:
            bp["bn3"]["weight"].fill_(0.2)
    A = len(cfg.anchor_sizes) * len(cfg.aspect_ratios)
    C4 = 1024
    Dh = cfg.rpn_hidden_dim if cfg.rpn_hidden_dim > 0 else C4
    n_box = 4 if cfg.cls_agnostic_bbox_reg else cfg.num_classes * 4
    return {
        "backbone": backbone,
        "rpn": {
            "conv": {"w": conv_w(Dh, C4, 3, 3), "b": zeros(Dh)},
            "objectness": {"w": conv_w(A, Dh, 1, 1), "b": zeros(A)},
            "deltas": {"w": conv_w(A * 4, Dh, 1, 1), "b": zeros(A * 4)},
        },
        # background LAST (detectron2 convention; do_nms drops scores[:, -1])
        "cls_score": {"w": nrm(2048, cfg.num_classes + 1),
                      "b": zeros(cfg.num_classes + 1)},
        "bbox_pred": {"w": nrm(2048, n_box, s=0.001), "b": zeros(n_box)},
        "attr_cls_emb": nrm(cfg.num_classes + 1, 2048 // 8, s=1.0),
        "attr_fc": {"w": nrm(2048 + 2048 // 8, 2048 // 4),
                    "b": zeros(2048 // 4)},
        "attr_score": {"w": nrm(2048 // 4, cfg.num_attrs + 1),
                       "b": zeros(cfg.num_attrs + 1)},
    }


def _res4_features(params, images: torch.Tensor,
                   cfg: FrcnnConfig) -> torch.Tensor:
    """Backbone through res4 (C4): ``[B, H, W, 3]`` → ``[B, Hf, Wf, 1024]``,
    a contiguous NHWC view of a channels_last result."""
    bb = params["backbone"]
    x = resnet.stem(bb, resnet.to_nchw(images), caffe_pool=cfg.caffe_maxpool)
    for si, blocks in enumerate(bb["layers"][:3]):
        stage_stride = 1 if si == 0 else 2
        for bi, bp in enumerate(blocks):
            x = resnet.bottleneck(x, bp, stride=stage_stride if bi == 0 else 1,
                                  stride_in_1x1=cfg.stride_in_1x1)
    return resnet.to_nhwc(x)


def _res5_head(params, rois: torch.Tensor, cfg: FrcnnConfig) -> torch.Tensor:
    """res5 stage on pooled features ``[K, P, P, 1024]`` → ``[K, 2048]``.

    VG modification (RES5HALVE=False): block-0 stride 2 → 1 (conv1 and
    shortcut) and every 3×3 conv gets dilation 2 / padding 2, keeping the
    14×14 size."""
    x = resnet.to_nchw(rois)
    halve = cfg.res5_halve
    for bi, bp in enumerate(params["backbone"]["layers"][3]):
        stride = (2 if bi == 0 else 1) if halve else 1
        x = resnet.bottleneck(x, bp, stride=stride,
                              dilation=1 if halve else 2,
                              stride_in_1x1=cfg.stride_in_1x1)
    return x.mean(dim=(2, 3))


def _conv_b(x: torch.Tensor, p) -> torch.Tensor:
    return resnet.conv(x, p["w"]) + p["b"][:, None, None]


def forward(params: Dict[str, Any], image: torch.Tensor,
            cfg: FrcnnConfig = FRCNN_VG,
            on_stage: Optional[Callable[[str], None]] = None
            ) -> Dict[str, torch.Tensor]:
    """Single-image detection, ``image`` ``[H, W, 3]`` preprocessed →
    padded {roi_features [M, 2048], boxes [M, 4] xyxy pixels,
    normalized_boxes, obj_ids, obj_probs, attr_ids, attr_probs, valid [M],
    rois, roi_valid, roi_scores, det_scores} with M = max_detections.

    ``on_stage``, when given, is called with the name of each stage as it
    ends ("backbone", "rpn+nms", "roi_pool", "res5", "heads"), e.g. to
    record a CUDA event there; it changes nothing else."""
    mark = on_stage or (lambda name: None)
    if cfg.nms_impl == "blocked":
        nms_fn = nms_blocked
    elif cfg.nms_impl == "argmax":
        nms_fn = nms_fixed
    else:
        raise ValueError(f"unknown nms_impl {cfg.nms_impl!r} "
                         "(expected 'argmax' or 'blocked')")
    pool_fn = roi_pool_fn(cfg)
    H, W, _ = image.shape
    dev = image.device
    feats = _res4_features(params, image[None], cfg)[0]    # [Hf, Wf, 1024]
    Hf, Wf, _ = feats.shape
    mark("backbone")

    # --- RPN (RPNHead → find_top_rpn_proposals) -----------------------------
    rpn = params["rpn"]
    t = torch.relu(_conv_b(resnet.to_nchw(feats[None]), rpn["conv"]))
    obj = resnet.to_nhwc(_conv_b(t, rpn["objectness"]))[0].reshape(-1)
    deltas = resnet.to_nhwc(_conv_b(t, rpn["deltas"]))[0].reshape(-1, 4)
    anchors = anchor_grid(Hf, Wf, cfg, dev)
    proposals = apply_deltas(anchors, deltas, cfg.rpn_box_weights)

    k_pre = min(cfg.pre_nms_topk, proposals.shape[0])
    # lax.top_k puts equal values in index order: a stable descending sort
    top = torch.sort(obj, descending=True, stable=True)
    top_scores, top_idx = top.values[:k_pre], top.indices[:k_pre]
    top_boxes = clip_boxes(proposals[top_idx], H, W)
    keep_idx, keep_ok = nms_fn(top_boxes, top_scores, cfg.rpn_nms_thresh,
                               cfg.post_nms_topk, valid=nonempty(top_boxes))
    rois = top_boxes[keep_idx]                             # [post_nms, 4]
    mark("rpn+nms")

    # --- RoI heads: RoIPool + res5 (Res5ROIHeads) ---------------------------
    pooled = pool_fn(feats, rois, cfg.pooler_resolution, 1.0 / cfg.feat_stride)
    mark("roi_pool")
    feat_vec = _res5_head(params, pooled, cfg)             # [post_nms, 2048]
    mark("res5")
    logits = feat_vec @ params["cls_score"]["w"] + params["cls_score"]["b"]
    scores = torch.softmax(logits, -1)                     # bg LAST
    box_deltas = feat_vec @ params["bbox_pred"]["w"] + params["bbox_pred"]["b"]

    # --- detection selection (do_nms) ---------------------------------------
    # class-max over the foreground columns; the regressed box of the max
    # class; ONE NMS over all proposals, first max_detections kept
    best_prob, best_cls = scores[:, :-1].max(-1)           # first on ties
    N_p = rois.shape[0]
    if box_deltas.shape[-1] == 4:      # class-agnostic variant
        boxes = clip_boxes(
            apply_deltas(rois, box_deltas, cfg.box_weights), H, W)
    else:                              # per-class regression (VG)
        Kc = box_deltas.shape[-1] // 4
        rep = rois.repeat_interleave(Kc, dim=0)            # [N*K, 4]
        all_boxes = clip_boxes(
            apply_deltas(rep, box_deltas.reshape(N_p * Kc, 4),
                         cfg.box_weights), H, W).reshape(N_p, Kc, 4)
        boxes = torch.gather(
            all_boxes, 1, best_cls[:, None, None].expand(N_p, 1, 4))[:, 0]
    final_idx, det_ok = nms_fn(boxes, best_prob, cfg.detection_nms_thresh,
                               cfg.max_detections, valid=keep_ok)

    out_boxes = boxes[final_idx]
    norm = out_boxes / torch.tensor([W, H, W, H], dtype=torch.float32,
                                    device=dev)
    roi_features = feat_vec[final_idx]
    # attribute head: class embedding of the argmax over ALL classes
    # (background included); the attribute softmax drops the LAST logit
    emb_cls = logits.argmax(-1)[final_idx]
    cls_emb = params["attr_cls_emb"][emb_cls]
    ah = torch.relu(torch.cat([roi_features, cls_emb], -1)
                    @ params["attr_fc"]["w"] + params["attr_fc"]["b"])
    attr_logits = ah @ params["attr_score"]["w"] + params["attr_score"]["b"]
    attr_probs, attr_ids = torch.softmax(attr_logits[:, :-1], -1).max(-1)
    out = {
        "roi_features": roi_features,
        "boxes": out_boxes,
        "normalized_boxes": norm,
        "obj_ids": best_cls[final_idx],
        "obj_probs": best_prob[final_idx],
        "attr_ids": attr_ids,
        "attr_probs": attr_probs,
        "valid": det_ok,
        "rois": rois,
        "roi_valid": keep_ok,
        "roi_scores": top_scores[keep_idx],
        "det_scores": best_prob,
    }
    mark("heads")
    return out


def preprocess(image_u8, target_shortest: int = 800, longest_cap: int = 1333,
               pixel_mean: Sequence[float] = (102.9801, 115.9465, 122.7717),
               pixel_std: Sequence[float] = (1.0, 1.0, 1.0),
               device=None) -> torch.Tensor:
    """detectron2-caffe preprocessing: BGR channel order, (x − mean)/std
    (std = 1), shortest edge resized (bilinear) with ``round`` sizes.
    Input RGB uint8 ``[H, W, 3]`` (tensor or numpy; ``device`` moves a
    numpy image, default the CPU)."""
    if not torch.is_tensor(image_u8):
        image_u8 = torch.from_numpy(np.array(image_u8))
    img = image_u8.to(device=device, dtype=torch.float32)
    img = img.flip(-1)                                     # RGB → BGR
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=img.device)
    std = torch.tensor(pixel_std, dtype=torch.float32, device=img.device)
    img = (img - mean) / std
    return img_ops.resize_shortest_edge(img, target_shortest, longest_cap,
                                        method="bilinear").contiguous()
