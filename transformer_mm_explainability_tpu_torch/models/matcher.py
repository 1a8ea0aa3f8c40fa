"""Hungarian matcher, DETR losses and post-processing, in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/matcher.py``:
DETR/models/matcher.py:12-77 (HungarianMatcher), DETR/models/detr.py:
103-276 (SetCriterion, the forward losses) and :278-307 (PostProcess).
The assignment is a small problem between two device programs, so it runs
on the host with scipy; cost matrices and losses run on the tensors'
device, with padded targets and validity masks as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from transformer_mm_explainability_tpu_torch.utils import box_ops


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    cost_class: float = 1.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0


def cost_matrix(
    pred_logits: torch.Tensor,   # [Q, C+1]
    pred_boxes: torch.Tensor,    # [Q, 4] cxcywh
    tgt_labels: torch.Tensor,    # [M] (padded)
    tgt_boxes: torch.Tensor,     # [M, 4] cxcywh (padded)
    cfg: MatcherConfig = MatcherConfig(),
) -> torch.Tensor:
    """``[Q, M]`` matching cost (matcher.py:48-69: -prob, L1, -GIoU)."""
    prob = torch.softmax(pred_logits, -1)
    cost_class = -prob[:, tgt_labels.long()]
    cost_bbox = (pred_boxes[:, None] - tgt_boxes[None]).abs().sum(-1)
    cost_giou = -box_ops.generalized_box_iou(
        box_ops.box_cxcywh_to_xyxy(pred_boxes),
        box_ops.box_cxcywh_to_xyxy(tgt_boxes))
    return (cfg.cost_bbox * cost_bbox + cfg.cost_class * cost_class
            + cfg.cost_giou * cost_giou)


def hungarian(cost: np.ndarray, n_valid: int) -> np.ndarray:
    """Assignment of targets → queries: ``[M]`` query index per target
    (-1 beyond ``n_valid``), solved on the host by scipy."""
    from scipy.optimize import linear_sum_assignment

    M = cost.shape[1]
    out = np.full((M,), -1, np.int64)
    if n_valid > 0:
        rows, cols = linear_sum_assignment(cost[:, :n_valid])
        out[cols] = rows
    return out


def match(pred_logits, pred_boxes, tgt_labels, tgt_boxes, n_valid,
          cfg: MatcherConfig = MatcherConfig()) -> np.ndarray:
    """Batched matching, inputs ``[B, ...]``; returns ``[B, M]`` query
    indices (-1 = pad)."""
    return np.stack([
        hungarian(cost_matrix(pred_logits[b], pred_boxes[b], tgt_labels[b],
                              tgt_boxes[b], cfg).cpu().numpy(),
                  int(n_valid[b]))
        for b in range(pred_logits.shape[0])])


def set_criterion_losses(
    pred_logits: torch.Tensor,    # [B, Q, C+1]
    pred_boxes: torch.Tensor,     # [B, Q, 4]
    tgt_labels: torch.Tensor,     # [B, M] padded with any value
    tgt_boxes: torch.Tensor,      # [B, M, 4]
    assignment: torch.Tensor,     # [B, M] query index per target (-1 pad)
    eos_coef: float = 0.1,
    num_classes: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """DETR losses given a matching (SetCriterion: loss_labels :159-180,
    cardinality :182-192, loss_boxes :194-214), padded targets masked by
    ``assignment >= 0``."""
    B, Q, Cp1 = pred_logits.shape
    C = (Cp1 - 1) if num_classes is None else num_classes
    assignment = torch.as_tensor(assignment, device=pred_logits.device)
    valid = assignment >= 0
    n_boxes = valid.sum().clamp(min=1)

    # classification: every query defaults to the no-object class C; pad
    # rows scatter nothing
    target_classes = torch.full((B, Q), C, dtype=torch.long,
                                device=pred_logits.device)
    b_idx, m_idx = valid.nonzero(as_tuple=True)
    target_classes[b_idx, assignment[b_idx, m_idx]] = \
        tgt_labels[b_idx, m_idx].long()
    weights = torch.where(target_classes == C, eos_coef, 1.0)
    logp = torch.log_softmax(pred_logits, -1)
    ce = -torch.gather(logp, -1, target_classes[..., None])[..., 0]
    loss_ce = (ce * weights).sum() / weights.sum()

    # cardinality (diagnostic): |#non-eos predictions − #targets| (L1)
    pred_count = (pred_logits.argmax(-1) != C).sum(-1)
    card_err = (pred_count - valid.sum(-1)).abs().float().mean()

    # box losses on matched pairs (pad rows read query 0, then masked)
    q_idx = assignment.clamp(min=0)
    matched_pred = torch.gather(pred_boxes, 1,
                                q_idx[..., None].expand(-1, -1, 4))
    l1 = (matched_pred - tgt_boxes).abs().sum(-1)
    zero = torch.zeros_like(l1)
    loss_bbox = torch.where(valid, l1, zero).sum() / n_boxes
    giou = torch.stack([
        box_ops.generalized_box_iou(box_ops.box_cxcywh_to_xyxy(mp),
                                    box_ops.box_cxcywh_to_xyxy(tb)).diagonal()
        for mp, tb in zip(matched_pred, tgt_boxes)])
    loss_giou = torch.where(valid, 1.0 - giou, zero).sum() / n_boxes
    return {"loss_ce": loss_ce, "loss_bbox": loss_bbox,
            "loss_giou": loss_giou, "cardinality_error": card_err}


def post_process(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                 target_sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
    """PostProcess (detr.py:278-307): softmax over the classes (the
    no-object column left out of the max), boxes → absolute xyxy."""
    prob = torch.softmax(pred_logits, -1)
    scores, labels = prob[..., :-1].max(-1)
    boxes = box_ops.box_cxcywh_to_xyxy(pred_boxes)
    h, w = target_sizes[:, 0], target_sizes[:, 1]
    scale = torch.stack([w, h, w, h], dim=1)[:, None, :].to(boxes.dtype)
    return {"scores": scores, "labels": labels, "boxes": boxes * scale}
