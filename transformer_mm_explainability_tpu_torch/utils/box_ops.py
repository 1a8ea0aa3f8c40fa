"""Box utilities on tensors: format conversion, IoU, generalized IoU and
boxes around masks.

Counterpart of ``transformer_mm_explainability_tpu/utils/box_ops.py``
(DETR's ``util/box_ops.py``), used by the Hungarian matcher, the
SetCriterion losses, PostProcess and the panoptic dataset.
"""

from __future__ import annotations

from typing import Tuple

import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0],
                       dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou(a: torch.Tensor, b: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise IoU of xyxy boxes ``[N, 4] × [M, 4]`` → (``[N, M]`` iou,
    union)."""
    area_a = box_area(a)[:, None]
    area_b = box_area(b)[None, :]
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a + area_b - inter
    return inter / union, union


def generalized_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GIoU ``[N, M]`` (Rezatofighi et al.)."""
    iou, union = box_iou(a, b)
    lt = torch.minimum(a[:, None, :2], b[None, :, :2])
    rb = torch.maximum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / hull


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """``[N, H, W]`` binary masks → ``[N, 4]`` xyxy boxes around the mask
    support (zeros for empty masks)."""
    if masks.shape[0] == 0:
        return torch.zeros((0, 4), dtype=torch.float32, device=masks.device)
    n, h, w = masks.shape
    m = masks.float()
    ys = torch.arange(h, dtype=torch.float32, device=m.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=m.device)[None, None, :]
    big = torch.tensor(1e8, dtype=torch.float32, device=m.device)
    any_mask = m.sum(dim=(1, 2)) > 0
    x_max = (m * xs).reshape(n, -1).amax(-1)
    x_min = torch.where(m > 0, xs, big).reshape(n, -1).amin(-1)
    y_max = (m * ys).reshape(n, -1).amax(-1)
    y_min = torch.where(m > 0, ys, big).reshape(n, -1).amin(-1)
    boxes = torch.stack([x_min, y_min, x_max, y_max], dim=1)
    return torch.where(any_mask[:, None], boxes, torch.zeros_like(boxes))
