"""Otsu thresholding, batched, in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/ops/otsu.py``. The
reference binarises relevancy maps with cv2's Otsu
(DETR/mask_generator.py:116-121: min-max → ×255 → uint8 →
THRESH_OTSU); here Otsu runs over a 256-bin histogram per map, every map
of a ``[K, ...]`` batch at once, in the JAX package's order of
operations.
"""

from __future__ import annotations

import torch


def otsu_threshold(image_u8: torch.Tensor) -> torch.Tensor:
    """Otsu threshold of each uint8-valued map of ``[K, ...]`` → ``[K]``
    float32. Foreground is ``value > t``, as cv2's THRESH_BINARY +
    THRESH_OTSU: the argmax of the between-class variance, the lowest t on
    ties."""
    K = image_u8.shape[0]
    flat = image_u8.reshape(K, -1).long()
    n = flat.shape[1]
    hist = torch.zeros((K, 256), dtype=torch.float32, device=flat.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.float32))
    bins = torch.arange(256, dtype=torch.float32, device=flat.device)
    w0 = torch.cumsum(hist, dim=1)                    # pixels ≤ t
    sum0 = torch.cumsum(hist * bins, dim=1)
    total = sum0[:, -1:]
    w1 = n - w0
    mu0 = sum0 / torch.clamp(w0, min=1.0)
    mu1 = (total - sum0) / torch.clamp(w1, min=1.0)
    between = w0 * w1 * (mu0 - mu1) ** 2
    between = torch.where((w0 > 0) & (w1 > 0), between,
                          torch.full_like(between, -1.0))
    return torch.argmax(between, dim=1).float()


def otsu_binarize(relevancy: torch.Tensor) -> torch.Tensor:
    """Each map of ``[K, ...]``: min-max normalise → ×255 → clip →
    truncating cast to uint8 → Otsu → binary float32 {0, 1} mask
    (mask_generator.py:116-121)."""
    K = relevancy.shape[0]
    flat = relevancy.reshape(K, -1)
    lo = flat.amin(dim=1)
    hi = flat.amax(dim=1)
    shape = (K,) + (1,) * (relevancy.dim() - 1)
    scaled = (relevancy - lo.reshape(shape)) \
        / torch.clamp(hi - lo, min=1e-12).reshape(shape) * 255.0
    u8 = torch.clamp(scaled, 0, 255).to(torch.uint8)
    t = otsu_threshold(u8)
    return (u8.float() > t.reshape(shape)).float()
