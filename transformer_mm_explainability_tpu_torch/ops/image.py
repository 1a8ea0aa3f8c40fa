"""Image preprocessing in PyTorch, channel-last ``[H, W, C]``.

Counterpart of the resize / crop / normalise part of
``transformer_mm_explainability_tpu/ops/image.py`` and of its CLIP
pipeline (``clip_preprocess``). ``jax.image.resize``
uses the Keys cubic with a = -0.5 and antialiases when it shrinks;
``F.interpolate(mode="bicubic")`` uses a = -0.75 and no antialias unless
``antialias=True``, which selects the a = -0.5 separable filter scaled on
a downscale. So every resize here passes ``antialias=True``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def resize(image: torch.Tensor, size: Tuple[int, int],
           method: str = "bicubic") -> torch.Tensor:
    """[H, W, C] → [h, w, C]; method: "bilinear" | "bicubic"."""
    if method not in ("bilinear", "bicubic"):
        raise ValueError(f"resize method {method!r}: bilinear or bicubic")
    x = image.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=tuple(size), mode=method, align_corners=False,
                      antialias=True)
    return y[0].permute(1, 2, 0)


def resize_shortest_edge(image: torch.Tensor, shortest: int,
                         longest_cap: int = 0,
                         method: str = "bilinear") -> torch.Tensor:
    """Scale so the shortest side equals ``shortest``."""
    h, w = image.shape[:2]
    scale = shortest / min(h, w)
    if longest_cap and max(h, w) * scale > longest_cap:
        scale = longest_cap / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    return resize(image, (nh, nw), method)


def center_crop(image: torch.Tensor, size: int) -> torch.Tensor:
    h, w = image.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return image[top:top + size, left:left + size]


def normalize(image: torch.Tensor, mean: Sequence[float],
              std: Sequence[float]) -> torch.Tensor:
    mean = torch.as_tensor(mean, dtype=image.dtype, device=image.device)
    std = torch.as_tensor(std, dtype=image.dtype, device=image.device)
    return (image - mean) / std


def clip_preprocess(image: torch.Tensor, n_px: int = 224) -> torch.Tensor:
    """uint8 / float ``[H, W, 3]`` (RGB, 0-255 or 0-1) → normalised
    ``[n_px, n_px, 3]`` float32: bicubic resize of the shortest side to
    ``n_px``, centre crop, CLIP mean / std (``clip._transform``). A float
    image whose max exceeds 2 is taken as 0-255."""
    img = image.float()
    if image.dtype == torch.uint8 or float(img.max()) > 2.0:
        img = img / 255.0
    img = resize_shortest_edge(img, n_px, method="bicubic")
    return normalize(center_crop(img, n_px), CLIP_MEAN, CLIP_STD)
