"""Image preprocessing in PyTorch, channel-last ``[H, W, C]``.

Counterpart of the resize / crop / normalise / pad part of
``transformer_mm_explainability_tpu/ops/image.py``, of its CLIP pipeline
(``clip_preprocess``) and of the DETR pipeline's pieces (``pad_to``, the
ImageNet statistics, and ``resize_linear``, the linear resize that
``jax.image.resize(..., "linear")`` performs). ``jax.image.resize``
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
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


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


def pad_to(image: torch.Tensor, height: int, width: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad ``[H, W, ...]`` with zeros at the bottom and right to
    ``(height, width)``; returns ``(padded, valid)`` with ``valid`` a
    float32 ``[height, width]`` mask, 1 on the real pixels (DETR's
    NestedTensor contract)."""
    h, w = image.shape[:2]
    padded = image.new_zeros((height, width) + tuple(image.shape[2:]))
    padded[:h, :w] = image
    valid = torch.zeros((height, width), dtype=torch.float32,
                        device=image.device)
    valid[:h, :w] = 1.0
    return padded, valid


def _linear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """``[n_out, n_in]`` weights of ``jax.image.resize``'s linear kernel
    along one axis (``compute_weight_mat``: half-pixel sample positions,
    the triangle kernel widened by the inverse scale when shrinking,
    weights normalised by their sum, zero outside the input), in float32
    as JAX computes them."""
    f32 = torch.float32
    inv = torch.tensor(1.0 / (n_out / n_in), dtype=f32)
    kernel_scale = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n_out, dtype=f32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs() \
        / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).T.to(device)


def resize_linear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Linear resize of the last two axes of ``x`` (``[..., H, W]``) to
    ``out_hw``, as ``jax.image.resize(x, (..., *out_hw), "linear")`` with
    its default antialias: one weight matrix per resized axis, an axis of
    unchanged size left as it is."""
    H, W = x.shape[-2:]
    oh, ow = out_hw
    y = x.float()
    if oh != H:
        y = _linear_weights(H, oh, x.device) @ y
    if ow != W:
        y = y @ _linear_weights(W, ow, x.device).T
    return y
