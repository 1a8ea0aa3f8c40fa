"""Relevancy figures: the heatmap overlay (the notebooks'
``generate_visualization``), a per-token text heatmap and a box overlay.

Counterpart of ``relevancy_figure``, ``text_heatmap_html`` and
``draw_boxes`` and what they need from
``transformer_mm_explainability_tpu/utils/visualization.py`` and
``ops/image.py``; numpy in, numpy out.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from transformer_mm_explainability_tpu_torch.ops.image import resize


def jet_colormap(x: np.ndarray) -> np.ndarray:
    """values in [0,1] → RGB in [0,1] (cv2 COLORMAP_JET equivalent)."""
    x = np.clip(x, 0.0, 1.0)
    four_x = 4.0 * x
    r = np.clip(np.minimum(four_x - 1.5, -four_x + 4.5), 0, 1)
    g = np.clip(np.minimum(four_x - 0.5, -four_x + 3.5), 0, 1)
    b = np.clip(np.minimum(four_x + 0.5, -four_x + 2.5), 0, 1)
    return np.stack([r, g, b], axis=-1)


def show_cam_on_image(image: np.ndarray, cam: np.ndarray) -> np.ndarray:
    """Overlay a [H, W] map on a [H, W, 3] image in [0,1]: heatmap + image,
    divided by its max."""
    out = jet_colormap(cam) + image.astype(np.float32)
    return out / out.max()


def min_max_normalize(x: np.ndarray) -> np.ndarray:
    """(x - min) / (max - min) over the whole array."""
    return (x - x.min()) / (x.max() - x.min())


def upsample_relevancy(rel: np.ndarray, grid_hw: Tuple[int, int],
                       out_hw: Tuple[int, int]) -> np.ndarray:
    """[N_patches] patch relevancy → bilinear [H, W] heatmap."""
    rel2d = torch.as_tensor(np.asarray(rel, np.float32)).reshape(
        *grid_hw, 1)
    return resize(rel2d, out_hw, "bilinear")[..., 0].numpy()


def relevancy_figure(image: np.ndarray, relevancy: np.ndarray,
                     grid_hw: Tuple[int, int]) -> np.ndarray:
    """Patch relevancy → upsampled, min-max normalised JET overlay on the
    image. Returns uint8 RGB."""
    H, W = image.shape[:2]
    up = min_max_normalize(upsample_relevancy(relevancy, grid_hw, (H, W)))
    img = image.astype(np.float32)
    img = (img - img.min()) / max(img.max() - img.min(), 1e-9)
    return (show_cam_on_image(img, up) * 255).astype(np.uint8)


def text_heatmap_html(tokens: Sequence[str], scores: Sequence[float],
                      title: str = "") -> str:
    """Per-token heatmap (green-shaded spans, captum-style), min-max
    normalised."""
    scores = np.asarray(scores, np.float32)
    if scores.max() > scores.min():
        norm = (scores - scores.min()) / (scores.max() - scores.min())
    else:
        norm = np.zeros_like(scores)
    spans = "".join(
        f'<span style="background-color: rgba(0, 180, 0, {a:.2f}); '
        f'padding: 1px 2px; margin: 1px; border-radius: 2px;">{t}</span>'
        for t, a in zip(tokens, norm))
    head = f"<b>{title}</b><br>" if title else ""
    return f'<div style="font-family: monospace">{head}{spans}</div>'


def draw_boxes(image: np.ndarray, boxes_xyxy: np.ndarray,
               labels: Optional[List[str]] = None,
               scores: Optional[np.ndarray] = None,
               width: int = 2) -> np.ndarray:
    """Box overlay with PIL on a uint8 ``[H, W, 3]`` image, boxes in
    pixels, each with its label and / or score."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(image.astype(np.uint8))
    draw = ImageDraw.Draw(img)
    palette = [(255, 64, 64), (64, 160, 255), (64, 220, 64),
               (255, 180, 40), (200, 90, 255), (255, 120, 200)]
    for i, box in enumerate(np.asarray(boxes_xyxy)):
        color = palette[i % len(palette)]
        draw.rectangle([float(box[0]), float(box[1]),
                        float(box[2]), float(box[3])],
                       outline=color, width=width)
        text = None if labels is None else labels[i]
        if scores is not None:
            s = f"{float(scores[i]):.2f}"
            text = f"{text} {s}" if text else s
        if text:
            draw.text((float(box[0]) + 2, float(box[1]) + 2), text,
                      fill=color)
    return np.asarray(img)
