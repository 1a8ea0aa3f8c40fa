"""Relevancy figures: the heatmap overlay (the notebooks'
``generate_visualization``), a per-token text heatmap, a box overlay, an
instance-mask overlay, an image grid and the training-log plots.

Counterpart of ``transformer_mm_explainability_tpu/utils/visualization.py``
(``relevancy_figure``, ``text_heatmap_html``, ``draw_boxes``,
``mask_overlay``, ``make_grid``, ``visualize_images``, ``load_scalar_logs``,
``plot_logs``) and what they need from ``ops/image.py``; numpy in, numpy
out, matplotlib only behind ``show=True``.
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


def mask_overlay(image: np.ndarray, masks: np.ndarray,
                 alpha: float = 0.5) -> np.ndarray:
    """Instance-mask overlay: ``[K, H, W]`` binary masks tinted one colour
    per instance over an ``[H, W, 3]`` image. Returns uint8."""
    out = image.astype(np.float32).copy()
    palette = np.asarray([(255, 64, 64), (64, 160, 255), (64, 220, 64),
                          (255, 180, 40), (200, 90, 255)], np.float32)
    for i, m in enumerate(np.asarray(masks)):
        color = palette[i % len(palette)]
        out = np.where(m[..., None] > 0.5,
                       (1 - alpha) * out + alpha * color, out)
    return np.clip(out, 0, 255).astype(np.uint8)


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """torchvision.utils.make_grid semantics on [N, H, W, C] numpy:
    row-major tiling with ``padding`` pixels between cells."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nr = -(-n // ncol)
    grid = np.full((nr * (h + padding) + padding,
                    ncol * (w + padding) + padding, c), pad_value,
                   images.dtype)
    for idx in range(n):
        r, col = divmod(idx, ncol)
        y, x = r * (h + padding) + padding, col * (w + padding) + padding
        grid[y:y + h, x:x + w] = images[idx]
    return grid


def visualize_images(images, size=(224, 224), nrow: int = 8,
                     show: bool = False) -> np.ndarray:
    """mmf/utils/visualize.py:9-47: each image (HWC array or PIL image;
    integers scaled by 1/255) resized to ``size`` (bicubic, ``ops/image``)
    and tiled into a grid; drawn with matplotlib where ``show``. Returns
    the grid array."""
    assert size is not None or len(images) == 1, (
        "If size is not passed, only one image can be visualized")
    arrays = []
    for im in images:
        arr = np.asarray(im)
        if np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(np.float32) / 255.0
        arr = arr.astype(np.float32)
        if size is not None and arr.shape[:2] != tuple(size):
            arr = resize(torch.from_numpy(np.ascontiguousarray(arr)),
                         tuple(size)).numpy()
        arrays.append(arr)
    grid = make_grid(np.stack(arrays), nrow=nrow)
    if show:  # pragma: no cover - display path
        import matplotlib.pyplot as plt
        plt.axis("off")
        plt.imshow(grid)
    return grid


def load_scalar_logs(log_dirs, log_name: str = "scalars.jsonl"):
    """One or more ``ScalarLogger`` jsonl streams → {dir: {field: (steps,
    values)}}: the data layer of DETR's ``util/plot_utils.plot_logs``
    without pandas. Non-numeric fields, ``step`` and ``time`` are left
    out."""
    import json
    import os

    if isinstance(log_dirs, (str, os.PathLike)):
        log_dirs = [log_dirs]
    out = {}
    for d in log_dirs:
        series: dict = {}
        with open(os.path.join(str(d), log_name)) as f:
            for line in f:
                rec = json.loads(line)
                step = rec.get("step", 0)
                for k, v in rec.items():
                    if k in ("step", "time") or not isinstance(v,
                                                               (int, float)):
                        continue
                    steps, values = series.setdefault(k, ([], []))
                    steps.append(step)
                    values.append(float(v))
        out[str(d)] = series
    return out


def plot_logs(log_dirs, fields=("loss",), ewm_alpha: float = 0.0,
              log_name: str = "scalars.jsonl", show: bool = False):
    """DETR's ``plot_logs`` (util/plot_utils.py:13-70) over ``ScalarLogger``
    streams: per field and log dir its (steps, values), exponentially
    smoothed with ``ewm_alpha`` > 0 (acc ← α·acc + (1 − α)·v); one
    matplotlib subplot per field where ``show``. Returns {dir: {field:
    (steps, values)}}, so that callers can check it without a display."""
    smoothed = {}
    for d, series in load_scalar_logs(log_dirs, log_name).items():
        smoothed[d] = {}
        for field in fields:
            if field not in series:
                continue
            steps, vals = series[field]
            if ewm_alpha > 0:
                acc, out = None, []
                for v in vals:
                    acc = v if acc is None else (
                        ewm_alpha * acc + (1 - ewm_alpha) * v)
                    out.append(acc)
                vals = out
            smoothed[d][field] = (steps, vals)
    if show:  # pragma: no cover - display path
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, len(fields), figsize=(5 * len(fields), 4))
        axes = [axes] if len(fields) == 1 else axes
        for ax, field in zip(axes, fields):
            for d in smoothed:
                if field in smoothed[d]:
                    ax.plot(*smoothed[d][field], label=d)
            ax.set_title(field)
            ax.legend()
    return smoothed
