"""DETR train/eval augmentation — box+mask-aware transforms (C37).

The port's copy of ``transformer_mm_explainability_tpu/data/detr_transforms.py``,
a re-design of ``DETR/datasets/transforms.py (crop:16, hflip:59,
resize:76, pad:135, the Random* wrappers:148-258, Compose:261) and the
``make_coco_transforms`` recipe (``DETR/datasets/coco.py:115-144``).

Host-side numpy: images are HWC float arrays in [0, 1] (ToTensor is a
dtype/scale normalization, not a layout change here), targets are
dicts of numpy arrays {boxes xyxy, labels, area, iscrowd, masks?}.
Randomness comes from an explicit ``np.random.RandomState`` — never
global state — so epochs are reproducible per seed, and one seed makes
the JAX package's decisions here. The image resize is the port's
``ops/image.resize`` (bicubic, antialiased on a downscale, as
``jax.image.resize``); the device sees only the final padded batch.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

Target = Optional[Dict[str, np.ndarray]]

COCO_SCALES = (480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800)
COCO_MEAN = (0.485, 0.456, 0.406)
COCO_STD = (0.229, 0.224, 0.225)


def _interp_image(image: np.ndarray, size_hw: Tuple[int, int]
                  ) -> np.ndarray:
    import torch

    from transformer_mm_explainability_tpu_torch.ops.image import resize
    return resize(torch.from_numpy(np.ascontiguousarray(image, np.float32)),
                  tuple(size_hw)).numpy()


def crop(image: np.ndarray, target: Target,
         region: Tuple[int, int, int, int]):
    """transforms.py:16-56: crop the image, shift+clamp boxes, slice
    masks, drop zero-area elements."""
    i, j, h, w = region
    cropped = image[i:i + h, j:j + w]
    if target is None:
        return cropped, None
    target = dict(target)
    target["size"] = np.array([h, w])
    # fixed field list like the reference (transforms.py:25): "area" is
    # (re)created below, so it must be keep-filtered even when the
    # incoming target lacked it
    fields = [f for f in ("labels", "area", "iscrowd") if f in target]
    if "boxes" in target:
        if "area" not in fields:
            fields.append("area")
        boxes = np.asarray(target["boxes"], np.float32)
        cropped_boxes = boxes - np.array([j, i, j, i], np.float32)
        cropped_boxes = np.minimum(
            cropped_boxes.reshape(-1, 2, 2),
            np.array([w, h], np.float32))
        cropped_boxes = np.clip(cropped_boxes, 0, None)
        target["area"] = (cropped_boxes[:, 1] - cropped_boxes[:, 0]
                          ).prod(axis=1)
        target["boxes"] = cropped_boxes.reshape(-1, 4)
        fields.append("boxes")
    if "masks" in target:
        target["masks"] = target["masks"][:, i:i + h, j:j + w]
        fields.append("masks")
    if "boxes" in target or "masks" in target:
        if "boxes" in target:
            cb = target["boxes"].reshape(-1, 2, 2)
            keep = np.all(cb[:, 1] > cb[:, 0], axis=1)
        else:
            keep = target["masks"].reshape(
                target["masks"].shape[0], -1).any(axis=1)
        for f in fields:
            target[f] = target[f][keep]
    return cropped, target


def hflip(image: np.ndarray, target: Target):
    """transforms.py:59-73."""
    flipped = image[:, ::-1].copy()
    if target is None:
        return flipped, None
    w = image.shape[1]
    target = dict(target)
    if "boxes" in target:
        boxes = np.asarray(target["boxes"], np.float32)
        target["boxes"] = (boxes[:, [2, 1, 0, 3]]
                           * np.array([-1, 1, -1, 1], np.float32)
                           + np.array([w, 0, w, 0], np.float32))
    if "masks" in target:
        target["masks"] = target["masks"][..., ::-1].copy()
    return flipped, target


def get_size_with_aspect_ratio(image_hw: Tuple[int, int], size: int,
                               max_size: Optional[int] = None
                               ) -> Tuple[int, int]:
    """transforms.py:79-97 (note the reference works in (w, h))."""
    h, w = image_hw
    if max_size is not None:
        min_o, max_o = float(min(w, h)), float(max(w, h))
        if max_o / min_o * size > max_size:
            size = int(round(max_size * min_o / max_o))
    if (w <= h and w == size) or (h <= w and h == size):
        return (h, w)
    if w < h:
        ow = size
        oh = int(size * h / w)
    else:
        oh = size
        ow = int(size * w / h)
    return (oh, ow)


def resize(image: np.ndarray, target: Target, size,
           max_size: Optional[int] = None):
    """transforms.py:76-132: shortest-edge (or exact) resize with box/
    area scaling and nearest-mask interpolation."""
    if isinstance(size, (list, tuple)):
        new_hw = (size[1], size[0])  # reference passes (w, h) tuples
    else:
        new_hw = get_size_with_aspect_ratio(image.shape[:2], size,
                                            max_size)
    rescaled = _interp_image(image, new_hw)
    if target is None:
        return rescaled, None
    rh = new_hw[0] / image.shape[0]
    rw = new_hw[1] / image.shape[1]
    target = dict(target)
    if "boxes" in target:
        target["boxes"] = np.asarray(target["boxes"], np.float32) \
            * np.array([rw, rh, rw, rh], np.float32)
    if "area" in target:
        target["area"] = np.asarray(target["area"]) * (rw * rh)
    target["size"] = np.array(new_hw)
    if "masks" in target and target["masks"].shape[0]:
        m = target["masks"].astype(np.float32)
        idx_h = np.clip((np.arange(new_hw[0]) / rh).astype(int), 0,
                        m.shape[1] - 1)
        idx_w = np.clip((np.arange(new_hw[1]) / rw).astype(int), 0,
                        m.shape[2] - 1)
        target["masks"] = m[:, idx_h][:, :, idx_w] > 0.5
    elif "masks" in target:
        target["masks"] = np.zeros((0,) + tuple(new_hw), bool)
    return rescaled, target


def pad(image: np.ndarray, target: Target, padding: Tuple[int, int]):
    """transforms.py:135-145: bottom-right pad (padding = (x, y))."""
    px, py = padding
    padded = np.pad(image, ((0, py), (0, px), (0, 0)))
    if target is None:
        return padded, None
    target = dict(target)
    target["size"] = np.array(padded.shape[:2])
    if "masks" in target:
        target["masks"] = np.pad(target["masks"],
                                 ((0, 0), (0, py), (0, px)))
    return padded, target


class RandomCrop:
    def __init__(self, size, rng: Optional[np.random.RandomState] = None):
        self.size = size
        self.rng = rng or np.random.RandomState(0)

    def __call__(self, img, target):
        th, tw = self.size
        i = self.rng.randint(0, img.shape[0] - th + 1)
        j = self.rng.randint(0, img.shape[1] - tw + 1)
        return crop(img, target, (i, j, th, tw))


class RandomSizeCrop:
    """transforms.py:157-166."""

    def __init__(self, min_size: int, max_size: int,
                 rng: Optional[np.random.RandomState] = None):
        self.min_size, self.max_size = min_size, max_size
        self.rng = rng or np.random.RandomState(0)

    def __call__(self, img, target):
        w = self.rng.randint(self.min_size,
                             min(img.shape[1], self.max_size) + 1)
        h = self.rng.randint(self.min_size,
                             min(img.shape[0], self.max_size) + 1)
        i = self.rng.randint(0, img.shape[0] - h + 1)
        j = self.rng.randint(0, img.shape[1] - w + 1)
        return crop(img, target, (i, j, h, w))


class CenterCrop:
    """transforms.py:169-178."""

    def __init__(self, size):
        self.size = size

    def __call__(self, img, target):
        ih, iw = img.shape[:2]
        ch, cw = self.size
        top = int(round((ih - ch) / 2.0))
        left = int(round((iw - cw) / 2.0))
        return crop(img, target, (top, left, ch, cw))


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5,
                 rng: Optional[np.random.RandomState] = None):
        self.p = p
        self.rng = rng or np.random.RandomState(0)

    def __call__(self, img, target):
        if self.rng.random_sample() < self.p:
            return hflip(img, target)
        return img, target


class RandomResize:
    def __init__(self, sizes: Sequence[int],
                 max_size: Optional[int] = None,
                 rng: Optional[np.random.RandomState] = None):
        self.sizes = list(sizes)
        self.max_size = max_size
        self.rng = rng or np.random.RandomState(0)

    def __call__(self, img, target=None):
        size = self.sizes[self.rng.randint(len(self.sizes))]
        return resize(img, target, size, self.max_size)


class RandomPad:
    def __init__(self, max_pad: int,
                 rng: Optional[np.random.RandomState] = None):
        self.max_pad = max_pad
        self.rng = rng or np.random.RandomState(0)

    def __call__(self, img, target):
        px = self.rng.randint(0, self.max_pad + 1)
        py = self.rng.randint(0, self.max_pad + 1)
        return pad(img, target, (px, py))


class RandomSelect:
    """transforms.py:212-225."""

    def __init__(self, t1, t2, p: float = 0.5,
                 rng: Optional[np.random.RandomState] = None):
        self.t1, self.t2, self.p = t1, t2, p
        self.rng = rng or np.random.RandomState(0)

    def __call__(self, img, target):
        if self.rng.random_sample() < self.p:
            return self.t1(img, target)
        return self.t2(img, target)


class ToTensor:
    """transforms.py:228-230: integer [0,255] → float [0,1].  Keyed
    off DTYPE like torchvision's ToTensor (a value heuristic would
    silently skip the rescale on near-black integer images)."""

    def __call__(self, img, target):
        img = np.asarray(img)
        if np.issubdtype(img.dtype, np.integer):
            img = img.astype(np.float32) / 255.0
        return img.astype(np.float32), target


class Normalize:
    """transforms.py:242-258: normalize channels AND convert boxes to
    normalized cxcywh — the step DETR's criterion expects."""

    def __init__(self, mean=COCO_MEAN, std=COCO_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, image, target=None):
        image = (np.asarray(image, np.float32) - self.mean) / self.std
        if target is None:
            return image, None
        target = dict(target)
        h, w = image.shape[:2]
        if "boxes" in target:
            b = np.asarray(target["boxes"], np.float32)
            cxcywh = np.stack([(b[:, 0] + b[:, 2]) / 2,
                               (b[:, 1] + b[:, 3]) / 2,
                               b[:, 2] - b[:, 0],
                               b[:, 3] - b[:, 1]], axis=1)
            target["boxes"] = cxcywh / np.array([w, h, w, h], np.float32)
        return image, target


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, image, target):
        for t in self.transforms:
            image, target = t(image, target)
        return image, target


def make_coco_transforms(image_set: str, seed: int = 0) -> Compose:
    """DETR/datasets/coco.py:115-144."""
    rng = np.random.RandomState(seed)
    normalize = Compose([ToTensor(), Normalize()])
    scales = list(COCO_SCALES)
    if image_set == "train":
        return Compose([
            RandomHorizontalFlip(rng=rng),
            RandomSelect(
                RandomResize(scales, max_size=1333, rng=rng),
                Compose([
                    RandomResize([400, 500, 600], rng=rng),
                    RandomSizeCrop(384, 600, rng=rng),
                    RandomResize(scales, max_size=1333, rng=rng),
                ]),
                rng=rng),
            normalize,
        ])
    if image_set == "val":
        return Compose([RandomResize([800], max_size=1333, rng=rng),
                        normalize])
    raise ValueError(f"unknown {image_set}")
