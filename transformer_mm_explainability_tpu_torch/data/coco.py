"""COCO dataset layer (DETR/datasets/coco.py + pycocotools-free mask
utilities, C29/C37).

The port's own copy of ``transformer_mm_explainability_tpu/data/coco.py``
(importing that module would import the JAX package); the panoptic
targets' boxes come from the port's ``utils/box_ops``.

  * annotation reading from instances json (images/annotations/cats),
  * polygon → binary mask rasterisation (PIL), COCO uncompressed RLE
    and compressed-RLE decoding (own implementation — pycocotools is
    not in this image),
  * DETR-style target dicts (boxes cxcywh normalised, labels, masks),
  * the val-loader protocol used by the explanation-segmentation
    harness (harness/detr_segm.py).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np


def decode_compressed_rle(counts: str, h: int, w: int) -> np.ndarray:
    """COCO compressed RLE string → [h, w] binary mask (column-major
    runs, LEB128-style varint encoding with sign folding)."""
    runs: List[int] = []
    i = 0
    prev = 0
    while i < len(counts):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(counts[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(runs) > 2:
            x += runs[-2]
        runs.append(x)
        prev = x
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for run in runs:
        flat[pos:pos + run] = val
        pos += run
        val = 1 - val
    return flat.reshape(w, h).T  # column-major


def decode_uncompressed_rle(counts: List[int], h: int, w: int) -> np.ndarray:
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for run in counts:
        flat[pos:pos + run] = val
        pos += run
        val = 1 - val
    return flat.reshape(w, h).T


def polygons_to_mask(polygons: List[List[float]], h: int, w: int
                     ) -> np.ndarray:
    """COCO polygon segmentation → [h, w] binary mask via PIL."""
    from PIL import Image, ImageDraw

    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, np.uint8)


def annotation_to_mask(ann: Dict[str, Any], h: int, w: int) -> np.ndarray:
    seg = ann.get("segmentation")
    if seg is None:
        return np.zeros((h, w), np.uint8)
    if isinstance(seg, list):
        return polygons_to_mask(seg, h, w)
    counts = seg["counts"]
    sh, sw = seg["size"]
    if isinstance(counts, str):
        return decode_compressed_rle(counts, sh, sw)
    return decode_uncompressed_rle(counts, sh, sw)


class CocoDetection:
    """instances_val2017-style annotation reader producing DETR-style
    targets (datasets/coco.py ConvertCocoPolysToMask semantics)."""

    def __init__(self, annotation_path: str, image_root: Optional[str] = None,
                 return_masks: bool = True):
        data = json.load(open(annotation_path))
        self.image_root = image_root
        self.return_masks = return_masks
        self.images = {im["id"]: im for im in data["images"]}
        self.image_ids = sorted(self.images)
        # training targets drop crowds (ConvertCocoPolysToMask,
        # DETR/datasets/coco.py:62) — but the EVALUATOR must still see
        # them as ignore regions (pycocotools crowd semantics), so
        # crowds are kept in a parallel channel (eval_annotations)
        self.anns_by_image: Dict[int, List[Dict]] = {
            i: [] for i in self.image_ids}
        self.crowd_anns_by_image: Dict[int, List[Dict]] = {
            i: [] for i in self.image_ids}
        for ann in data["annotations"]:
            if ann.get("iscrowd", 0):
                self.crowd_anns_by_image.setdefault(
                    ann["image_id"], []).append(ann)
                continue
            self.anns_by_image.setdefault(ann["image_id"], []).append(ann)
        self.categories = {c["id"]: c["name"]
                           for c in data.get("categories", [])}

    def __len__(self) -> int:
        return len(self.image_ids)

    def load_image(self, image_id: int) -> np.ndarray:
        import os

        from PIL import Image

        info = self.images[image_id]
        path = os.path.join(self.image_root or "", info["file_name"])
        return np.asarray(Image.open(path).convert("RGB"))

    def target(self, image_id: int) -> Dict[str, np.ndarray]:
        info = self.images[image_id]
        h, w = info["height"], info["width"]
        anns = self.anns_by_image.get(image_id, [])
        boxes = np.asarray([a["bbox"] for a in anns],
                           np.float32).reshape(-1, 4)
        # xywh → xyxy, clip
        boxes[:, 2:] += boxes[:, :2]
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
        labels = np.asarray([a["category_id"] for a in anns], np.int64)
        keep = (boxes[:, 3] > boxes[:, 1]) & (boxes[:, 2] > boxes[:, 0])
        iscrowd = np.asarray([int(a.get("iscrowd", 0)) for a in anns],
                             np.int64)
        area = np.asarray([float(a.get("area",
                                       a["bbox"][2] * a["bbox"][3]))
                           for a in anns], np.float64)
        out: Dict[str, np.ndarray] = {
            "image_id": np.asarray(image_id),
            "orig_size": np.asarray([h, w]),
            "boxes_xyxy": boxes[keep],
            "labels": labels[keep],
            "iscrowd": iscrowd[keep],
            "area": area[keep],
        }
        # normalised cxcywh (the training target format)
        b = boxes[keep]
        cxcywh = np.stack([
            (b[:, 0] + b[:, 2]) / 2 / w, (b[:, 1] + b[:, 3]) / 2 / h,
            (b[:, 2] - b[:, 0]) / w, (b[:, 3] - b[:, 1]) / h], axis=1)
        out["boxes"] = cxcywh.astype(np.float32)
        if self.return_masks:
            masks = [annotation_to_mask(a, h, w) for a in anns]
            masks = (np.stack(masks) if masks
                     else np.zeros((0, h, w), np.uint8))
            out["masks"] = masks[keep]
        return out


def eval_ground_truths(dataset: "CocoDetection", image_id: int
                       ) -> List[Dict]:
    """The evaluator-side GT list for one image: non-crowd AND crowd
    annotations (pycocotools evaluates against the full GT; crowds act
    as ignore regions in harness/coco_eval).  Each entry carries
    ``category_id``, ``iscrowd``, ``area``, ``bbox`` (xywh) and the
    decoded ``mask`` when segmentation is present."""
    info = dataset.images[image_id]
    h, w = info["height"], info["width"]
    out: List[Dict] = []
    for ann in (dataset.anns_by_image.get(image_id, [])
                + dataset.crowd_anns_by_image.get(image_id, [])):
        entry = {
            "category_id": ann["category_id"],
            "iscrowd": int(ann.get("iscrowd", 0)),
            "area": float(ann.get("area",
                                  ann["bbox"][2] * ann["bbox"][3])),
            "bbox": list(ann["bbox"]),
        }
        if "segmentation" in ann:
            entry["mask"] = annotation_to_mask(ann, h, w)
        out.append(entry)
    return out


def rgb2id(color: np.ndarray) -> np.ndarray:
    """panopticapi.utils.rgb2id: RGB PNG channels → segment ids."""
    color = np.asarray(color, np.int64)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


class CocoPanoptic:
    """DETR/datasets/coco_panoptic.py:15-77: panoptic annotation json +
    id-map PNGs → per-image targets (binary masks per segment, labels,
    boxes from mask support, iscrowd/area).  Images and annotations are
    id-sorted and filename-aligned like the reference."""

    def __init__(self, img_folder: str, ann_folder: str, ann_file: str,
                 return_masks: bool = True):
        with open(ann_file) as f:
            self.coco = json.load(f)
        self.coco["images"] = sorted(self.coco["images"],
                                     key=lambda x: x["id"])
        if "annotations" in self.coco:
            for img, ann in zip(self.coco["images"],
                                self.coco["annotations"]):
                assert img["file_name"][:-4] == ann["file_name"][:-4]
        self.img_folder = img_folder
        self.ann_folder = ann_folder
        self.return_masks = return_masks

    def __len__(self) -> int:
        return len(self.coco["images"])

    def get_height_and_width(self, idx: int):
        info = self.coco["images"][idx]
        return info["height"], info["width"]

    def load_image(self, idx: int) -> np.ndarray:
        import os

        from PIL import Image

        ann_info = (self.coco["annotations"][idx]
                    if "annotations" in self.coco
                    else self.coco["images"][idx])
        path = os.path.join(self.img_folder,
                            ann_info["file_name"].replace(".png", ".jpg"))
        return np.asarray(Image.open(path).convert("RGB"))

    def target(self, idx: int) -> Dict[str, np.ndarray]:
        import os

        from PIL import Image

        import torch

        from transformer_mm_explainability_tpu_torch.utils.box_ops import (
            masks_to_boxes)

        ann_info = (self.coco["annotations"][idx]
                    if "annotations" in self.coco
                    else self.coco["images"][idx])
        h, w = self.get_height_and_width(idx)
        target: Dict[str, np.ndarray] = {
            "image_id": np.asarray(
                [ann_info.get("image_id", ann_info.get("id"))]),
            "size": np.asarray([h, w]),
            "orig_size": np.asarray([h, w]),
        }
        if "segments_info" in ann_info:
            id_map = rgb2id(np.asarray(Image.open(
                os.path.join(self.ann_folder, ann_info["file_name"]))))
            ids = np.asarray([s["id"]
                              for s in ann_info["segments_info"]])
            masks = (id_map[None] == ids[:, None, None]).astype(np.uint8)
            target["labels"] = np.asarray(
                [s["category_id"] for s in ann_info["segments_info"]],
                np.int64)
            if self.return_masks:
                target["masks"] = masks
            target["boxes"] = masks_to_boxes(
                torch.from_numpy(masks)).numpy()
            for name in ("iscrowd", "area"):
                target[name] = np.asarray(
                    [s[name] for s in ann_info["segments_info"]])
        return target
