"""OCR-region Faster R-CNN features for M4C/TextVQA, on the PyTorch port.

Counterpart of
``transformer_mm_explainability_tpu/tools/extract_ocr_features.py`` (a
re-design of ``VisualBERT/projects/m4c/scripts/extract_ocr_frcn_feature.py``):
for every imdb entry, take its OCR boxes (normalized xyxy × image size),
extract RoI features for EXACTLY those boxes (no RPN: the boxes are
forced, like the reference's ``input_boxes=`` path :93-113), and save
``<feature_path>.npy`` (features ``[K, 2048]``) and ``_info.npy``
({ocr_boxes, ocr_tokens}) per image (:165-189).

The feature head is the VG Faster R-CNN (``models/frcnn``): res4 backbone
→ RoIPool → res5 → mean-pool, 2048-d vectors. RoIPool is the one that
``cfg.roi_pool_impl`` names (``frcnn.roi_pool_fn``): by default the CUDA
kernel's wrapper (``ops/roi_pool_pallas``, ``csrc/roi_pool.cu``), one
launch per image that has OCR boxes, none for an image without; on a CPU
tensor its plain version. The JAX tool calls the plain ``frcnn.roi_pool``:
the same function, to the bit. OCR boxes are not detections: a box of zero
width or height, or one on the image's edge, is pooled by the same +1
convention as any other.

Box scaling follows extract_ocr_frcn_feature.py:50-56: scale the shortest
edge to ``target`` capped so the longest stays ≤ ``cap``, and multiply the
input boxes by the same scalar.

    python -m transformer_mm_explainability_tpu_torch.tools.extract_ocr_features \\
        --imdb_file imdb.npy --image_dir DIR --save_dir DIR \\
        [--checkpoint frcnn.pth] [--seed 0] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from transformer_mm_explainability_tpu_torch._device import resolve_device
from transformer_mm_explainability_tpu_torch.models import frcnn


def image_scale(h: int, w: int, target: int = 800,
                cap: int = 1333) -> float:
    """The shortest-edge scale with longest-edge cap, matching
    ``ops/image.resize_shortest_edge`` EXACTLY (the image is resized
    through it, so boxes must share its scale decision). Divergence
    pinned: extract_ocr_frcn_feature.py:50-56 applies ``np.round`` before
    comparing against the cap, which near the boundary (e.g. 600×1000 →
    scale·max = 1333.33 → round 1333) can pick a different branch than
    the resize itself."""
    scale = float(target) / float(min(h, w))
    if cap and max(h, w) * scale > cap:
        scale = float(cap) / float(max(h, w))
    return scale


def ocr_pool_inputs(params, image_u8: np.ndarray, boxes_xyxy: np.ndarray,
                    cfg: Optional[frcnn.FrcnnConfig] = None,
                    target: int = 800, cap: int = 1333
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoIPool's inputs for one image on the weights' device: the res4 map
    ``[Hf, Wf, 1024]`` of the preprocessed image and the ``[K, 4]`` pixel
    boxes of the raw image scaled to it."""
    cfg = cfg or frcnn.FRCNN_VG
    device = params["backbone"]["conv1"]["w"].device
    h, w = int(image_u8.shape[0]), int(image_u8.shape[1])
    scale = image_scale(h, w, target, cap)
    img = frcnn.preprocess(image_u8, target_shortest=target,
                           longest_cap=cap, device=device)
    feats = frcnn._res4_features(params, img[None], cfg)[0]
    boxes = torch.as_tensor(np.asarray(boxes_xyxy, np.float32),
                            device=device) * scale
    return feats, boxes


def ocr_roi_features(params, image_u8: np.ndarray, boxes_xyxy: np.ndarray,
                     cfg: Optional[frcnn.FrcnnConfig] = None,
                     target: int = 800, cap: int = 1333) -> np.ndarray:
    """``[K, 4]`` pixel boxes on the raw image → ``[K, 2048]`` RoI
    features (``[0, 2048]``, and no launch, for no boxes)."""
    cfg = cfg or frcnn.FRCNN_VG
    if boxes_xyxy.shape[0] == 0:
        return np.zeros((0, 2048), np.float32)
    with torch.no_grad():
        feats, boxes = ocr_pool_inputs(params, image_u8, boxes_xyxy, cfg,
                                       target, cap)
        rois = frcnn.roi_pool_fn(cfg)(feats, boxes, cfg.pooler_resolution,
                                      1.0 / cfg.feat_stride)
        return frcnn._res5_head(params, rois, cfg).cpu().numpy()


def dedupe_imdb(imdb) -> List[dict]:
    """extract_ocr_frcn_feature.py:166-168: one entry per image_id,
    sorted by id."""
    image_id2info = {info["image_id"]: info for info in imdb}
    return [image_id2info[k] for k in sorted(image_id2info)]


def extract_from_imdb(params, imdb, image_dir: str, save_dir: str,
                      cfg: Optional[frcnn.FrcnnConfig] = None,
                      target: int = 800, cap: int = 1333,
                      load_image=None) -> List[str]:
    """The reference main loop (:170-189). Returns the written feature
    paths. ``load_image``: path → RGB uint8 array (defaults to PIL)."""
    if load_image is None:
        from PIL import Image

        def load_image(p):
            return np.asarray(Image.open(p).convert("RGB"))

    written = []
    for info in dedupe_imdb(imdb):
        image_path = os.path.join(image_dir, info["image_path"])
        save_feat_path = os.path.join(save_dir, info["feature_path"])
        save_info_path = save_feat_path.replace(".npy", "_info.npy")
        os.makedirs(os.path.dirname(save_feat_path), exist_ok=True)

        w = info["image_width"]
        h = info["image_height"]
        ocr_boxes = (np.array(info["ocr_normalized_boxes"],
                              np.float32).reshape(-1, 4) * [w, h, w, h])
        ocr_tokens = info["ocr_tokens"]
        if len(ocr_boxes) > 0:
            feat = ocr_roi_features(params, load_image(image_path),
                                    ocr_boxes, cfg, target, cap)
        else:
            feat = np.zeros((0, 2048), np.float32)
        np.save(save_info_path,
                {"ocr_boxes": ocr_boxes, "ocr_tokens": ocr_tokens})
        np.save(save_feat_path, feat)
        written.append(save_feat_path)
    return written


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="frcnn-vg-finetuned state dict (.bin); "
                        "random weights from --seed if omitted")
    parser.add_argument("--imdb_file", type=str, required=True)
    parser.add_argument("--image_dir", type=str, required=True)
    parser.add_argument("--save_dir", type=str, required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    if args.checkpoint:
        from transformer_mm_explainability_tpu_torch.utils import convert

        sd = torch.load(args.checkpoint, map_location="cpu",
                        weights_only=False)
        params = convert.frcnn_from_state_dict(sd, frcnn.FRCNN_VG, device)
    else:
        params = frcnn.init_params(args.seed, frcnn.FRCNN_VG, device)

    imdb = np.load(args.imdb_file, allow_pickle=True)[1:]
    written = extract_from_imdb(params, imdb, args.image_dir, args.save_dir)
    print(f"wrote {len(written)} feature files to {args.save_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
