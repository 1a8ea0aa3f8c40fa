"""FRCNN feature extraction → object TSV, on the PyTorch port.

Counterpart of ``transformer_mm_explainability_tpu/tools/extract_features.py``
(a re-design of the reference's BUTD extraction scripts,
``data/mscoco_imgfeat/extract_coco_image.py`` and its GQA / NLVR2 twins):
run the Faster R-CNN frontend (``models/frcnn``; RoIPool through the CUDA
kernel's wrapper, ``roi_pool_impl="pallas"``, on the card) over a folder
of images and write the FIELDNAMES base64 TSV (``lxmert/src/utils.py:
12-29``) that ``data/vqa.load_obj_tsv`` reads back.

    python -m transformer_mm_explainability_tpu_torch.tools.extract_features \\
        --img-root DIR --out feats.tsv [--checkpoint frcnn.pth] \\
        [--target-shortest 800] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import base64
import csv
import os
import sys
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from transformer_mm_explainability_tpu_torch._device import resolve_device

FIELDNAMES = ["img_id", "img_h", "img_w", "objects_id", "objects_conf",
              "attrs_id", "attrs_conf", "num_boxes", "boxes", "features"]

csv.field_size_limit(sys.maxsize)


def _b64(arr: np.ndarray, dtype) -> str:
    return base64.b64encode(
        np.ascontiguousarray(arr, dtype).tobytes()).decode("ascii")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def encode_row(img_id: str, img_h: int, img_w: int,
               out: Dict[str, object]) -> Dict[str, object]:
    """One detection output (tensors or arrays) → one TSV row; only the
    ``valid`` detections are written."""
    valid = _np(out["valid"]).astype(bool)
    n = int(valid.sum())
    return {
        "img_id": img_id,
        "img_h": img_h,
        "img_w": img_w,
        "objects_id": _b64(_np(out["obj_ids"])[valid], np.int64),
        "objects_conf": _b64(_np(out["obj_probs"])[valid], np.float32),
        "attrs_id": _b64(_np(out["attr_ids"])[valid], np.int64),
        "attrs_conf": _b64(_np(out["attr_probs"])[valid], np.float32),
        "num_boxes": n,
        "boxes": _b64(_np(out["boxes"])[valid], np.float32),
        "features": _b64(_np(out["roi_features"])[valid], np.float32),
    }


def extract_to_tsv(images: Iterable[Tuple[str, np.ndarray]],
                   out_path: str, params=None, cfg=None,
                   target_shortest: int = 800, seed: int = 0,
                   device="cuda") -> int:
    """Run FRCNN over ``(img_id, RGB uint8 HWC)`` pairs on ``device`` and
    append one row per image to ``out_path``. Random weights from ``seed``
    unless ``params`` are given (``utils/convert.frcnn_from_state_dict``).
    Returns the number of rows written."""
    from transformer_mm_explainability_tpu_torch.models import frcnn

    device = resolve_device(device)
    cfg = cfg or frcnn.FRCNN_VG
    if params is None:
        params = frcnn.init_params(seed, cfg, device)
    n_rows = 0
    with open(out_path, "a", newline="") as f:
        writer = csv.DictWriter(f, FIELDNAMES, delimiter="\t")
        for img_id, rgb in images:
            h, w = int(rgb.shape[0]), int(rgb.shape[1])
            pre = frcnn.preprocess(rgb, target_shortest=target_shortest,
                                   device=device)
            with torch.no_grad():
                out = frcnn.forward(params, pre, cfg)
            # boxes come back in preprocessed pixels; rescale to the
            # original image as the BUTD scripts do
            sy = h / float(pre.shape[0])
            sx = w / float(pre.shape[1])
            row_out = dict(out)
            row_out["boxes"] = _np(out["boxes"]) * np.asarray(
                [sx, sy, sx, sy], np.float32)
            writer.writerow(encode_row(str(img_id), h, w, row_out))
            n_rows += 1
    return n_rows


def iter_image_dir(img_root: str) -> Iterable[Tuple[str, np.ndarray]]:
    """BUTD load_image_ids convention: the stem is the image id."""
    from PIL import Image

    for name in sorted(os.listdir(img_root)):
        if not name.lower().endswith((".jpg", ".jpeg", ".png")):
            continue
        img_id = name.split(".")[0]
        yield img_id, np.asarray(
            Image.open(os.path.join(img_root, name)).convert("RGB"))


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Extract FRCNN object features into an object TSV")
    p.add_argument("--img-root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="frcnn-vg-finetuned state dict (.pth)")
    p.add_argument("--target-shortest", type=int, default=800)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    params = None
    if args.checkpoint:
        from transformer_mm_explainability_tpu_torch.models import frcnn
        from transformer_mm_explainability_tpu_torch.utils.convert import (
            frcnn_from_state_dict)
        sd = torch.load(args.checkpoint, map_location="cpu",
                        weights_only=False)
        params = frcnn_from_state_dict(sd, frcnn.FRCNN_VG, device)
    n = extract_to_tsv(iter_image_dir(args.img_root), args.out,
                       params=params, target_shortest=args.target_shortest,
                       device=device)
    print(f"wrote {n} rows to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
