"""DETR per-detection relevancy demo (DETR.ipynb as a script), on the
PyTorch port.

    python -m transformer_mm_explainability_tpu_torch.examples.detr_explainability \\
        IMAGE [--checkpoint detr.pth] [--method ours_no_lrp] \\
        [--output-prefix P] [--device cuda|cpu]

Counterpart of the repo's ``examples/detr_explainability.py``: every
confident detection (probability > 0.5) is explained over the encoder
feature grid and binarised with Otsu into a mask (the notebook's cell 5,
the mask_generator pipeline), through ``harness/detr_segm.explain_image``:
all kept queries of the image in one forward and one batched backward.
The masks are painted onto the image (``P_masks.png``). Without
``--checkpoint`` a tiny random DETR runs on a small image (smoke mode).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="detr_explainability")
    ap.add_argument("image")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--method", default="ours_no_lrp",
                    help="any explain.detr.DETR_METHODS name "
                         "(ours_no_lrp, ours_with_lrp, raw_attn, rollout, "
                         "attn_gradcam, partial_lrp, transformer_att, ...)")
    ap.add_argument("--output-prefix", default="detr_expl")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from PIL import Image

    from transformer_mm_explainability_tpu_torch._device import resolve_device
    from transformer_mm_explainability_tpu_torch.harness import (detr_eval,
                                                                 detr_segm)
    from transformer_mm_explainability_tpu_torch.models import detr
    from transformer_mm_explainability_tpu_torch.utils import (
        visualization as viz)

    device = resolve_device(args.device)
    if args.checkpoint:
        from transformer_mm_explainability_tpu_torch.utils.clip_loader import (
            load_detr)

        params, cfg = load_detr(args.checkpoint, device=device)
        shortest, longest, max_det = 512, 800, 8
    else:
        print("note: no --checkpoint; tiny random model (smoke mode)")
        cfg = detr.DETRConfig(num_classes=91, num_queries=20, d_model=64,
                              nheads=8, num_encoder_layers=2,
                              num_decoder_layers=2, dim_feedforward=128)
        params = detr.init_params(0, cfg, device)
        shortest, longest, max_det = 128, 256, 4

    raw = np.asarray(Image.open(args.image).convert("RGB"))
    img, valid = detr_eval.prepare_image(raw, shortest=shortest,
                                         longest=longest, device=device)
    out = detr_segm.explain_image(
        params, img, cfg,
        detr_segm.SegmConfig(method=args.method, max_detections=max_det,
                             confidence_threshold=0.5),
        pad_valid=valid)
    print(f"{len(out['query_idx'])} detections above threshold")
    shown = img.cpu().numpy()
    overlay = viz.mask_overlay(
        (shown - shown.min()) / (shown.max() - shown.min()) * 255,
        out["masks"])
    Image.fromarray(overlay).save(f"{args.output_prefix}_masks.png")
    print(f"masks -> {args.output_prefix}_masks.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
