"""LXMERT bi-modal explainability demo (the reference's flagship notebook),
on the PyTorch port.

    python -m transformer_mm_explainability_tpu_torch.examples.lxmert_explainability \\
        IMAGE "what is the question?" [--device cuda|cpu] [--full-width] \\
        [--frcnn-checkpoint pytorch_model.bin] [--checkpoint lxmert_vqa.pth \\
        --bert-vocab vocab.txt --label2ans trainval_label2ans.json] \\
        [--method ours_no_lrp] [--output-prefix PREFIX]

Counterpart of the repo's ``examples/lxmert_explainability.py``:

  image → Faster R-CNN (``models/frcnn``: 36 boxes + 2048-d features, the
          RoIPool kernel on the card)
        → LXMERT VQA forward + one backward (``models/lxmert.capture``)
        → bi-modal relevancy of the PREDICTED answer
          (``LxmertPerturbationRunner.explain_batched``)
        → per-box heatmap painted onto the photo (``PREFIX_image.png``) and
          a per-token text heatmap (``PREFIX_text.html``).

Without checkpoints the weights are random (smoke mode): a tiny FRCNN on a
128-pixel image, as the JAX example runs, and the full-width LXMERT_VQA;
``--full-width`` runs FRCNN_VG at 800 pixels as well, and
``--tiny-lxmert`` swaps in the tiny LXMERT of ``cli perturbation``'s
synthetic run (with 2048-d visual features) for a quick check on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional

import numpy as np
import torch

# the JAX example's smoke FRCNN
TINY_FRCNN = dict(stages=(1, 1, 1, 1), anchor_sizes=(32, 64),
                  aspect_ratios=(1.0,), pre_nms_topk=50, post_nms_topk=12,
                  pooler_resolution=4, num_classes=9, num_attrs=5,
                  max_detections=8, score_thresh=0.0)
MAX_BOXES = 36


def boxes_to_pixel_cam(boxes_xyxy: np.ndarray, rel: np.ndarray,
                       h: int, w: int) -> np.ndarray:
    """Per-box relevancy → [H, W] map: each box painted with its score,
    the max where boxes overlap, min-max normalised."""
    cam = np.zeros((h, w), np.float32)
    for box, r in zip(boxes_xyxy, rel):
        x1, y1, x2, y2 = [int(round(float(v))) for v in box]
        x1, y1 = max(x1, 0), max(y1, 0)
        x2, y2 = min(x2, w), min(y2, h)
        if x2 > x1 and y2 > y1:
            cam[y1:y2, x1:x2] = np.maximum(cam[y1:y2, x1:x2], float(r))
    if cam.max() > cam.min():
        cam = (cam - cam.min()) / (cam.max() - cam.min())
    return cam


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="lxmert_explainability")
    ap.add_argument("image")
    ap.add_argument("question")
    ap.add_argument("--method", default="ours_no_lrp",
                    help="a harness.pert_runner.LXMERT_METHODS name")
    ap.add_argument("--frcnn-checkpoint", default=None,
                    help="unc-nlp/frcnn-vg-finetuned pytorch_model.bin")
    ap.add_argument("--checkpoint", default=None,
                    help="LXMERT VQA torch checkpoint")
    ap.add_argument("--bert-vocab", default=None,
                    help="bert-base-uncased vocab.txt")
    ap.add_argument("--label2ans", default=None,
                    help="trainval_label2ans.json (answer strings)")
    ap.add_argument("--output-prefix", default="lxmert_expl")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--full-width", action="store_true",
                    help="FRCNN_VG at 800 px without a checkpoint")
    ap.add_argument("--tiny-lxmert", action="store_true",
                    help="the tiny random LXMERT (no --checkpoint)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from PIL import Image

    from transformer_mm_explainability_tpu_torch._device import resolve_device
    from transformer_mm_explainability_tpu_torch.data.tokenization import (
        BertTokenizer)
    from transformer_mm_explainability_tpu_torch.harness import pert_runner
    from transformer_mm_explainability_tpu_torch.models import frcnn
    from transformer_mm_explainability_tpu_torch.models import lxmert as lx
    from transformer_mm_explainability_tpu_torch.utils import convert
    from transformer_mm_explainability_tpu_torch.utils import (
        visualization as viz)

    device = resolve_device(args.device)
    rgb = np.asarray(Image.open(args.image).convert("RGB"))
    h, w = rgb.shape[:2]

    # --- visual frontend ----------------------------------------------------
    if args.frcnn_checkpoint:
        fcfg, shortest = frcnn.FRCNN_VG, 800
        fparams = convert.frcnn_from_state_dict(
            torch.load(args.frcnn_checkpoint, map_location="cpu"), fcfg,
            device)
    elif args.full_width:
        print("note: no --frcnn-checkpoint; random FRCNN_VG (smoke mode)")
        fcfg, shortest = frcnn.FRCNN_VG, 800
        fparams = frcnn.init_params(0, fcfg, device)
    else:
        print("note: no --frcnn-checkpoint; tiny random FRCNN (smoke mode)")
        fcfg, shortest = frcnn.FrcnnConfig(**TINY_FRCNN), 128
        fparams = frcnn.init_params(0, fcfg, device)
    pre = frcnn.preprocess(rgb, target_shortest=shortest, device=device)
    with torch.no_grad():
        det = {k: v.cpu().numpy()
               for k, v in frcnn.forward(fparams, pre, fcfg).items()}
    valid = det["valid"].astype(bool)
    n = int(valid.sum())
    print(f"FRCNN: {n} detections")
    sy, sx = h / float(pre.shape[0]), w / float(pre.shape[1])
    boxes_px = det["boxes"] * np.asarray([sx, sy, sx, sy], np.float32)
    if n == 0:
        # random weights can leave no surviving proposal: a box grid keeps
        # the rendering path in use
        print("note: no surviving proposals; using a 2x4 box grid")
        gy, gx = 2, 4
        m = det["roi_features"].shape[0]
        boxes_px = np.zeros((m, 4), np.float32)
        boxes_px[:gy * gx] = [[j * w / gx, i * h / gy, (j + 1) * w / gx,
                               (i + 1) * h / gy]
                              for i in range(gy) for j in range(gx)]
        det["normalized_boxes"] = boxes_px / np.asarray([w, h, w, h],
                                                        np.float32)
        valid = np.arange(m) < gy * gx
        n = gy * gx

    # pad / clip to the LXMERT visual span (36), like the TSV pipeline
    k = min(n, MAX_BOXES)
    feats = np.zeros((MAX_BOXES, 2048), np.float32)
    pos = np.zeros((MAX_BOXES, 4), np.float32)
    feats[:k] = det["roi_features"][valid][:k]
    pos[:k] = det["normalized_boxes"][valid][:k]

    # --- language side ------------------------------------------------------
    if args.bert_vocab:
        tok = BertTokenizer(vocab_path=args.bert_vocab)
    else:
        words = args.question.lower().replace("?", " ?").split()
        tok = BertTokenizer(vocab={t: i for i, t in enumerate(
            ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
            + sorted(set(words)))})
    enc = tok.encode_vqa(args.question, max_len=20)
    st = int(enc["input_mask"].sum())
    tokens = [tok.inv.get(int(i), "?") for i in enc["input_ids"][:st]]

    # --- LXMERT + relevancy -------------------------------------------------
    label2ans = None
    if args.label2ans:
        with open(args.label2ans) as f:
            label2ans = json.load(f)
    num_labels = len(label2ans) if label2ans else 3129
    if args.tiny_lxmert:
        cfg = lx.LxmertConfig(**dict(pert_runner.SMOKE_LXMERT,
                                     visual_feat_dim=2048,
                                     vocab_size=max(100, len(tok.vocab))))
    else:
        cfg = dataclasses.replace(lx.LXMERT_VQA, num_qa_labels=num_labels)
    if args.checkpoint:
        params = pert_runner._load_lx(args.checkpoint, cfg, device)
    else:
        print("note: no --checkpoint; random LXMERT (smoke mode)")
        params = lx.init_params(1, cfg, device)
    runner = pert_runner.LxmertPerturbationRunner(params, cfg, args.method,
                                                  device=device)
    batch = {
        "input_ids": enc["input_ids"][None],
        "attention_mask": enc["input_mask"][None],
        "visual_feats": feats[None],
        "visual_pos": pos[None],
        "visual_mask": (np.arange(MAX_BOXES) < k)[None].astype(np.int32),
    }
    scores, cam_text, cam_image = runner.explain_batched(batch)
    pred = int(np.argmax(scores[0]))
    answer = label2ans[pred] if label2ans else f"label #{pred}"
    print(f"Q: {args.question}")
    print(f"A: {answer}")

    # --- render -------------------------------------------------------------
    shown = boxes_px[valid][:k]
    rel = cam_image[0][:k]
    cam = boxes_to_pixel_cam(shown, rel, h, w)
    overlay = (viz.show_cam_on_image(rgb.astype(np.float32) / 255.0, cam)
               * 255).astype(np.uint8)
    top = np.argsort(rel)[::-1][:min(5, k)]
    overlay = viz.draw_boxes(overlay, shown[top], scores=rel[top])
    Image.fromarray(overlay).save(f"{args.output_prefix}_image.png")
    print(f"image relevancy -> {args.output_prefix}_image.png")
    html = viz.text_heatmap_html(tokens, cam_text[0][:st],
                                 title=f"{args.question} → {answer} "
                                       f"({args.method})")
    with open(f"{args.output_prefix}_text.html", "w") as f:
        f.write(html)
    print(f"text relevancy  -> {args.output_prefix}_text.html")
    return 0


if __name__ == "__main__":
    sys.exit(main())
