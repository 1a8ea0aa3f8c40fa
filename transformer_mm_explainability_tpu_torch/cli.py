"""Command-line entry point of the PyTorch port.

    python -m transformer_mm_explainability_tpu_torch.cli explain-vit IMG \
        [--checkpoint CKPT] [--class-index N] [--output PNG] [--seed S] \
        [--device cuda|cpu]
    python -m transformer_mm_explainability_tpu_torch.cli perturbation \
        --model lxmert [--method ours_no_lrp] [--num-samples N] \
        [--is-positive-pert BOOL] [--is-text-pert BOOL] [--questions JSON \
        --features TSV --ans2label JSON --label2ans JSON --bert-vocab TXT] \
        [--checkpoint CKPT] [--seed S] [--device cuda|cpu]

``explain-vit`` computes the ViT-B/16 relevancy map through
``models/vit.relevancy_fused_block2`` (the block kernels on CUDA, their
plain versions on the CPU) and writes the overlay figure. Without
``--checkpoint`` the weights are random, drawn from ``--seed``.

``perturbation`` is the JAX package's subcommand (the same flags, plus
``--device``): the LXMERT positive/negative perturbation benchmark through
``harness/pert_runner``. Without the data flags it runs the pipeline on
synthetic samples and a tiny random LXMERT. ``--model visual_bert`` and the
four LRP methods are not ported yet and exit with 2 and a message.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch


def str2bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "y")


# union of the per-model method families; each runner validates its own
# surface (pert_runner.LXMERT_METHODS + aliases)
METHODS = ["ours_with_lrp", "ours_no_lrp", "transformer_att",
           "transformer_attribution", "partial_lrp", "raw_attn",
           "attn_gradcam", "rollout", "ours_no_lrp_no_norm",
           "ours_no_lrp_no_normalization",
           "ours_with_lrp_no_normalization", "ablation_no_self_in_10",
           "ablation_no_aggregation"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tmmx-torch")
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("explain-vit", help="ViT-B/16 relevancy map")
    sp.add_argument("image", help="image path (png/jpg)")
    sp.add_argument("--checkpoint", default=None,
                    help="timm ViT state dict (torch.save) to convert+load")
    sp.add_argument("--class-index", type=int, default=None)
    sp.add_argument("--output", default="vit_relevancy.png")
    sp.add_argument("--seed", type=int, default=1234)
    sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    sp = sub.add_parser("perturbation",
                        help="pos/neg perturbation benchmark")
    sp.add_argument("--model", choices=["visual_bert", "lxmert"],
                    default="visual_bert")
    sp.add_argument("--num-samples", type=int, default=10000)
    sp.add_argument("--batch-size", type=int, default=8,
                    help="samples per explain+perturb call (protocol "
                         "results are batch-size invariant)")
    sp.add_argument("--is-positive-pert", type=str2bool, default=False)
    sp.add_argument("--is-text-pert", type=str2bool, default=False)
    sp.add_argument("--questions", default=None, help="VQA questions json")
    sp.add_argument("--features", default=None, help="object-features TSV")
    sp.add_argument("--ans2label", default=None)
    sp.add_argument("--label2ans", default=None)
    sp.add_argument("--bert-vocab", default=None,
                    help="vocab.txt (bert-base-uncased layout)")
    sp.add_argument("--method", default="ours_no_lrp", choices=METHODS,
                    help="explanation method (reference --method)")
    sp.add_argument("--checkpoint", default=None,
                    help="LXMERT torch state dict to convert+load")
    sp.add_argument("--seed", type=int, default=1234)
    sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def cmd_explain_vit(args) -> int:
    from PIL import Image

    from transformer_mm_explainability_tpu_torch._device import resolve_device
    from transformer_mm_explainability_tpu_torch.models import vit
    from transformer_mm_explainability_tpu_torch.ops import image as img_ops
    from transformer_mm_explainability_tpu_torch.utils import convert
    from transformer_mm_explainability_tpu_torch.utils import (
        visualization as viz)

    device = resolve_device(args.device)
    cfg = vit.VIT_B_16
    if args.checkpoint:
        sd = torch.load(args.checkpoint, map_location="cpu")
        model, cfg = convert.vit_from_state_dict(sd, device)
    else:
        print("note: no --checkpoint; using random weights (smoke mode)")
        model = vit.init_params(args.seed, cfg, device)

    raw = np.array(Image.open(args.image).convert("RGB"))
    # timm vit_base_patch16_224 transform: bicubic resize + center crop,
    # 0.5/0.5 normalisation
    img = torch.as_tensor(raw, dtype=torch.float32, device=device) / 255.0
    img = img_ops.normalize(
        img_ops.center_crop(
            img_ops.resize_shortest_edge(img, cfg.image_size,
                                         method="bicubic"),
            cfg.image_size),
        (0.5, 0.5, 0.5), (0.5, 0.5, 0.5))
    images = img[None].contiguous()
    with torch.no_grad():
        logits, _ = vit.forward(model, images)
    target = (int(logits[0].argmax()) if args.class_index is None
              else args.class_index)
    rel = vit.relevancy_fused_block2(
        model, images, torch.tensor([target], device=device))[0]
    fig = viz.relevancy_figure(img.cpu().numpy(), rel.cpu().numpy(),
                               (cfg.grid, cfg.grid))
    Image.fromarray(fig).save(args.output)
    print(json.dumps({"class_index": target, "output": args.output}))
    return 0


def cmd_perturbation(args) -> int:
    from transformer_mm_explainability_tpu_torch._device import resolve_device
    from transformer_mm_explainability_tpu_torch.harness import pert_runner

    resolve_device(args.device)
    try:
        return pert_runner.run_from_args(args)
    except NotImplementedError as e:
        print(f"perturbation: {e}")
        return 2


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return {"explain-vit": cmd_explain_vit,
            "perturbation": cmd_perturbation}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
