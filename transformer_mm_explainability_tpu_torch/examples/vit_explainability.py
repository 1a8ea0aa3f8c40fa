"""ViT-B/16 relevancy demo (the ViT notebook as a script), on the PyTorch
port.

    python -m transformer_mm_explainability_tpu_torch.examples.vit_explainability \\
        IMAGE [--checkpoint VIT.pth] [--class-index N] [--output PNG] \\
        [--device cuda|cpu]

Counterpart of the repo's ``examples/vit_explainability.py``: a JET-overlay
heatmap of the patches that drove the predicted (or given) class, through
``cli explain-vit`` (``models/vit.relevancy_fused_block2``: the block
kernels on the card). Without ``--checkpoint`` the weights are random
(smoke mode).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="vit_explainability")
    ap.add_argument("image")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--class-index", type=int, default=None)
    ap.add_argument("--output", default="vit_relevancy.png")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from transformer_mm_explainability_tpu_torch import cli

    return cli.main([
        "explain-vit", args.image, "--output", args.output,
        "--device", args.device,
        *(["--checkpoint", args.checkpoint] if args.checkpoint else []),
        *(["--class-index", str(args.class_index)]
          if args.class_index is not None else []),
    ])


if __name__ == "__main__":
    sys.exit(main())
