"""CLIP bi-modal relevancy demo (CLIP_explainability.ipynb as a script), on
the PyTorch port.

    python -m transformer_mm_explainability_tpu_torch.examples.clip_explainability \\
        IMAGE "a dog" "a cat" [--checkpoint ViT-B-32.pt] [--start-layer -1] \\
        [--start-layer-text -1] [--output-prefix P] [--device cuda|cpu]

Counterpart of the repo's ``examples/clip_explainability.py``: for each text
an image heatmap (``P_i.png``, which patches supported the match) and a
per-token text heatmap (``P_text.html``), plus the match probabilities
(notebook cells 5-8). One ``explain/clip.interpret`` call gives both; without
``--checkpoint`` the weights are random (smoke mode).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="clip_explainability")
    ap.add_argument("image")
    ap.add_argument("texts", nargs="+")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--start-layer", type=int, default=-1)
    ap.add_argument("--start-layer-text", type=int, default=-1)
    ap.add_argument("--output-prefix", default="clip_relevancy")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from transformer_mm_explainability_tpu_torch import cli
    from transformer_mm_explainability_tpu_torch.data import bpe
    from transformer_mm_explainability_tpu_torch.explain import clip as eclip
    from transformer_mm_explainability_tpu_torch.utils import (
        visualization as viz)

    res = cli.explain_clip(cli.build_parser().parse_args([
        "explain-clip", args.image, *args.texts,
        "--start-layer", str(args.start_layer),
        "--start-layer-text", str(args.start_layer_text),
        "--output-prefix", args.output_prefix, "--device", args.device,
        *(["--checkpoint", args.checkpoint] if args.checkpoint else []),
    ]))
    print(json.dumps({"probs": res["probs"], "outputs": res["outputs"]}))

    # text heatmaps (the notebook's show_heatmap_on_text) as HTML
    tokens = res["tokens"]
    rows = eclip.text_token_relevance(res["R_text"], tokens).cpu().numpy()
    tokens = tokens.cpu().numpy()
    tok = bpe.ClipTokenizer()
    html = []
    for i, text in enumerate(args.texts):
        n = int((tokens[i] != 0).sum())
        words = [tok.decode([int(t)]) for t in tokens[i][1:n - 1]]
        html.append(viz.text_heatmap_html(words, rows[i][1:n - 1],
                                          title=text))
    out = f"{args.output_prefix}_text.html"
    with open(out, "w") as f:
        f.write("\n".join(html))
    print(f"text heatmaps -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
