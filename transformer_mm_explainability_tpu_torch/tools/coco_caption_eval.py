"""Image-captioning metric CLI (C28/C34 tooling).

The port's copy of
``transformer_mm_explainability_tpu/tools/coco_caption_eval.py`` (host
code, the same outputs; importing the JAX module would load the JAX
package).

Re-design of ``VisualBERT/tools/scripts/coco/coco_caption_eval.py``:
parse a karpathy-split reference json (``images[].sentences[]``, test
split) and a predicted-captions json, score with the numpy scorers in
``utils/caption_metrics`` (BLEU-1..4, ROUGE_L, CIDEr-D; METEOR/SPICE
are Java-bound and skipped — see that module's docstring).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

from transformer_mm_explainability_tpu_torch.utils.caption_metrics import (
    calculate_metrics)


def references_from_karpathy_json(captions: Dict,
                                  split: str = "test"):
    """coco_caption_eval.py:108-118: karpathy json → (annotations,
    unique img_ids)."""
    references: List[Dict] = []
    img_ids: List[int] = []
    for img in captions["images"]:
        if img["split"] == split:
            for c in img["sentences"]:
                img_ids.append(c["imgid"])
                references.append({"image_id": c["imgid"],
                                   "caption": c["raw"]})
    return references, sorted(set(img_ids))


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(
        description="Image captioning metrics")
    parser.add_argument("--reference_json", required=True,
                        help="Path to reference captions json")
    parser.add_argument("--predicted_json", required=True,
                        help="Path to predicted captions json")
    args = parser.parse_args(argv)

    with open(args.reference_json) as f:
        captions = json.load(f)
    references, img_ids = references_from_karpathy_json(captions)
    with open(args.predicted_json) as f:
        preds = json.load(f)

    metrics = calculate_metrics(
        img_ids, {"annotations": references}, {"annotations": preds})
    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
