"""TextCaps caption evaluation (C34 m4c_captioner tooling).

The port's copy of
``transformer_mm_explainability_tpu/tools/textcaps_eval.py`` (host
code, the same outputs; importing the JAX module would load the JAX
package).

Re-design of
``VisualBERT/projects/m4c_captioner/scripts/textcaps_eval.py``: score
a predictions json against a TextCaps imdb (header row + entries with
``image_id``/``caption_str``) using the numpy caption scorers
(``utils/caption_metrics``).  METEOR/SPICE are Java-bound and not
computed (see that module's docstring); ``print_metrics`` prints
whichever of the reference's key list are present.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import numpy as np

from transformer_mm_explainability_tpu_torch.utils.caption_metrics import (
    calculate_metrics)

METRIC_KEYS = ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR",
               "ROUGE_L", "SPICE", "CIDEr"]


def print_metrics(res_metrics: Dict[str, float]) -> None:
    """textcaps_eval.py:10-24 (skipping absent Java-bound scorers)."""
    print(res_metrics)
    print("\n\n**********\nFinal model performance:\n**********")
    for k in METRIC_KEYS:
        if k in res_metrics:
            print(k, ": %.1f" % (res_metrics[k] * 100))


def evaluate(imdb, preds: List[dict]) -> Dict[str, float]:
    """textcaps_eval.py:47-57: imdb entries (header stripped) +
    prediction dicts → metric dict."""
    gts = [{"image_id": info["image_id"],
            "caption": info["caption_str"]} for info in imdb]
    preds = [{"image_id": p["image_id"], "caption": p["caption"]}
             for p in preds]
    imgids = sorted({g["image_id"] for g in gts})
    return calculate_metrics(imgids, {"annotations": gts},
                             {"annotations": preds})


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pred_file", type=str, required=True)
    parser.add_argument("--annotation_file", type=str, required=True)
    parser.add_argument("--set", type=str, default="val")
    args = parser.parse_args(argv)

    if args.set not in ["train", "val"]:
        raise Exception(
            "this script only supports TextCaps train and val set. "
            "Please use the EvalAI server for test set evaluation")

    with open(args.pred_file) as f:
        preds = json.load(f)
    imdb = np.load(args.annotation_file, allow_pickle=True)[1:]
    metrics = evaluate(imdb, preds)
    print_metrics(metrics)
    return metrics


if __name__ == "__main__":
    main()
