"""VisDial imdb builder (C29 tooling).

The port's copy of
``transformer_mm_explainability_tpu/tools/visdial_imdb.py`` (host
code, the same outputs; importing the JAX module would load the JAX
package).

Re-design of ``VisualBERT/tools/scripts/visual_dialog/build_imdb.py``:
tokenize every question/answer/caption with the MMF tokenizer, map
each dialog's ``image_id`` to its feature path (``<split>/<file>.npy``
with the id parsed from the trailing 12 digits of the COCO filename,
:50-59), and dump {questions, answers, dialogs} as the imdb the
VisualDialogDataset consumes.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

from transformer_mm_explainability_tpu_torch.data.processors import tokenize


def id_to_path_dict(image_root: str) -> Dict[int, str]:
    """build_imdb.py:50-59: image_id (unique across splits) → the
    last-two-components relative path."""
    id2path: Dict[int, str] = {}
    for image_path in glob.iglob(os.path.join(image_root, "*", "*.npy")):
        path = "/".join(image_path.split("/")[-2:])
        image_id = int(image_path[-16:-4])
        id2path[image_id] = path
    return id2path


def get_tokens(sentences) -> List[List[str]]:
    """build_imdb.py:89-97."""
    if not isinstance(sentences, list):
        sentences = [sentences]
    return [tokenize(s) for s in sentences]


def parse_dialogs(dialogs: List[dict], image_root: str) -> List[dict]:
    """build_imdb.py:99-108: attach feature paths, tokenize captions."""
    id2path = id_to_path_dict(image_root)
    for dialog in dialogs:
        dialog["image_feature_path"] = id2path[dialog["image_id"]]
        dialog["caption"] = get_tokens(dialog["caption"])
    return dialogs


def build_imdb(data: dict, image_root: str) -> dict:
    """build_imdb.py:61-82 on a loaded ``visdial_*.json``'s ``data``."""
    return {
        "questions": get_tokens(data["questions"]),
        "answers": get_tokens(data["answers"]),
        "dialogs": parse_dialogs(data["dialogs"], image_root),
    }


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser("Build IMDB for VisDial")
    # the payload is json (reference save_imdb json.dump()s too) —
    # the reference's "./imdb.npy" default extension (:21) would make
    # extension-dispatching loaders mis-parse the file, so default to
    # .json here
    parser.add_argument("-o", "--out_file", type=str,
                        default="./imdb.json")
    parser.add_argument("-i", "--image_root", type=str, default="./COCO")
    parser.add_argument("-v", "--version", type=float, default=0.9)
    parser.add_argument("-d", "--data_dir", type=str, default="./visdial")
    parser.add_argument("-s", "--set_type", type=str, default="train",
                        help="Dataset type train|val|test")
    args = parser.parse_args(argv)

    visdial_json_file = os.path.join(
        args.data_dir, "visdial_%.1f_%s.json" % (args.version,
                                                 args.set_type))
    with open(visdial_json_file) as f:
        data = json.load(f)["data"]
    imdb = build_imdb(data, args.image_root)
    with open(args.out_file, "w") as f:
        json.dump(imdb, f)


if __name__ == "__main__":
    main()
