"""Raw-annotation → task-json converters (C19/C36 tooling).

The port's copy of
``transformer_mm_explainability_tpu/tools/process_data.py`` (host
code, the same outputs; importing the JAX module would load the JAX
package).

Re-design of the reference's dataset-prep scripts:
``data/gqa/process_raw_data_scripts/process_data.py`` (GQA balanced
questions → task json; its process_data_all.py / process_submit_data.py
siblings are the same converter over other splits) and
``data/nlvr2/process_raw_data_scripts/process_dataset.py`` (NLVR2
jsonl → task json).  Output matches the schema the VQA/GQA/NLVR2
readers in ``data/vqa.py`` consume.

Host-side tooling — runs once at dataset-prep time.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

GQA_SPLIT2NAME = {"train": "train", "valid": "val", "testdev": "testdev",
                  "test": "test", "challenge": "challenge"}
NLVR2_SPLIT2FNAME = {"train": "train", "valid": "dev", "test": "test1"}


def convert_gqa_questions(raw: Dict[str, dict]) -> List[dict]:
    """process_data.py:16-28: {qid: datum} → [{question_id, img_id,
    sent, label?}] with the answer as a 1.0 soft label."""
    new_data = []
    for key, datum in raw.items():
        new_datum = {
            "question_id": key,
            "img_id": datum["imageId"],
            "sent": datum["question"],
        }
        if "answer" in datum:
            new_datum["label"] = {datum["answer"]: 1.0}
        new_data.append(new_datum)
    return new_data


def convert_nlvr2_lines(lines: Sequence[str], split: str) -> List[dict]:
    """process_dataset.py:13-27: jsonl rows → [{identifier, img0, img1,
    label, sent, uid}]."""
    new_data = []
    for i, line in enumerate(lines):
        datum = json.loads(line)
        id_stem = "-".join(datum["identifier"].split("-")[:-1])
        new_data.append({
            "identifier": datum["identifier"],
            "img0": f"{id_stem}-img0",
            "img1": f"{id_stem}-img1",
            "label": 1 if datum["label"] == "True" else 0,
            "sent": datum["sentence"],
            "uid": f"nlvr2_{split}_{i}",
        })
    return new_data


def gqa_main(data_root: str, out_dir: str,
             splits: Optional[Sequence[str]] = None):
    import os

    for split in (splits or GQA_SPLIT2NAME):
        name = GQA_SPLIT2NAME[split]
        with open(os.path.join(data_root,
                               f"{name}_balanced_questions.json")) as f:
            raw = json.load(f)
        with open(os.path.join(out_dir, f"{split}.json"), "w") as g:
            json.dump(convert_gqa_questions(raw), g, indent=4,
                      sort_keys=True)


def nlvr2_main(data_root: str, out_dir: str,
               splits: Optional[Sequence[str]] = None):
    import os

    for split in (splits or NLVR2_SPLIT2FNAME):
        fname = NLVR2_SPLIT2FNAME[split]
        with open(os.path.join(data_root, f"{fname}.json")) as f:
            lines = f.readlines()
        with open(os.path.join(out_dir, f"{split}.json"), "w") as g:
            json.dump(convert_nlvr2_lines(lines, split), g,
                      sort_keys=True, indent=4)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("task", choices=["gqa", "nlvr2"])
    p.add_argument("--data-root", required=True)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--splits", nargs="*", default=None)
    args = p.parse_args(argv)
    (gqa_main if args.task == "gqa" else nlvr2_main)(
        args.data_root, args.out_dir, args.splits)


if __name__ == "__main__":
    main()
