"""GQA → VQA-format dataset conversion (C29 tooling).

The port's copy of
``transformer_mm_explainability_tpu/tools/gqa_to_vqa.py`` (host
code, the same outputs; importing the JAX module would load the JAX
package).

Re-design of ``VisualBERT/tools/scripts/gqa/convert_gqa_to_vqa.py``:
merge the chunked train questions, build VQA-style imdb arrays (header
row + per-question entries with the 10-fold answer replication GQA's
single answer gets, :42-67), unpack the released
``gqa_objects_*.h5`` / ``gqa_spatial_*.h5`` feature shards into
per-image npy files (:70-121), and write the question/answer
vocabularies (:182-230).

Divergence pinned: the reference script is unrunnable as shipped —
it imports ``mmf.utils.process_answers.preprocess_answer`` and
``mmf.utils.text_processing.text_tokenize``, neither of which exists
in the tree.  Here the working equivalents are used: the EvalAI answer
normalizer (``utils/m4c_evaluators.EvalAIAnswerProcessor``) and the
MMF tokenizer (``data/processors.tokenize``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from transformer_mm_explainability_tpu_torch.data.processors import tokenize
from transformer_mm_explainability_tpu_torch.utils.m4c_evaluators import (
    EvalAIAnswerProcessor)

preprocess_answer = EvalAIAnswerProcessor()

SPLIT_MAPPING = {
    "test": "test_all_questions.json",
    "val": "val_all_questions.json",
    "challenge": "challenge_all_questions.json",
    "train": "train_all_questions.json",
}


def merge_train(train_q_dir: str) -> str:
    """convert_gqa_to_vqa.py:15-26: merge the chunked train question
    jsons into train_all_questions.json one directory up."""
    merged: Dict[str, dict] = {}
    for file_name in sorted(os.listdir(train_q_dir)):
        with open(os.path.join(train_q_dir, file_name)) as f:
            merged.update(json.load(f))
    save_dir = os.path.abspath(os.path.join(train_q_dir, os.pardir))
    out = os.path.join(save_dir, "train_all_questions.json")
    with open(out, "w") as fp:
        json.dump(merged, fp)
    return out


def get_objects(semantic_str: str) -> List[int]:
    """convert_gqa_to_vqa.py:29-39: ground-truth object ids from the
    semantic program string."""
    result: List[int] = []
    for match in re.findall(r"\(([^)]+)", semantic_str):
        if "," in match:
            result += list(map(int, match.split(",")))
        elif match.isdigit():
            result += [int(match)]
    return result


def get_imdb(file_path: str) -> np.ndarray:
    """convert_gqa_to_vqa.py:42-67: questions json → imdb array with
    the {dataset_name} header row."""
    imdb: List[dict] = [{"dataset_name": "gqa"}]
    with open(file_path) as f:
        questions = json.load(f)
    for qid, item in questions.items():
        entry = {
            "image_name": item["imageId"] + "jpg",   # sic (:52)
            "image_id": item["imageId"],
            "question_id": qid,
            "question_str": item["question"],
            "question_tokens": tokenize(item["question"]),
        }
        if "answer" in item:
            entry["all_answers"] = [item["answer"]] * 10
            entry["valid_answers"] = [item["answer"]] * 10
            entry["semantic_string"] = (item["semanticStr"],)
            entry["gt_object_ids"] = (get_objects(item["semanticStr"]),)
            entry["meta_data"] = item["types"]
        imdb.append(entry)
    return np.array(imdb)


def _h5_shards(feat_dir: str, info_name: str, n_files: int = 16):
    with open(os.path.join(feat_dir, info_name)) as f:
        info_dict = json.load(f)
    file_mapping: Dict[int, list] = {k: [] for k in range(n_files)}
    for k, v in info_dict.items():
        file_mapping[v["file"]] += [(k, v)]
    return file_mapping


def extract_bbox_feats(feat_dir: str, out_dir: str,
                       n_files: int = 16) -> int:
    """convert_gqa_to_vqa.py:70-100: gqa_objects_*.h5 → per-image npy
    dicts {image_id, boxes, feats, height, width, n_objects}."""
    import h5py

    os.makedirs(out_dir, exist_ok=True)
    file_mapping = _h5_shards(feat_dir, "gqa_objects_info.json", n_files)
    n = 0
    for i in range(n_files):
        with h5py.File(os.path.join(feat_dir, f"gqa_objects_{i}.h5"),
                       "r") as feat_db:
            for image_id, meta in file_mapping[i]:
                to_save = {
                    "image_id": image_id,
                    "boxes": feat_db["bboxes"][meta["idx"]],
                    "feats": feat_db["features"][meta["idx"]],
                    "height": meta["height"],
                    "width": meta["width"],
                    "n_objects": meta["objectsNum"],
                }
                np.save(os.path.join(out_dir, str(image_id) + ".npy"),
                        to_save)
                n += 1
    return n


def extract_spatial_feats(feat_dir: str, out_dir: str,
                          n_files: int = 16) -> int:
    """convert_gqa_to_vqa.py:103-121: gqa_spatial_*.h5 → per-image
    [1, 7, 7, 2048] npy grids.

    Divergence pinned: GQA ships spatial features CHW (2048, 7, 7);
    the reference's ``reshape(1, 7, 7, 2048)`` (:118) reinterprets the
    flat buffer instead of transposing, scrambling every grid.  Here
    the conversion is a real CHW→HWC transpose."""
    import h5py

    os.makedirs(out_dir, exist_ok=True)
    file_mapping = _h5_shards(feat_dir, "gqa_spatial_info.json", n_files)
    n = 0
    for i in range(n_files):
        with h5py.File(os.path.join(feat_dir, f"gqa_spatial_{i}.h5"),
                       "r") as feat_db:
            for image_id, meta in file_mapping[i]:
                to_save = np.asarray(feat_db["features"][meta["idx"]])
                to_save = to_save.reshape(2048, 7, 7)
                to_save = to_save.transpose(1, 2, 0)[None]  # CHW→1HWC
                np.save(os.path.join(out_dir, str(image_id) + ".npy"),
                        to_save)
                n += 1
    return n


def build_vocabularies(questions_by_split: Iterable[Dict[str, dict]],
                       out_dir: str) -> Tuple[str, str]:
    """convert_gqa_to_vqa.py:182-230: global question-token and
    EvalAI-normalized answer vocabularies, ``<unk>``-prefixed."""
    global_answer: Counter = Counter()
    global_q: Counter = Counter()
    for questions in questions_by_split:
        for _, q in questions.items():
            global_q.update(tokenize(q["question"]))
            global_answer.update([q["answer"].lower()])

    q_vocabulary = ["<unk>"] + sorted(global_q)
    vocab_file = os.path.join(out_dir, "vocabulary_gqa.txt")
    with open(vocab_file, "w") as f:
        f.writelines(w + "\n" for w in q_vocabulary)

    answer_list = [preprocess_answer(a) for a in global_answer]
    answer_list = sorted({t.strip() for t in answer_list
                          if len(t.strip()) > 0})
    if "<unk>" not in answer_list:
        answer_list = ["<unk>"] + answer_list
    answer_file = os.path.join(out_dir, "answers_gqa.txt")
    with open(answer_file, "w") as fp:
        fp.writelines(w + "\n" for w in answer_list)
    return vocab_file, answer_file


def convert_gqa_to_vqa(gqa_dir: str, out_dir: str,
                       n_files: int = 16) -> None:
    """convert_gqa_to_vqa.py:134-230 orchestration (dir layout in the
    reference docstring: images/{objects,spatial}, questions/)."""
    os.makedirs(out_dir, exist_ok=True)
    image_feat_path = os.path.join(gqa_dir, "images")
    extract_bbox_feats(os.path.join(image_feat_path, "objects"),
                       os.path.join(out_dir, "objects"), n_files)
    extract_spatial_feats(os.path.join(image_feat_path, "spatial"),
                          os.path.join(out_dir, "spatial"), n_files)

    questions_dir = os.path.join(gqa_dir, "questions")
    if not os.path.isfile(os.path.join(questions_dir,
                                       "train_all_questions.json")):
        merge_train(os.path.join(questions_dir, "train_all_questions"))

    for split, filename in SPLIT_MAPPING.items():
        for balance_type in ["balanced", "all"]:
            fname, csplit = filename, split
            if balance_type == "balanced":
                fname = filename.replace("_all", "_balanced")
                csplit = split + "_balanced"
            file_path = os.path.join(questions_dir, fname)
            if not os.path.isfile(file_path):
                continue
            imdb = get_imdb(file_path)
            np.save(os.path.join(out_dir, f"imdb_{csplit}.npy"), imdb)

    loaded = []
    for s in ["val", "train"]:
        for st in ["balanced", "all"]:
            qj = os.path.join(questions_dir, f"{s}_{st}_questions.json")
            if os.path.isfile(qj):
                with open(qj) as f:
                    loaded.append(json.load(f))
    build_vocabularies(loaded, out_dir)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--gqa_dir", required=True)
    parser.add_argument("--out_dir", required=True)
    args = parser.parse_args(argv)
    convert_gqa_to_vqa(args.gqa_dir, args.out_dir)


if __name__ == "__main__":
    main()
