"""VQA answer-vocabulary builder (C29 tooling).

The port's copy of
``transformer_mm_explainability_tpu/tools/process_answers.py`` (host
code, the same outputs; importing the JAX module would load the JAX
package).

Re-design of ``VisualBERT/mmf/utils/process_answers.py``: the VQA soft
score table (get_score:10-19), EvalAI-normalized answer filtering by
occurrence (filter_answers:29-47), and the CLI that writes
``answers_vqa.txt`` (sorted, ``<unk>``-prefixed) from annotation json
files (:50-104).

Host-side tooling — runs once at dataset-prep time.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Iterable, List

from transformer_mm_explainability_tpu_torch.utils.m4c_evaluators import (
    EvalAIAnswerProcessor)


def get_score(occurences: int) -> float:
    """process_answers.py:10-19: the VQA consensus soft score."""
    if occurences == 0:
        return 0.0
    if occurences == 1:
        return 0.3
    if occurences == 2:
        return 0.6
    if occurences == 3:
        return 0.9
    return 1.0


def multiple_replace(text: str, word_dict: Dict[str, str]) -> str:
    """process_answers.py:22-25."""
    for key in word_dict:
        text = text.replace(key, word_dict[key])
    return text


def filter_answers(answers_dset: Iterable[dict], min_occurence: int
                   ) -> List[str]:
    """process_answers.py:29-47: keep EvalAI-normalized answers seen in
    at least ``min_occurence`` distinct questions."""
    occurence: Dict[str, set] = {}
    evalai = EvalAIAnswerProcessor()
    for ans_entry in answers_dset:
        gtruth = evalai(ans_entry["multiple_choice_answer"])
        occurence.setdefault(gtruth, set()).add(ans_entry["question_id"])
    answer_list = [a for a, qids in occurence.items()
                   if len(qids) >= min_occurence]
    print("Num of answers that appear >= %d times: %d"
          % (min_occurence, len(answer_list)))
    return answer_list


def build_answer_vocab(train_annotation_file: str,
                       val_annotation_file: str = None,
                       out_dir: str = "./", min_freq: int = 0) -> str:
    """process_answers.py:80-104: write the sorted, <unk>-prefixed
    ``answers_vqa.txt``; returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    with open(train_annotation_file) as f:
        answers = json.load(f)["annotations"]
    if val_annotation_file is not None:
        with open(val_annotation_file) as f:
            answers = answers + json.load(f)["annotations"]
    answer_list = filter_answers(answers, min_freq)
    answer_list = sorted(t.strip() for t in answer_list if t.strip())
    if "<unk>" not in answer_list:
        answer_list = ["<unk>"] + answer_list
    answer_file = os.path.join(out_dir, "answers_vqa.txt")
    with open(answer_file, "w") as f:
        f.writelines(w + "\n" for w in answer_list)
    return answer_file


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--annotation_file", type=str, required=True,
                        help="input train annotation json file")
    parser.add_argument("--val_annotation_file", type=str,
                        required=False)
    parser.add_argument("--out_dir", type=str, default="./")
    parser.add_argument("--min_freq", type=int, default=0)
    args = parser.parse_args(argv)
    build_answer_vocab(args.annotation_file, args.val_annotation_file,
                       args.out_dir, args.min_freq)


if __name__ == "__main__":
    main()
