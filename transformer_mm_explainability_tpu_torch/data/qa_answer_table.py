"""LXMERT QA answer table + pretrained-head surgery (C36).

The port's copy of
``transformer_mm_explainability_tpu/data/qa_answer_table.py`` (numpy):
importing that module would load the JAX package.

Re-design of ``lxmert/lxmert/src/pretrain/qa_answer_table.py``:
``AnswerTable`` (:8-81 — the 9500-answer union table with the
normalization map) and ``load_lxmert_qa`` (:84-158 — re-initialising a
finetune task's answer head from the pretraining QA head by matching
normalized answer strings; unmatched rows zeroed).

The surgery is a pure function over weight arrays — it returns the
new (weight, bias) rows instead of mutating module state, so it
composes with the converter pipeline (utils/convert).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

ANS_CONVERT = {
    "a man": "man", "the man": "man", "a woman": "woman",
    "the woman": "woman", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10", "grey": "gray",
}


def convert_ans(ans: str) -> str:
    """AnswerTable.convert_ans (qa_answer_table.py:45-59)."""
    if len(ans) == 0:
        return ""
    ans = ans.lower()
    if ans[-1] == ".":
        ans = ans[:-1].strip()
    if ans.startswith("a "):
        ans = ans[2:].strip()
    if ans.startswith("an "):
        ans = ans[3:].strip()
    if ans.startswith("the "):
        ans = ans[4:].strip()
    return ANS_CONVERT.get(ans, ans)


class AnswerTable:
    """AnswerTable (qa_answer_table.py:8-81).  ``all_ans`` entries are
    {"ans": str, "dsets": [names]}; pass ``entries`` directly or an
    ``all_ans_path`` json (the published data/lxmert/all_ans.json)."""

    def __init__(self, dsets: Optional[Sequence[str]] = None,
                 all_ans_path: Optional[str] = None,
                 entries: Optional[List[dict]] = None):
        if entries is None:
            with open(all_ans_path or "data/lxmert/all_ans.json") as f:
                entries = json.load(f)
        if dsets is not None:
            dset_set = set(dsets)
            self.anss = [e["ans"] for e in entries
                         if set(e["dsets"]) & dset_set]
        else:
            self.anss = [e["ans"] for e in entries]
        self.ans_set = set(self.anss)
        self._id2ans_map = self.anss
        self._ans2id_map = {a: i for i, a in enumerate(self.anss)}
        assert len(self._id2ans_map) == len(self._ans2id_map)

    convert_ans = staticmethod(convert_ans)

    def ans2id(self, ans: str) -> int:
        return self._ans2id_map[ans]

    def id2ans(self, ans_id: int) -> str:
        return self._id2ans_map[ans_id]

    def ans2id_map(self) -> Dict[str, int]:
        return dict(self._ans2id_map)

    def id2ans_map(self) -> List[str]:
        return list(self._id2ans_map)

    def used(self, ans: str) -> bool:
        return ans in self.ans_set

    def all_answers(self) -> List[str]:
        return list(self.anss)

    @property
    def num_answers(self) -> int:
        return len(self.anss)


def load_lxmert_qa_head(
    pretrain_weight: np.ndarray,      # [N_pretrain, D]
    pretrain_bias: np.ndarray,        # [N_pretrain]
    answer_table: AnswerTable,
    label2ans: Union[Dict[int, str], List[str]],
    num_labels: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """load_lxmert_qa's answer-head surgery (qa_answer_table.py:117-144):
    for each finetune label, copy the pretraining row whose normalized
    answer matches; zero the rest.  Returns (weight [L, D], bias [L],
    n_loaded, n_unloaded)."""
    if isinstance(label2ans, list):
        label2ans = dict(enumerate(label2ans))
    if num_labels is None:
        num_labels = max(label2ans) + 1
    D = pretrain_weight.shape[1]
    new_w = np.zeros((num_labels, D), pretrain_weight.dtype)
    new_b = np.zeros((num_labels,), pretrain_bias.dtype)
    loaded = unload = 0
    for label, ans in label2ans.items():
        new_ans = answer_table.convert_ans(ans)
        if answer_table.used(new_ans):
            pid = answer_table.ans2id(new_ans)
            new_w[label] = pretrain_weight[pid]
            new_b[label] = pretrain_bias[pid]
            loaded += 1
        else:
            unload += 1
    return new_w, new_b, loaded, unload
