"""LXMERT pretraining dataset composition (C36).

The port's copy of
``transformer_mm_explainability_tpu/data/lxmert_pretrain_data.py`` (numpy):
importing that module would load the JAX package.

Re-design of ``lxmert/lxmert/src/pretrain/lxmert_data.py``:
``LXMERTDataset`` (:40-75 — multi-source json load + answer-table
remap), the per-sentence flattening (:113-131), the item assembly with
normalized boxes and the cross-image matched-task sentence swap
(:144-195), and ``LXMERTEvaluator`` (:198-252 — uid→answer soft
scoring per source dataset).

Host-side: items are plain dicts of numpy arrays ready for the
pretraining collator; randomness uses an explicit RandomState.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from transformer_mm_explainability_tpu_torch.data.qa_answer_table import (
    AnswerTable)


def make_uid(img_id: str, dset: str, sent_idx: int) -> str:
    """lxmert_data.py:78-79 (the reference returns a 1-tuple by
    accident — trailing comma; we return the string)."""
    return "%s_%s_%03d" % (img_id, dset, sent_idx)


class LXMERTDataset:
    """lxmert_data.py:40-75."""

    def __init__(self, splits: str, qa_sets: Optional[Sequence[str]] = None,
                 data_root: str = "data/lxmert",
                 answer_table: Optional[AnswerTable] = None,
                 data: Optional[List[dict]] = None):
        self.name = splits
        self.sources = splits.split(",")
        if data is None:
            data = []
            for source in self.sources:
                with open(f"{data_root}/{source}.json") as f:
                    data.extend(json.load(f))
        self.data = data
        self.answer_table = answer_table or AnswerTable(
            qa_sets, all_ans_path=f"{data_root}/all_ans.json")
        # remap every label key through the answer table; drop unused
        for datum in self.data:
            for cat, labels in datum["labelf"].items():
                for label in labels:
                    for ans in list(label.keys()):
                        new_ans = self.answer_table.convert_ans(ans)
                        if self.answer_table.used(new_ans):
                            if ans != new_ans:
                                label[new_ans] = label.pop(ans)
                        else:
                            label.pop(ans)

    def __len__(self) -> int:
        return len(self.data)


class LXMERTPretrainData:
    """lxmert_data.py:87-195 without the torch Dataset baggage:
    ``imgid2img`` comes from obj-TSV rows (data/vqa.load_obj_tsv)."""

    def __init__(self, dataset: LXMERTDataset,
                 img_data: Sequence[Dict[str, Any]],
                 task_matched: bool = False, seed: int = 0):
        self.raw_dataset = dataset
        self.task_matched = task_matched
        self.rng = np.random.RandomState(seed)
        self.imgid2img = {d["img_id"]: d for d in img_data}
        used = [d for d in dataset.data if d["img_id"] in self.imgid2img]
        self.data: List[dict] = []
        for datum in used:
            for sents_cat, sents in datum["sentf"].items():
                labels = datum["labelf"].get(sents_cat)
                for sent_idx, sent in enumerate(sents):
                    new_datum = {
                        "uid": make_uid(datum["img_id"], sents_cat,
                                        sent_idx),
                        "img_id": datum["img_id"],
                        "sent": sent,
                    }
                    if labels is not None:
                        new_datum["label"] = labels[sent_idx]
                    self.data.append(new_datum)

    def __len__(self) -> int:
        return len(self.data)

    def random_feat(self) -> np.ndarray:
        """lxmert_data.py:136-142: a random object feature (the
        masked-feature regression negatives)."""
        datum = self.data[self.rng.randint(len(self.data))]
        img_info = self.imgid2img[datum["img_id"]]
        return img_info["features"][
            self.rng.randint(img_info["num_boxes"])]

    def __getitem__(self, item: int) -> Dict[str, Any]:
        datum = self.data[item]
        img_info = self.imgid2img[datum["img_id"]]
        feats = img_info["features"].copy()
        boxes = img_info["boxes"].copy().astype(np.float32)
        img_h, img_w = img_info["img_h"], img_info["img_w"]
        boxes[:, (0, 2)] /= img_w
        boxes[:, (1, 3)] /= img_h
        np.testing.assert_array_less(boxes, 1 + 1e-5)
        np.testing.assert_array_less(-boxes, 0 + 1e-5)

        is_matched = 1
        sent = datum["sent"]
        if self.task_matched and self.rng.random_sample() < 0.5:
            is_matched = 0
            other = self.data[self.rng.randint(len(self.data))]
            while other["img_id"] == datum["img_id"]:
                other = self.data[self.rng.randint(len(self.data))]
            sent = other["sent"]

        label = None
        if "label" in datum:
            label = {self.raw_dataset.answer_table.ans2id(a): s
                     for a, s in datum["label"].items()}
        return {
            "uid": datum["uid"],
            "sent": sent,
            "visual_feats": (feats, boxes),
            "obj_labels": (img_info["objects_id"].copy(),
                           img_info["objects_conf"].copy()),
            "attr_labels": (img_info["attrs_id"].copy(),
                            img_info["attrs_conf"].copy()),
            "is_matched": is_matched,
            "label": label,
        }


class LXMERTEvaluator:
    """lxmert_data.py:198-252."""

    def __init__(self, dataset: LXMERTDataset):
        self.raw_dataset = dataset
        self.data: List[dict] = []
        for datum in dataset.data:
            for sents_cat, sents in datum["sentf"].items():
                if sents_cat in datum["labelf"]:
                    labels = datum["labelf"][sents_cat]
                    for sent_idx, sent in enumerate(sents):
                        self.data.append({
                            "uid": make_uid(datum["img_id"], sents_cat,
                                            sent_idx),
                            "img_id": datum["img_id"],
                            "sent": sent,
                            "dset": sents_cat,
                            "label": labels[sent_idx],
                        })
        self.uid2datum = {d["uid"]: d for d in self.data}

    def evaluate(self, uid2ans: Dict[str, str], pprint: bool = False
                 ) -> Tuple[float, Dict[str, float]]:
        score, cnt = 0.0, 0
        dset2score: Dict[str, float] = defaultdict(float)
        dset2cnt: Dict[str, int] = defaultdict(int)
        for uid, ans in uid2ans.items():
            if uid not in self.uid2datum:
                continue
            datum = self.uid2datum[uid]
            if ans in datum["label"]:
                score += datum["label"][ans]
                dset2score[datum["dset"]] += datum["label"][ans]
            cnt += 1
            dset2cnt[datum["dset"]] += 1
        accu = score / cnt
        dset2accu = {d: dset2score[d] / dset2cnt[d] for d in dset2cnt}
        if pprint:
            parts = ["Overall Accu %0.4f, " % accu] + [
                "%s Accu %0.4f, " % (k, dset2accu[k])
                for k in sorted(dset2accu)]
            print("".join(parts))
        return accu, dset2accu
