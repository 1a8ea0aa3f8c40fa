"""VQA v2, GQA and NLVR2 data for the LXMERT runner and finetune loops
(numpy only).

A private copy of ``transformer_mm_explainability_tpu/data/vqa.py``
(importing that module would load the JAX package):

  * question json records: {question_id, img_id, sent, label
    ({answer: soft score})}, the same for GQA; NLVR2 records {uid, img0,
    img1, sent, label};
  * the answer vocabulary (``trainval_ans2label.json`` /
    ``trainval_label2ans.json``);
  * the base64 TSV object-feature reader (the bottom-up-attention format:
    img_id/img_h/img_w/objects_id/objects_conf/attrs_id/attrs_conf/
    num_boxes/boxes/features): the C++ reader of ``native/`` by default,
    Python's csv with ``use_native=False``, the same records from both;
  * ``FeatureStore``, which pads every image to ``max_boxes``.
"""

from __future__ import annotations

import base64
import csv
import json
import sys
from typing import Any, Dict, List, Optional

import numpy as np

TSV_FIELDNAMES = [
    "img_id", "img_h", "img_w", "objects_id", "objects_conf",
    "attrs_id", "attrs_conf", "num_boxes", "boxes", "features",
]

csv.field_size_limit(sys.maxsize)


def _decode_field(name: str, value: str, num_boxes: int) -> Any:
    if name in ("img_h", "img_w", "num_boxes"):
        return int(value)
    if name in ("objects_id", "attrs_id"):
        return np.frombuffer(base64.b64decode(value), np.int64)[:num_boxes]
    if name in ("objects_conf", "attrs_conf"):
        return np.frombuffer(base64.b64decode(value), np.float32)[:num_boxes]
    if name == "boxes":
        arr = np.frombuffer(base64.b64decode(value), np.float32)
        return arr.reshape(num_boxes, 4).copy()
    if name == "features":
        arr = np.frombuffer(base64.b64decode(value), np.float32)
        return arr.reshape(num_boxes, -1).copy()
    return value


def load_obj_tsv(path: str, topk: Optional[int] = None,
                 use_native: bool = True) -> List[Dict[str, Any]]:
    """Load FRCNN object features from a base64 TSV (utils.py:16-29
    format): with ``use_native`` the C++ reader of ``native/`` (built on
    first use), else Python's csv; the same records either way.

    Departure from the JAX reader, which falls back to Python on any error
    of its C++ path: ``use_native=True`` raises where the library cannot be
    built or loaded."""
    if use_native:
        from transformer_mm_explainability_tpu_torch.native import tsv

        return tsv.load_obj_tsv(path, topk)
    out = []
    with open(path) as f:
        reader = csv.DictReader(f, TSV_FIELDNAMES, delimiter="\t")
        for i, row in enumerate(reader):
            if topk is not None and i >= topk:
                break
            n = int(row["num_boxes"])
            out.append({k: _decode_field(k, v, n) for k, v in row.items()})
    return out


def normalize_boxes(boxes: np.ndarray, img_h: float, img_w: float
                    ) -> np.ndarray:
    """Pixel xyxy → normalised xyxy (the LXMERT visual_pos convention)."""
    out = boxes.copy().astype(np.float32)
    out[:, (0, 2)] /= img_w
    out[:, (1, 3)] /= img_h
    return out


class AnswerVocab:
    """trainval_{ans2label,label2ans}.json wrapper."""

    def __init__(self, ans2label_path: str, label2ans_path: str):
        with open(ans2label_path) as f:
            self.ans2label = json.load(f)
        with open(label2ans_path) as f:
            self.label2ans = json.load(f)

    def __len__(self) -> int:
        return len(self.ans2label)

    def soft_scores(self, label: Dict[str, float]) -> np.ndarray:
        """{answer: score} → dense [num_answers] soft target."""
        out = np.zeros(len(self.ans2label), np.float32)
        for ans, score in label.items():
            idx = self.ans2label.get(ans)
            if idx is not None:
                out[idx] = score
        return out

    def answer(self, idx: int) -> str:
        return self.label2ans[idx]


class VQADataset:
    """VQA question/answer records."""

    def __init__(self, question_paths: List[str],
                 vocab: Optional[AnswerVocab] = None):
        self.vocab = vocab
        self.data: List[Dict[str, Any]] = []
        for p in question_paths:
            with open(p) as f:
                self.data.extend(json.load(f))
        self.by_qid = {d["question_id"]: d for d in self.data}

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        return self.data[i]

    def sampled(self, num_samples: int, seed: int = 1234) -> List[Dict]:
        """The perturbation protocol's deterministic subsample (seed,
        shuffle, take N)."""
        import random

        items = list(self.data)
        random.Random(seed).shuffle(items)
        return items[:num_samples]


class GQADataset(VQADataset):
    """GQA question records (lxmert/src/tasks/gqa_data.py layout —
    same json schema as VQA: question_id/img_id/sent/label)."""


class NLVR2Dataset:
    """NLVR2 records (lxmert/src/tasks/nlvr2_data.py): two images per
    sentence, binary label. Records: {uid, img0, img1, sent, label}."""

    def __init__(self, question_paths: List[str]):
        self.data: List[Dict[str, Any]] = []
        for p in question_paths:
            with open(p) as f:
                self.data.extend(json.load(f))
        self.by_uid = {d["uid"]: d for d in self.data}

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        return self.data[i]


class FeatureStore:
    """img_id → feature dict padded to ``max_boxes`` with a validity
    count, so that batches have static shapes."""

    def __init__(self, items: List[Dict[str, Any]], max_boxes: int = 36,
                 normalize: bool = True):
        self.max_boxes = max_boxes
        self._store: Dict[str, Dict[str, np.ndarray]] = {}
        for it in items:
            n = min(int(it["num_boxes"]), max_boxes)
            feat_dim = it["features"].shape[-1]
            feats = np.zeros((max_boxes, feat_dim), np.float32)
            boxes = np.zeros((max_boxes, 4), np.float32)
            feats[:n] = it["features"][:n]
            b = it["boxes"][:n]
            if normalize:
                b = normalize_boxes(b, it["img_h"], it["img_w"])
            boxes[:n] = b
            self._store[it["img_id"]] = {
                "features": feats, "boxes": boxes, "num_boxes": np.int32(n),
            }

    def __contains__(self, img_id: str) -> bool:
        return img_id in self._store

    def __getitem__(self, img_id: str) -> Dict[str, np.ndarray]:
        return self._store[img_id]
