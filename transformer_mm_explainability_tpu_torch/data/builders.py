"""MMF-style dataset builders (C29 datasets layer).

The port's copy of ``transformer_mm_explainability_tpu/data/builders.py``
(numpy): importing that module would load the JAX package.

The reference frames every dataset as builder → dataset → processors
(VisualBERT/mmf/datasets/mmf_dataset_builder.py,
builders/vqa2/dataset.py:14-146, builders/nlvr2/dataset.py,
builders/coco/dataset.py). The rebuild keeps that protocol —
registry names, config keys, per-sample dict layout — but drops the
torch Dataset/DataLoader machinery: datasets are plain host-side
sequences of ``Sample`` dicts of numpy arrays, batched by
``core.sample.collate`` and shipped to the device mesh by the trainer.

Builders registered (reference: datasets/builders/*):
  VQA-protocol  — vqa2 (+train_val/test), gqa, okvqa, vqacp_v2,
                  vizwiz, visual_genome, textvqa: identical load_item
                  semantics (builders that differ only in data paths
                  share VQA2Dataset in the reference too)
  nlvr2         — sentence + img0/img1 feature pair, binary target
  coco          — caption protocol (masked-caption pretraining feed)

The remaining reference builders (clevr, hateful_memes, mmimdb, …) are
MMF model-zoo baggage off the explainability path (SURVEY §2 C29/C34);
their datasets follow one of the three protocols above and can be
registered as config aliases when needed.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

from ..core.registry import registry
from ..core.sample import Sample
from . import processors as procs
from .databases import AnnotationDatabase, FeaturesDatabase


def _build_processor(spec: Optional[Dict[str, Any]]):
    if spec is None:
        return None
    if spec["type"] == "phoc":
        raise NotImplementedError(
            "the 'phoc' processor needs the native cphoc op, which the "
            "port does not have yet (ROADMAP A5d)")
    cls = registry.get("processor", spec["type"])
    return cls(spec.get("params", {}))


class MmfDataset:
    """Annotation db + features db + processors, MMF config layout:

    config = {
      "annotations": <path .npy/.json/.jsonl>,
      "features": <dir or comma-list>            # optional
      "max_features": 100,
      "processors": {
        "text_processor":   {"type": "bert_tokenizer", "params": {...}},
        "answer_processor": {"type": "vqa_answer", "params": {...}},
        "transformer_bbox_processor": {...},     # optional
      },
    }
    """

    def __init__(self, name: str, config: Dict[str, Any],
                 dataset_type: str = "train"):
        self.dataset_name = name
        self.config = config
        self.dataset_type = dataset_type
        self.annotation_db = AnnotationDatabase(config["annotations"])
        self._use_features = "features" in config
        self.features_db = (FeaturesDatabase(
            config["features"], annotation_db=self.annotation_db,
            max_features=config.get("max_features", 100))
            if self._use_features else None)
        p = config.get("processors", {})
        self.text_processor = _build_processor(p.get("text_processor"))
        self.answer_processor = _build_processor(p.get("answer_processor"))
        self.transformer_bbox_processor = _build_processor(
            p.get("transformer_bbox_processor"))
        # MMF's init_processors sets EVERY configured processor as an
        # attribute named by its config key (base_dataset.py) — the OCR
        # datasets rely on ocr_token/context/phoc/copy/bbox processors
        for key, spec in p.items():
            if not hasattr(self, key) or getattr(self, key) is None:
                setattr(self, key, _build_processor(spec))

    def __len__(self) -> int:
        return len(self.annotation_db)

    def __getitem__(self, idx: int) -> Sample:
        return self.load_item(idx)

    # -- pieces shared across protocols -----------------------------------
    def _features_for(self, idx: int) -> Dict[str, Any]:
        features = self.features_db[idx]
        if self.transformer_bbox_processor is not None:
            features["image_info_0"] = self.transformer_bbox_processor(
                features["image_info_0"])
        return features

    def add_answer_info(self, sample_info: Dict[str, Any],
                        sample: Sample) -> Sample:
        """vqa2/dataset.py:133-145: soft VQA-accuracy target vector."""
        if "answers" in sample_info and self.answer_processor is not None:
            processed = self.answer_processor(
                {"answers": sample_info["answers"]})
            sample["targets"] = processed["answers_scores"]
        return sample


class VQA2Dataset(MmfDataset):
    """builders/vqa2/dataset.py:55-105 load_item."""

    def load_item(self, idx: int) -> Sample:
        info = self.annotation_db[idx]
        sample = Sample()

        if "question_tokens" in info:
            # only pass "text" when it is non-empty: processors prefer
            # "text" over "tokens", so an empty question_str would
            # silently tokenize an empty question
            arg = {"tokens": info["question_tokens"]}
            if info.get("question_str"):
                arg["text"] = info["question_str"]
        else:
            arg = {"text": info["question"]}
        processed = self.text_processor(arg)
        sample["text"] = processed["text"]
        if "input_ids" in processed:
            sample.update(processed)

        sample["question_id"] = np.int64(info["question_id"])
        sample["image_id"] = (np.int64(info["image_id"])
                              if isinstance(info["image_id"], int)
                              else info["image_id"])
        if "question_tokens" in info:
            sample["text_len"] = np.int64(len(info["question_tokens"]))

        if self._use_features:
            sample.update(self._features_for(idx))
        return self.add_answer_info(info, sample)


class NLVR2Dataset(MmfDataset):
    """builders/nlvr2/dataset.py:9-50: sentence + (img0, img1)."""

    def load_item(self, idx: int) -> Sample:
        info = self.annotation_db[idx]
        sample = Sample()
        processed = self.text_processor({"text": info["sentence"]})
        sample["text"] = processed["text"]
        if "input_ids" in processed:
            sample.update(processed)

        if self._use_features:
            identifier = "-".join(info["identifier"].split("-")[:-1])
            for slot in ("img0", "img1"):
                feats = self.features_db.from_path(
                    f"{identifier}-{slot}.npy")
                if self.transformer_bbox_processor is not None:
                    feats["image_info_0"] = self.transformer_bbox_processor(
                        feats["image_info_0"])
                sample[slot] = Sample(feats)

        sample["targets"] = np.int64(1 if info["label"] == "True" else 0)
        return sample


class COCOCaptionDataset(MmfDataset):
    """builders/coco/dataset.py:8-61: caption protocol."""

    def load_item(self, idx: int) -> Sample:
        info = dict(self.annotation_db[idx])
        # COCO dbs sometimes carry an image-relative feature path
        # (dataset.py:15-20)
        if "feature_path" in info and "COCO" not in info["feature_path"]:
            info["feature_path"] = info["image_path"].replace(".jpg", ".npy")
        sample = Sample()
        if self.dataset_type != "test":
            processed = self.text_processor(
                {"tokens": info["caption_tokens"]})
            sample["text"] = processed["text"]
            if "input_ids" in processed:
                sample.update(processed)
            sample["caption_id"] = np.int64(info["caption_id"])
            sample["caption_len"] = np.int64(len(info["caption_tokens"]))
        sample["image_id"] = info["image_id"]
        if self._use_features:
            sample.update(self.features_db.get(info))
        return sample


class DatasetBuilder:
    """mmf_dataset_builder.py protocol, reduced to its useful core:
    ``load(config, dataset_type)`` → dataset instance."""

    dataset_class: Callable = VQA2Dataset

    def __init__(self, dataset_name: str):
        self.dataset_name = dataset_name

    def load(self, config: Dict[str, Any],
             dataset_type: str = "train") -> MmfDataset:
        return self.dataset_class(self.dataset_name, config, dataset_type)


def _make_builder(name: str, cls) -> type:
    builder = type(
        f"{name.title().replace('_', '')}Builder", (DatasetBuilder,),
        {"dataset_class": cls,
         "__init__": lambda self, dataset_name=name:
             DatasetBuilder.__init__(self, dataset_name)})
    return registry.register_builder(name)(builder)


# VQA-protocol builders (each is a thin path-config subclass of
# VQA2Dataset in the reference as well)
for _name in ("vqa2", "vqa2_train_val", "vqa2_test", "gqa", "okvqa",
              "vqacp_v2", "vizwiz", "visual_genome"):
    _make_builder(_name, VQA2Dataset)
_make_builder("nlvr2", NLVR2Dataset)
_make_builder("coco", COCOCaptionDataset)
# textvqa + the rest of the zoo tail (OCR family, hateful_memes,
# mmimdb, clevr, visual_dialog, visual_entailment, conceptual_captions,
# vqa_hat) live in extra_builders.py
