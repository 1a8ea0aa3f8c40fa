"""The long tail of the MMF builder zoo (C29 completion).

The port's copy of
``transformer_mm_explainability_tpu/data/extra_builders.py`` (numpy):
importing that module would load the JAX package.

Covers every reference registry name not already provided by
``builders.py`` / ``masked_datasets.py``:

  textvqa / stvqa / textcaps / ocrvqa / vqa2_ocr — the M4C OCR family
    (builders/textvqa/dataset.py:10-245, stvqa/dataset.py:5-21,
    textcaps/dataset.py:6-39, ocrvqa/dataset.py:5-13,
    vqa2/ocr_dataset.py:6-34)
  visual_entailment  — SNLI-VE 3-class protocol
    (builders/visual_entailment/dataset.py:10-48)
  hateful_memes      — binary meme classification, features or raw
    images (builders/hateful_memes/dataset.py:16-105)
  mmimdb             — plot → multi-hot genres
    (builders/mmimdb/dataset.py:9-77)
  clevr              — questions json + rendered PNGs
    (builders/clevr/dataset.py:34-153)
  visual_dialog      — dialogs × 10 rounds
    (builders/visual_dialog/{dataset,database}.py — NOTE: the
    reference implementation is non-functional as shipped: its
    database json.load()s a path string, indexes ``self._questions``
    that is assigned as ``_question``, and uses a float dialog index.
    This rebuild implements the evidently intended protocol.)
  conceptual_captions — first-caption protocol
    (builders/conceptual_captions/dataset.py:7-35)
  vqa_hat / vqa_hat_train_val / vqa_hat_test — VQA-HAT with optional
    OCR detail path (builders/vqa_hat/{dataset,builder}.py)

Reference semantics pinned here, divergences documented inline: strings/lists are kept as Python objects in the ``Sample``
(the reference round-trips them through ``object_to_byte_tensor`` only
because DDP gathers need tensors; a host-side dataset does not).
A config that asks for the ``phoc`` processor raises until the port of
``native/`` brings it (ROADMAP A5d).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import numpy as np

from ..core.sample import Sample
from .builders import MmfDataset, _make_builder
from .databases import ImageDatabase


def _image_db(config: Dict[str, Any], annotation_db, image_processor,
              image_key=None) -> ImageDatabase:
    return ImageDatabase(config["images"], annotation_db=annotation_db,
                         transform=image_processor, image_key=image_key)


def _clevr_tokenize(sentence: str, keep=(";", ","),
                    remove=("?", ".")) -> List[str]:
    """mmf/utils/text.py:29-43 tokenize(): keep-chars get space-padded,
    remove-chars deleted, then whitespace split."""
    sentence = sentence.lower()
    for token in keep:
        sentence = sentence.replace(token, " " + token)
    for token in remove:
        sentence = sentence.replace(token, "")
    return sentence.split()


class _LeanDataset:
    """MmfDataset-shaped wiring for datasets whose annotation file is
    not an MMF imdb (CLEVR questions json, VisDial dialogs json):
    processors + optional features_db, no AnnotationDatabase."""

    def _manual_init(self, name: str, config: Dict[str, Any],
                     dataset_type: str) -> None:
        from .builders import _build_processor
        from .databases import FeaturesDatabase
        self.dataset_name = name
        self.config = config
        self.dataset_type = dataset_type
        p = config.get("processors", {})
        for key, spec in p.items():
            setattr(self, key, _build_processor(spec))
        for key in ("text_processor", "answer_processor",
                    "transformer_bbox_processor"):
            if not hasattr(self, key):
                setattr(self, key, None)
        self._use_features = "features" in config
        self.features_db = (FeaturesDatabase(
            config["features"],
            max_features=config.get("max_features", 100))
            if self._use_features else None)

    def __getitem__(self, idx: int) -> Sample:
        return self.load_item(idx)


# ---------------------------------------------------------------------------
# The M4C OCR family
# ---------------------------------------------------------------------------

class TextVQADataset(MmfDataset):
    """builders/textvqa/dataset.py:85-245 — the OCR-region protocol.

    Per-sample layout (consumed by models/m4c.py):
      text / text_len          question tokens
      obj_bbox_coordinates     [100,4] copy-padded object boxes
      context_feature_0        [N,300] FastText OCR embeddings
      context_feature_1        [N,604] PHOC OCR embeddings
      context_info_0/1         {"max_features": n_ocr}
      ocr_bbox_coordinates     [max_len,4]
      order_vectors            eye(N) zeroed past n_ocr
      targets                  [T, vocab+copy] m4c_answer scores
    """

    def __init__(self, name: str, config: Dict[str, Any],
                 dataset_type: str = "train"):
        super().__init__(name, config, dataset_type)
        self.use_ocr = config.get("use_ocr", True)
        self.use_ocr_info = config.get("use_ocr_info", False)

    # -- feature-path normalization (dataset.py:16-37) ---------------------
    def preprocess_sample_info(self, info: Dict[str, Any]) -> Dict[str, Any]:
        fp = info.get("feature_path")
        if (fp is not None and "COCO" not in fp
                and "image_path" in info):
            info["feature_path"] = info["image_path"].replace(".jpg",
                                                              ".npy")
        return info

    def load_item(self, idx: int) -> Sample:
        info = dict(self.annotation_db[idx])
        info = self.preprocess_sample_info(info)
        sample = Sample()
        # "breaking change from VQA2Dataset: load question_id"
        # (dataset.py:90-93); vqa2_ocr rows may carry None → -1
        # (vqa2/ocr_dataset.py:31-34)
        qid = info.get("question_id")
        sample["question_id"] = np.int64(-1 if qid is None else qid)
        image_id = info["image_id"]
        sample["image_id"] = (str(image_id)
                              if isinstance(image_id, int) else image_id)
        if self._use_features:
            sample.update(self.features_db.get(info))
        sample = self.add_sample_details(info, sample)
        sample = self.add_answer_info(info, sample)
        # only max_features is needed downstream (dataset.py:107-115)
        for k in ("image_info_0", "image_info_1"):
            if k in sample and isinstance(sample[k], dict):
                sample[k] = {"max_features": sample[k].get("max_features")}
        return sample

    def add_sample_details(self, info: Dict[str, Any],
                           sample: Sample) -> Sample:
        # 1. question (dataset.py:122-142)
        args = {"text": info.get("question", info.get("question_str", ""))}
        if "question_tokens" in info:
            args["tokens"] = info["question_tokens"]
        processed = self.text_processor(args)
        if "input_ids" in processed:
            sample["text"] = processed["input_ids"]
            sample["text_len"] = np.int64(len(processed["tokens"]))
        else:
            sample["text"] = processed["text"]
            sample["text_len"] = np.int64(processed["length"])

        # 2. object boxes (dataset.py:145-149)
        copy_proc = getattr(self, "copy_processor", None)
        if "obj_normalized_boxes" in info and copy_proc is not None:
            sample["obj_bbox_coordinates"] = copy_proc(
                {"blob": info["obj_normalized_boxes"]})["blob"]

        # 3. OCR (dataset.py:152-211)
        if not self.use_ocr:
            info["ocr_tokens"] = []
            info["ocr_info"] = []
            if "ocr_normalized_boxes" in info:
                info["ocr_normalized_boxes"] = np.zeros((0, 4),
                                                        np.float32)
            if "image_feature_1" in sample:
                sample["image_feature_1"] = np.zeros_like(
                    sample["image_feature_1"])
            return sample

        tok_proc = getattr(self, "ocr_token_processor", None)
        ocr_tokens = [tok_proc({"text": t})["text"] if tok_proc else t
                      for t in info.get("ocr_tokens", [])]
        context = self.context_processor({"tokens": ocr_tokens})
        sample["context"] = context["text"]
        sample["ocr_tokens"] = context["tokens"]
        sample["context_tokens"] = list(context["tokens"])
        sample["context_feature_0"] = context["text"]
        sample["context_info_0"] = {"max_features": context["length"]}
        phoc_proc = getattr(self, "phoc_processor", None)
        if phoc_proc is not None:
            phoc = phoc_proc({"tokens": ocr_tokens})
            sample["context_feature_1"] = phoc["text"]
            sample["context_info_1"] = {"max_features": phoc["length"]}
        if self.config.get("use_order_vectors", False):
            order = np.eye(len(sample["ocr_tokens"]), dtype=np.float32)
            order[int(context["length"]):] = 0
            sample["order_vectors"] = order
        if "ocr_normalized_boxes" in info and copy_proc is not None:
            max_len = getattr(self.answer_processor, "max_length", 50)
            sample["ocr_bbox_coordinates"] = copy_proc(
                {"blob": info["ocr_normalized_boxes"]})["blob"][:max_len]
        elif self.use_ocr_info and "ocr_info" in info:
            bbox_proc = getattr(self, "bbox_processor", None)
            if bbox_proc is not None:
                sample["ocr_bbox_coordinates"] = bbox_proc(
                    {"info": info["ocr_info"]})["bbox"]["coordinates"]
        return sample

    def add_answer_info(self, info: Dict[str, Any],
                        sample: Sample) -> Sample:
        # dataset.py:213-233: the OCR tokens ride into the answer
        # processor for the soft-copy answer space
        answers = info.get("answers", [])
        processed = self.answer_processor(
            {"answers": answers, "tokens": sample.pop("ocr_tokens", [])})
        sample.update(processed)
        sample["answers"] = list(answers)
        if "answers_scores" in sample:
            sample["targets"] = sample.pop("answers_scores")
        return sample


class STVQADataset(TextVQADataset):
    """builders/stvqa/dataset.py:10-21: train/test_task3 path prefix."""

    def preprocess_sample_info(self, info: Dict[str, Any]) -> Dict[str, Any]:
        fp = info["feature_path"]
        prefix = "test_task3" if self.dataset_type == "test" else "train"
        if not fp.startswith(prefix):
            info["feature_path"] = prefix + "/" + fp
        return info


class TextCapsDataset(TextVQADataset):
    """builders/textcaps/dataset.py:6-39: captioning through the M4C
    decoder — empty question, caption as the single answer."""

    def preprocess_sample_info(self, info: Dict[str, Any]) -> Dict[str, Any]:
        info = super().preprocess_sample_info(info)
        info["question_str"] = ""
        info["question_id"] = info["caption_id"]
        return info

    def add_answer_info(self, info: Dict[str, Any],
                        sample: Sample) -> Sample:
        has_caption = "caption_str" in info
        if has_caption:
            info["answers"] = [info["caption_str"]]
        sample = super().add_answer_info(info, sample)
        if has_caption:
            sample["caption_str"] = info["caption_str"]
            sample["ref_strs"] = info.get("reference_strs", [])
            sample.pop("answers")
        return sample


class OCRVQADataset(TextVQADataset):
    """builders/ocrvqa/dataset.py:5-13: feature paths are already
    correct — preprocessing is a no-op."""

    def preprocess_sample_info(self, info: Dict[str, Any]) -> Dict[str, Any]:
        return info


class VQA2OCRDataset(TextVQADataset):
    """vqa2/ocr_dataset.py:6-34 — legacy VizWiz-derived OCR VQA feed;
    rebuilt on the modern OCR protocol (the reference subclass only
    adds a question_id=None→-1 default, handled in the base load_item,
    and an argmax prediction format)."""

    def preprocess_sample_info(self, info: Dict[str, Any]) -> Dict[str, Any]:
        return info


# ---------------------------------------------------------------------------
# Classification-style datasets
# ---------------------------------------------------------------------------

VE_LABELS = {"entailment": 0, "neutral": 1, "contradiction": 2}


class VisualEntailmentDataset(MmfDataset):
    """builders/visual_entailment/dataset.py:10-48."""

    def load_item(self, idx: int) -> Sample:
        info = self.annotation_db[idx]
        sample = Sample()
        processed = self.text_processor({"text": info["sentence2"]})
        sample["text"] = processed["text"]
        if "input_ids" in processed:
            sample.update(processed)
        if self._use_features:
            # "Flikr30kID" [sic] — the reference key is misspelled
            identifier = info["Flikr30kID"].split(".")[0]
            feats = self.features_db.from_path(f"{identifier}.npy")
            if self.transformer_bbox_processor is not None:
                feats["image_info_0"] = self.transformer_bbox_processor(
                    feats["image_info_0"])
            sample.update(feats)
        sample["targets"] = np.int64(VE_LABELS[info["gold_label"]])
        return sample


class HatefulMemesDataset(MmfDataset):
    """builders/hateful_memes/dataset.py:16-105 — features and
    raw-image variants folded into one class (config decides, like the
    reference builder's ``load``)."""

    def __init__(self, name: str, config: Dict[str, Any],
                 dataset_type: str = "train"):
        super().__init__(name, config, dataset_type)
        self._use_images = "images" in config
        if self._use_images:
            self.image_db = _image_db(
                config, self.annotation_db,
                getattr(self, "image_processor", None), image_key="img")
        if not (self._use_features or self._use_images):
            raise ValueError(
                "hateful_memes needs 'features' or 'images' in config")

    def preprocess_sample_info(self, info: Dict[str, Any]) -> Dict[str, Any]:
        # img/02345.png -> 02345.npy (dataset.py:23-29)
        info = dict(info)
        stem = info["img"].split("/")[-1].split(".")[0]
        info["feature_path"] = f"{stem}.npy"
        return info

    def load_item(self, idx: int) -> Sample:
        info = self.preprocess_sample_info(self.annotation_db[idx])
        sample = Sample()
        processed = self.text_processor({"text": info["text"]})
        sample["text"] = processed["text"]
        if "input_ids" in processed:
            sample.update(processed)
        sample["id"] = np.int64(int(info["id"]))
        if self._use_features:
            feats = self.features_db.get(info)
            if self.transformer_bbox_processor is not None:
                feats["image_info_0"] = self.transformer_bbox_processor(
                    feats["image_info_0"])
            sample.update(feats)
        else:
            sample["image"] = self.image_db[idx]["images"][0]
        if "label" in info:
            sample["targets"] = np.int64(info["label"])
        return sample

    @staticmethod
    def format_for_prediction(report: Dict[str, Any]) -> List[Dict]:
        """dataset.py:110-123: id/proba/label rows (softmax over the
        two logits; proba = P(hateful))."""
        scores = np.asarray(report["scores"], np.float32)
        e = np.exp(scores - scores.max(axis=1, keepdims=True))
        probs = e / e.sum(axis=1, keepdims=True)
        return [{"id": int(i), "proba": float(p[1]),
                 "label": int(p.argmax())}
                for i, p in zip(report["id"], probs)]


class MMIMDbDataset(MmfDataset):
    """builders/mmimdb/dataset.py:9-77 (features + image variants)."""

    def __init__(self, name: str, config: Dict[str, Any],
                 dataset_type: str = "train"):
        super().__init__(name, config, dataset_type)
        self._use_images = "images" in config
        if self._use_images:
            self.image_db = _image_db(
                config, self.annotation_db,
                getattr(self, "image_processor", None))

    def load_item(self, idx: int) -> Sample:
        info = self.annotation_db[idx]
        sample = Sample()
        plot = info["plot"]
        if isinstance(plot, list):
            plot = plot[0]
        processed = self.text_processor({"text": plot})
        sample["text"] = processed["text"]
        if "input_ids" in processed:
            sample.update(processed)
        if self._use_features:
            feats = self.features_db[idx]
            if self.transformer_bbox_processor is not None:
                feats["image_info_0"] = self.transformer_bbox_processor(
                    feats["image_info_0"])
            sample.update(feats)
        elif self._use_images:
            sample["image"] = self.image_db[idx]["images"][0]
        processed = self.answer_processor({"answers": info["genres"]})
        sample["answers"] = processed["answers"]
        sample["targets"] = processed["answers_scores"]
        return sample


class CLEVRDataset(_LeanDataset):
    """builders/clevr/dataset.py:34-153 — questions json + rendered
    PNGs.  The reference's vocab-building step is a preprocessing
    concern; here the text/answer processors come from config like
    every other dataset."""

    def __init__(self, name: str, config: Dict[str, Any],
                 dataset_type: str = "train"):
        data_folder = config.get("data_folder")
        config = dict(config)
        if data_folder is not None and "annotations" not in config:
            config["annotations"] = os.path.join(
                data_folder, "questions",
                f"CLEVR_{dataset_type}_questions.json")
            config.setdefault("images",
                              os.path.join(data_folder, "images",
                                           dataset_type))
        self._manual_init(name, config, dataset_type)
        with open(config["annotations"], encoding="utf-8") as f:
            self.questions = json.load(f)["questions"]
        self.image_db = (_image_db(config, None, None)
                         if "images" in config else None)

    def __len__(self) -> int:
        return len(self.questions)

    def load_item(self, idx: int) -> Sample:
        info = self.questions[idx]
        sample = Sample()
        tokens = _clevr_tokenize(info["question"])
        processed = self.text_processor({"tokens": tokens})
        sample["text"] = processed["text"]
        processed = self.answer_processor({"answers": [info["answer"]]})
        sample["answers"] = processed["answers"]
        sample["targets"] = processed["answers_scores"]
        if self.image_db is not None:
            img = self.image_db.from_path(
                info["image_filename"])["images"][0]
            # CHW float in [0,1] (dataset.py:148-151)
            sample["image"] = (np.asarray(img, np.float32) / 255.0
                               ).transpose(2, 0, 1)
        return sample


class VisualDialogDataset(_LeanDataset):
    """visual_dialog/{database,dataset}.py — dialogs × rounds.

    The annotation file is the VisDial json:
      {"data": {"questions": [...], "answers": [...],
                "dialogs": [{"image_id", "dialog": [{"question": qi,
                 "answer": ai, "answer_options": [...]}, ...]}, ...]},
       "split": "train"}
    Each item = one (dialog, round); train/val expose 10 rounds per
    dialog, test 1 (database.py:28-30).
    """

    def __init__(self, name: str, config: Dict[str, Any],
                 dataset_type: str = "train"):
        self._manual_init(name, config, dataset_type)
        with open(config["annotations"], encoding="utf-8") as f:
            raw = json.load(f)
        data = raw.get("data", raw)
        self._questions = data["questions"]
        self._answers = data["answers"]
        self._dialogs = data["dialogs"]
        self._is_test = raw.get("split", dataset_type) == "test"
        self._multiplier = 1 if self._is_test else 10

    def __len__(self) -> int:
        return len(self._dialogs) * self._multiplier

    def load_item(self, idx: int) -> Sample:
        dialog_id, round_id = divmod(idx, self._multiplier)
        dialog = self._dialogs[dialog_id]
        rnd = dialog["dialog"][round_id]
        sample = Sample()
        sample["id"] = np.int64(idx)
        sample["dialog_id"] = np.int64(dialog_id)
        sample["round_id"] = np.int64(round_id)
        sample["image_id"] = dialog["image_id"]
        processed = self.text_processor(
            {"text": self._questions[rnd["question"]]})
        sample["text"] = processed["text"]
        if "input_ids" in processed:
            sample.update(processed)
        if self._use_features:
            sample.update(self.features_db.from_path(
                f"{dialog['image_id']}.npy"))
        if "answer" in rnd and self.answer_processor is not None:
            processed = self.answer_processor(
                {"answers": [self._answers[rnd["answer"]]]})
            sample["targets"] = processed["answers_scores"]
        return sample


class ConceptualCaptionsDataset(MmfDataset):
    """builders/conceptual_captions/dataset.py:7-35."""

    def load_item(self, idx: int) -> Sample:
        info = self.annotation_db[idx]
        sample = Sample()
        processed = self.text_processor({"text": info["captions"][0]})
        sample["text"] = processed["text"]
        sample["caption_len"] = np.int64(len(processed["text"]))
        sample["image_id"] = (np.int64(info["image_id"])
                              if isinstance(info["image_id"], int)
                              else info["image_id"])
        if self._use_features:
            sample.update(self.features_db[idx])
        sample["answers"] = np.stack([processed["text"]])
        return sample


class VQAHATDataset(MmfDataset):
    """builders/vqa_hat/dataset.py:14-147 — VQA with human attention;
    question protocol + optional legacy OCR details + image fallback."""

    def __init__(self, name: str, config: Dict[str, Any],
                 dataset_type: str = "train"):
        super().__init__(name, config, dataset_type)
        self.use_ocr = config.get("use_ocr", False)
        self.use_ocr_info = config.get("use_ocr_info", False)
        self._use_images = "images" in config
        if self._use_images:
            self.image_db = _image_db(
                config, self.annotation_db,
                getattr(self, "image_processor", None))

    def load_item(self, idx: int) -> Sample:
        info = self.annotation_db[idx]
        sample = Sample()
        if "question_tokens" in info:
            args = {"tokens": info["question_tokens"],
                    "text": info.get("question_str", "")}
        else:
            args = {"text": info["question"]}
        processed = self.text_processor(args)
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
            feats = self.features_db[idx]
            if self.transformer_bbox_processor is not None:
                feats["image_info_0"] = self.transformer_bbox_processor(
                    feats["image_info_0"])
            sample.update(feats)
        elif self._use_images:
            sample["image"] = self.image_db.from_path(
                info["image_name"] + ".jpg")["images"][0]
        sample = self.add_ocr_details(info, sample)
        return self.add_answer_info(info, sample)

    def add_ocr_details(self, info: Dict[str, Any],
                        sample: Sample) -> Sample:
        if self.use_ocr:
            tok_proc = getattr(self, "ocr_token_processor", None)
            ocr_tokens = [tok_proc({"text": t})["text"] if tok_proc else t
                          for t in info.get("ocr_tokens", [])]
            context = self.context_processor({"tokens": ocr_tokens})
            sample["context"] = context["text"]
            sample["context_tokens"] = list(context["tokens"])
            sample["context_feature_0"] = context["text"]
            sample["context_info_0"] = {"max_features": context["length"]}
            order = np.eye(len(context["tokens"]), dtype=np.float32)
            order[int(context["length"]):] = 0
            sample["order_vectors"] = order
        if self.use_ocr_info and "ocr_info" in info:
            bbox_proc = getattr(self, "bbox_processor", None)
            if bbox_proc is not None:
                sample["ocr_bbox"] = bbox_proc(
                    {"info": info["ocr_info"]})["bbox"]
        return sample

    def add_answer_info(self, info: Dict[str, Any],
                        sample: Sample) -> Sample:
        if "answers" in info and self.answer_processor is not None:
            arg = {"answers": info["answers"]}
            if self.use_ocr:
                arg["tokens"] = info.get("ocr_tokens", [])
            processed = self.answer_processor(arg)
            sample["targets"] = processed["answers_scores"]
        return sample


# ---------------------------------------------------------------------------
# registration (reference names, builders/*/builder.py)
# ---------------------------------------------------------------------------

for _name, _cls in (
        ("textvqa", TextVQADataset),
        ("stvqa", STVQADataset),
        ("textcaps", TextCapsDataset),
        ("ocrvqa", OCRVQADataset),
        ("vqa2_ocr", VQA2OCRDataset),
        ("visual_entailment", VisualEntailmentDataset),
        ("hateful_memes", HatefulMemesDataset),
        ("mmimdb", MMIMDbDataset),
        ("clevr", CLEVRDataset),
        ("visual_dialog", VisualDialogDataset),
        ("conceptual_captions", ConceptualCaptionsDataset),
        ("vqa_hat", VQAHATDataset),
        ("vqa_hat_train_val", VQAHATDataset),
        ("vqa_hat_test", VQAHATDataset)):
    _make_builder(_name, _cls)
