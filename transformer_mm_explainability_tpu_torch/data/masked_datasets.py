"""Masked pretraining datasets (C29 — VisualBERT's pretraining feed).

The port's copy of
``transformer_mm_explainability_tpu/data/masked_datasets.py`` (numpy):
importing that module would load the JAX package.

Re-design of the reference's masked dataset family:

- ``MaskedCOCODataset``
  (mmf/datasets/builders/coco/masked_dataset.py): caption two-sentence
  sampling (matching second caption vs a mismatching caption from a
  random other image) or false-caption swapping, + masked-token /
  masked-region processing.
- ``MaskedVQA2Dataset`` (builders/vqa2/masked_dataset.py): masked
  question paired with one randomly-chosen ground-truth answer,
  ``is_correct = -1``.
- ``MaskedVisualGenomeDataset``
  (builders/visual_genome/masked_dataset.py): masked question with the
  reference's answer preprocessing — note this is SUBSTRING
  replacement (word_tokenize ``remove=["?", ",", ".", "a", "an",
  "the"]``), so e.g. "black cat" → "blck ct".  Reproduced verbatim
  (a pinned reference quirk): answers scored through this path must
  mangle identically or they stop matching the published setup.

Divergence pinned: the reference drives sampling from the GLOBAL
``random`` module; here every dataset owns an explicit seeded
``random.Random`` (re-creating the dataset
replays the same masking/caption draws).

Also built: ``MaskedQVQA2Dataset`` (masked_q_vqa2_dataset.py — mask
one question token, predict it as the answer),
``MaskedMMImdbDataset`` (mmimdb/masked_dataset.py — plot + random
genre), and ``MaskedLocalizedNarrativesDataset``
(localized_narratives/masked_dataset.py — whole-caption masking, the
mixin flickr30k and coco2017 reuse).

Registered builders: ``masked_coco``, ``masked_conceptual_captions``
(an alias — the reference's masked CC dataset subclasses MaskedCOCO
unchanged), ``masked_vqa2``, ``masked_visual_genome``,
``masked_q_vqa2``, ``masked_mmimdb``, ``masked_localized_narratives``,
``masked_flickr30k``, ``masked_coco2017``.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Optional

import numpy as np

from ..core.sample import Sample
from .builders import (MmfDataset, VQA2Dataset, _build_processor,
                       _make_builder)
from .processors import word_tokenize


class _MaskedMixin:
    """Shared config knobs + the masked-region feature path."""

    def _init_masked(self, config: Dict[str, Any]) -> None:
        p = config.get("processors", {})
        self.masked_token_processor = _build_processor(
            p.get("masked_token_processor"))
        self.masked_region_processor = _build_processor(
            p.get("masked_region_processor"))
        self._rng = random.Random(config.get("seed", 0))

    def _masked_features(self, idx: int, sample: Sample) -> Sample:
        """masked_dataset.py:20-38 (all three copies share this)."""
        features = self._features_for(idx)
        if (self.config.get("use_image_feature_masks", False)
                and self.masked_region_processor is not None):
            sample["image_labels"] = self.masked_region_processor(
                features["image_feature_0"])
        sample.update(features)
        return sample


class MaskedCOCODataset(MmfDataset, _MaskedMixin):
    """coco/masked_dataset.py:7-94."""

    def __init__(self, name: str, config: Dict[str, Any],
                 dataset_type: str = "train"):
        super().__init__(name, config, dataset_type)
        self._init_masked(config)
        self._two_sentence = config.get("two_sentence", True)
        self._false_caption = config.get("false_caption", True)
        self._two_sentence_probability = config.get(
            "two_sentence_probability", 0.5)
        self._false_caption_probability = config.get(
            "false_caption_probability", 0.5)

    def load_item(self, idx: int) -> Sample:
        info = self.annotation_db[idx]
        sample = Sample()
        if self._use_features:
            sample = self._masked_features(idx, sample)
        return self._add_masked_caption(info, sample)

    def _get_mismatching_caption(self, image_id) -> str:
        """:84-94: a caption from a random OTHER image."""
        other = self.annotation_db[
            self._rng.randint(0, len(self.annotation_db) - 1)]
        while other["image_id"] == image_id:
            other = self.annotation_db[
                self._rng.randint(0, len(self.annotation_db) - 1)]
        return other["captions"][
            self._rng.randint(0, len(other["captions"]) - 1)]

    def _add_masked_caption(self, info: Dict[str, Any],
                            sample: Sample) -> Sample:
        """:44-81."""
        captions = info["captions"]
        image_id = info["image_id"]
        selected_idx = self._rng.randint(0, len(captions) - 1)
        other_indices = [i for i in range(len(captions))
                         if i != selected_idx]
        selected_caption = captions[selected_idx]
        other_caption = None
        is_correct = -1

        if self.dataset_type == "train":
            if self._two_sentence:
                if self._rng.random() > self._two_sentence_probability:
                    other_caption = self._get_mismatching_caption(image_id)
                    is_correct = False
                else:
                    other_caption = captions[
                        self._rng.choice(other_indices)]
                    is_correct = True
            elif self._false_caption:
                if self._rng.random() < self._false_caption_probability:
                    selected_caption = self._get_mismatching_caption(
                        image_id)
                    is_correct = False
                else:
                    is_correct = True

        processed = self.masked_token_processor({
            "text_a": selected_caption, "text_b": other_caption,
            "is_correct": is_correct})
        processed.pop("tokens")
        sample.update(processed)
        return sample


class MaskedVQA2Dataset(VQA2Dataset, _MaskedMixin):
    """vqa2/masked_dataset.py:7-60."""

    def __init__(self, name: str, config: Dict[str, Any],
                 dataset_type: str = "train"):
        super().__init__(name, config, dataset_type)
        self._init_masked(config)
        self._add_answer = config.get("add_answer", False)

    def load_item(self, idx: int) -> Sample:
        info = self.annotation_db[idx]
        sample = Sample()
        if self._use_features:
            sample = self._masked_features(idx, sample)
        sample = self._add_masked_question(info, sample)
        if self._add_answer:
            sample = self.add_answer_info(info, sample)
        return sample

    def _add_masked_question(self, info: Dict[str, Any],
                             sample: Sample) -> Sample:
        """:49-60: question + one random gt answer, is_correct = -1."""
        question = info["question_str"]
        random_answer = self._rng.choice(info["all_answers"])
        processed = self.masked_token_processor({
            "text_a": question, "text_b": random_answer,
            "is_correct": -1})
        processed.pop("tokens")
        sample.update(processed)
        return sample


class MaskedVisualGenomeDataset(MmfDataset, _MaskedMixin):
    """visual_genome/masked_dataset.py:7-79."""

    ANSWER_REMOVE = ["?", ",", ".", "a", "an", "the"]

    def __init__(self, name: str, config: Dict[str, Any],
                 dataset_type: str = "train"):
        super().__init__(name, config, dataset_type)
        self._init_masked(config)
        self._add_answer = config.get("add_answer", True)

    def load_item(self, idx: int) -> Sample:
        info = dict(self.annotation_db[idx])
        info["answers"] = [word_tokenize(info["answers"][0],
                                         remove=self.ANSWER_REMOVE)]
        info["question_id"] = info["id"]
        sample = Sample()
        if self._use_features:
            sample = self._masked_features(idx, sample)
        sample = self._add_masked_question(info, sample)
        if self._add_answer:
            sample = self.add_answer_info(info, sample)
        return sample

    def _add_masked_question(self, info: Dict[str, Any],
                             sample: Sample) -> Sample:
        """:69-79: question only, no second segment."""
        processed = self.masked_token_processor({
            "text_a": info["question"], "text_b": None,
            "is_correct": -1})
        processed.pop("tokens")
        sample.update(processed)
        return sample


class MaskedQVQA2Dataset(VQA2Dataset):
    """vqa2/masked_q_vqa2_dataset.py:6-28: mask ONE random question
    token (vocab-index path) and make its word the answer target;
    target zeroed when the word is answer-vocab <unk>."""

    def __init__(self, name: str, config: Dict[str, Any],
                 dataset_type: str = "train"):
        super().__init__(name, config, dataset_type)
        self._rng = random.Random(config.get("seed", 0))

    def add_answer_info(self, info: Dict[str, Any],
                        sample: Sample) -> Sample:
        text = np.asarray(sample["text"]).copy()
        if "text_len" in sample:
            length = min(len(text), int(sample["text_len"]))
        else:
            # {'question': ...} annotations never set text_len; real
            # tokens are the non-<pad> prefix (Vocab PAD_INDEX = 0)
            length = int((text != 0).sum())
        if length < 1:
            raise ValueError("masked_q_vqa2: empty question")
        index = self._rng.randint(0, length - 1)
        word = self.text_processor.vocab.get_itos()[int(text[index])]
        text[index] = self.text_processor.vocab.get_stoi()["<mask>"]
        sample["text"] = text
        processed = self.answer_processor({"answer_tokens": [word]})
        sample["answers"] = processed["answers"]
        targets = processed["answers_scores"]
        if (self.answer_processor.word2idx(word)
                == self.answer_processor.word2idx("<unk>")):
            targets = np.zeros_like(targets)
        sample["targets"] = targets
        return sample


class MaskedMMImdbDataset(MmfDataset, _MaskedMixin):
    """mmimdb/masked_dataset.py:7-60: movie plot as text_a, one random
    genre as text_b, is_correct = -1 (plain MMFDataset base, like the
    reference — no question protocol)."""

    def __init__(self, name: str, config: Dict[str, Any],
                 dataset_type: str = "train"):
        super().__init__(name, config, dataset_type)
        self._init_masked(config)

    def load_item(self, idx: int) -> Sample:
        info = self.annotation_db[idx]
        sample = Sample()
        if self._use_features:
            sample = self._masked_features(idx, sample)
        plot = info["plot"]
        if isinstance(plot, list):
            plot = plot[0]
        processed = self.masked_token_processor({
            "text_a": plot,
            "text_b": self._rng.choice(info["genres"]),
            "is_correct": -1})
        processed.pop("tokens")
        sample.update(processed)
        return sample


class MaskedLocalizedNarrativesDataset(MmfDataset, _MaskedMixin):
    """localized_narratives/masked_dataset.py:12-39 (the mixin shared
    by masked_flickr30k and masked_coco2017): whole caption as text_a,
    empty text_b, is_correct = True; image_info_0's image_id renamed
    to feature_path."""

    def __init__(self, name: str, config: Dict[str, Any],
                 dataset_type: str = "train"):
        super().__init__(name, config, dataset_type)
        self._init_masked(config)

    def load_item(self, idx: int) -> Sample:
        info = self.annotation_db[idx]
        sample = Sample()
        processed = self.masked_token_processor({
            "text_a": info["caption"], "text_b": "",
            "is_correct": True})
        processed.pop("tokens", None)
        sample.update(processed)
        sample["image_id"] = info["image_id"]
        sample["feature_path"] = info["feature_path"]
        if self._use_features:
            features = self.features_db[idx]
            image_info_0 = features.get("image_info_0")
            if image_info_0 and "image_id" in image_info_0:
                image_info_0["feature_path"] = image_info_0.pop(
                    "image_id")
            sample.update(features)
        return sample


_make_builder("masked_coco", MaskedCOCODataset)
# the reference's masked conceptual-captions dataset is MaskedCOCO
# with a different data path (builders/conceptual_captions)
_make_builder("masked_conceptual_captions", MaskedCOCODataset)
_make_builder("masked_vqa2", MaskedVQA2Dataset)
_make_builder("masked_visual_genome", MaskedVisualGenomeDataset)
_make_builder("masked_q_vqa2", MaskedQVQA2Dataset)
_make_builder("masked_mmimdb", MaskedMMImdbDataset)
_make_builder("masked_localized_narratives",
              MaskedLocalizedNarrativesDataset)
# flickr30k/coco2017 masked datasets are the localized-narratives
# mixin under other names (flickr30k/masked_dataset.py:10,
# coco2017/masked_dataset.py:10)
_make_builder("masked_flickr30k", MaskedLocalizedNarrativesDataset)
_make_builder("masked_coco2017", MaskedLocalizedNarrativesDataset)
# masked_gqa (gqa/masked_dataset.py:9-54) is MaskedVQA2's
# question+random-answer protocol verbatim (its `add_answer` config
# knob is read but never used); masked_sbu (sbu_captions/
# masked_dataset.py:6-13) is MaskedCOCO with a renamed dataset
_make_builder("masked_gqa", MaskedVQA2Dataset)
_make_builder("masked_sbu", MaskedCOCODataset)
