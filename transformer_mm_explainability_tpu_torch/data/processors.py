"""MMF-style sample processors (C29 datasets layer).

The port's copy of ``transformer_mm_explainability_tpu/data/processors.py``
(numpy): importing that module would load the JAX package.

Host-side text/answer/bbox preparation feeding the device programs. Faithful ports of the processors on the VisualBERT VQA path
(VisualBERT/mmf/datasets/processors/processors.py and
bert_processors.py), registered under the reference names via
``core.registry`` so configs written for MMF resolve here:

  simple_word / simple_sentence   processors.py:823-860
  vqa_answer                      processors.py:529-714
  multi_hot_answer_from_vocab     processors.py:716-726
  bert_tokenizer / masked_token   bert_processors.py:16-173
  transformer_bbox                processors.py:1437-1465

Processors take/return plain dicts of numpy arrays (no OmegaConf; torch
only inside ``torchvision_transforms``' resize and crop); configs are plain
dicts. Every processor of the JAX module is registered here but ``phoc``,
which waits for the port of ``native/`` (ROADMAP A5d).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core.registry import registry
from .tokenization import BertTokenizer

SENTENCE_SPLIT_REGEX = re.compile(r"(\W+)")


def tokenize(sentence: str, keep=("'s",), remove=(",", "?")) -> List[str]:
    """mmf/utils/text.py:64-80."""
    sentence = sentence.lower()
    for token in keep:
        sentence = sentence.replace(token, " " + token)
    for token in remove:
        sentence = sentence.replace(token, "")
    return [t.strip() for t in SENTENCE_SPLIT_REGEX.split(sentence)
            if t.strip()]


def word_tokenize(word: str, remove=(",", "?")) -> str:
    """mmf/utils/text.py:83-92."""
    word = word.lower()
    for item in remove:
        word = word.replace(item, "")
    return word.replace("'s", " 's").strip()


class VocabDict:
    """mmf/utils/text.py:101-170: newline vocab file, <unk> prepended
    when absent."""

    UNK_TOKEN = "<unk>"

    def __init__(self, vocab_file: Optional[str] = None,
                 words: Optional[Sequence[str]] = None):
        if words is None:
            with open(vocab_file, encoding="utf-8") as f:
                words = [line.strip() for line in f if line.strip()]
        self.word_list = list(words)
        if self.UNK_TOKEN not in self.word_list:
            self.word_list = [self.UNK_TOKEN] + self.word_list
        self.word2idx_dict = {w: i for i, w in enumerate(self.word_list)}
        self.UNK_INDEX = self.word2idx_dict[self.UNK_TOKEN]
        self.num_vocab = len(self.word_list)

    def idx2word(self, idx: int) -> str:
        return self.word_list[idx]

    def word2idx(self, w: str) -> int:
        return self.word2idx_dict.get(w, self.UNK_INDEX)

    def __len__(self) -> int:
        return self.num_vocab


@registry.register_processor("simple_word")
class SimpleWordProcessor:
    def __init__(self, config: Optional[Dict] = None):
        pass

    def __call__(self, item: Dict[str, Any]) -> Dict[str, Any]:
        return {"text": word_tokenize(item["text"])}


@registry.register_processor("simple_sentence")
class SimpleSentenceProcessor:
    def __init__(self, config: Optional[Dict] = None):
        pass

    def __call__(self, item: Dict[str, Any]) -> Dict[str, Any]:
        return {"text": tokenize(item["text"])}


@registry.register_processor("vqa_answer")
class VQAAnswerProcessor:
    """processors.py:529-714. Scores follow the VQA accuracy formula:
    for each unique answer a, avg over the 10 leave-one-out subsets of
    min(1, matches/3) (compute_answers_scores, :681-707)."""

    DEFAULT_NUM_ANSWERS = 10

    def __init__(self, config: Dict[str, Any]):
        if "vocab_file" in config:
            self.answer_vocab = VocabDict(vocab_file=config["vocab_file"])
        else:
            self.answer_vocab = VocabDict(words=config["vocab"])
        self.num_answers = config.get("num_answers",
                                      self.DEFAULT_NUM_ANSWERS)
        prep = config.get("preprocessor")
        self.preprocessor = (registry.get("processor", prep)({})
                             if prep else None)

    def get_vocab_size(self) -> int:
        return self.answer_vocab.num_vocab

    def get_true_vocab_size(self) -> int:
        """processors.py:614-616: same as get_vocab_size here; the
        soft-copy subclass widens get_vocab_size but not this."""
        return self.answer_vocab.num_vocab

    def word2idx(self, word: str) -> int:
        return self.answer_vocab.word2idx(word)

    def idx2word(self, idx: int) -> str:
        return self.answer_vocab.idx2word(idx)

    def _increase_to_ten(self, tokens: List[str]) -> List[str]:
        while len(tokens) < self.DEFAULT_NUM_ANSWERS:
            tokens += tokens[:self.DEFAULT_NUM_ANSWERS - len(tokens)]
        return tokens

    def compute_answers_scores(self, answers_indices: np.ndarray
                               ) -> np.ndarray:
        scores = np.zeros((self.get_vocab_size(),), np.float32)
        gt_answers = list(enumerate(answers_indices.tolist()))
        for answer in set(answers_indices.tolist()):
            accs = []
            for gt_answer in gt_answers:
                others = [it for it in gt_answers if it != gt_answer]
                matching = [it for it in others if it[1] == answer]
                accs.append(min(1.0, len(matching) / 3.0))
            if answer != self.answer_vocab.UNK_INDEX:
                scores[answer] = sum(accs) / len(accs)
        return scores

    def __call__(self, item: Dict[str, Any]) -> Dict[str, Any]:
        if "answer_tokens" in item:
            tokens = list(item["answer_tokens"])
        elif item.get("answers") is not None:
            assert self.preprocessor is not None, (
                "'preprocessor' must be set when passing raw 'answers'")
            tokens = [self.preprocessor({"text": a})["text"]
                      for a in item["answers"]]
        else:
            raise AssertionError(
                "'answers' or 'answer_tokens' required")
        if tokens:
            tokens = self._increase_to_ten(tokens)
        answers_indices = np.full((self.DEFAULT_NUM_ANSWERS,),
                                  self.answer_vocab.UNK_INDEX, np.int64)
        for i, token in enumerate(tokens):
            answers_indices[i] = self.answer_vocab.word2idx(token)
        return {
            "answers": tokens,
            "answers_indices": answers_indices,
            "answers_scores": self.compute_answers_scores(answers_indices),
        }


@registry.register_processor("multi_hot_answer_from_vocab")
class MultiHotAnswerFromVocabProcessor(VQAAnswerProcessor):
    def compute_answers_scores(self, answers_indices: np.ndarray
                               ) -> np.ndarray:
        scores = np.zeros((self.get_vocab_size(),), np.float32)
        scores[answers_indices] = 1.0
        scores[self.answer_vocab.UNK_INDEX] = 0.0
        return scores


@registry.register_processor("masked_token")
class MaskedTokenProcessor:
    """bert_processors.MaskedTokenProcessor (:16-139): wordpiece both
    sides, pair-truncate, [CLS] a [SEP] (b [SEP]), BERT-style random
    masking, pad to max_seq_length. Randomness comes from an explicit
    ``np.random.RandomState`` (constructed from config seed) — never
    global state."""

    _MASK_TOKEN = "[MASK]"

    def __init__(self, config: Dict[str, Any]):
        tk = config.get("tokenizer_config", {})
        self._tokenizer = BertTokenizer(
            vocab_path=tk.get("vocab_path"), vocab=tk.get("vocab"))
        self._max_seq_length = config["max_seq_length"]
        self._probability = config.get("mask_probability", 0.15)
        self._rng = np.random.RandomState(config.get("seed", 0))
        self._mask_id = self._tokenizer.vocab.get(self._MASK_TOKEN, 103)

    def get_vocab_size(self) -> int:
        return len(self._tokenizer.vocab)

    def _random_word(self, ids: List[int], probability: float):
        labels = []
        for i, tid in enumerate(ids):
            prob = self._rng.random_sample()
            if probability > 0 and prob < probability:
                prob /= probability
                if prob < 0.8:
                    ids[i] = self._mask_id
                elif prob < 0.9:
                    ids[i] = int(self._rng.randint(self.get_vocab_size()))
                labels.append(tid)
            else:
                labels.append(-1)
        return ids, labels

    @staticmethod
    def _truncate_seq_pair(a: List[int], b: Optional[List[int]],
                           max_length: int):
        if b is None:
            b = []
        else:
            max_length -= 1
            assert max_length >= 0
        while len(a) + len(b) > max_length:
            (a if len(a) > len(b) else b).pop()

    def _convert_to_indices(self, ids_a: List[int],
                            ids_b: Optional[List[int]],
                            probability: float) -> Dict[str, np.ndarray]:
        tok = self._tokenizer
        ids_a, label_a = self._random_word(ids_a, probability)
        input_ids = [tok.cls] + ids_a + [tok.sep]
        segment_ids = [0] * len(input_ids)
        if ids_b:
            ids_b, label_b = self._random_word(ids_b, probability)
            lm_label_ids = [-1] + label_a + [-1] + label_b + [-1]
            input_ids += ids_b + [tok.sep]
            segment_ids += [1] * (len(ids_b) + 1)
        else:
            lm_label_ids = [-1] + label_a + [-1]
        input_mask = [1] * len(input_ids)
        while len(input_ids) < self._max_seq_length:
            input_ids.append(0)
            input_mask.append(0)
            segment_ids.append(0)
            lm_label_ids.append(-1)
        return {
            "input_ids": np.asarray(input_ids, np.int64),
            "input_mask": np.asarray(input_mask, np.int64),
            "segment_ids": np.asarray(segment_ids, np.int64),
            "lm_label_ids": np.asarray(lm_label_ids, np.int64),
            "tokens": [tok.inv.get(i, "[UNK]") for i in input_ids
                       if i != 0][:int(np.sum(input_mask))],
        }

    def __call__(self, item: Dict[str, Any]) -> Dict[str, Any]:
        ids_a = self._tokenizer.tokenize_ids(item["text_a"])
        text_b = item.get("text_b")
        ids_b = self._tokenizer.tokenize_ids(text_b) if text_b else None
        self._truncate_seq_pair(ids_a, ids_b, self._max_seq_length - 2)
        out = self._convert_to_indices(ids_a, ids_b, self._probability)
        if "is_correct" in item:
            out["is_correct"] = np.int64(item["is_correct"])
        return out


@registry.register_processor("bert_tokenizer")
class BertTokenizerProcessor(MaskedTokenProcessor):
    """bert_processors.BertTokenizer (:143-173): masking disabled."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        self._probability = 0.0

    def __call__(self, item: Dict[str, Any]) -> Dict[str, Any]:
        text_a = item["text"] if "text" in item else " ".join(item["tokens"])
        if isinstance(text_a, list):
            text_a = " ".join(text_a)
        ids_a = self._tokenizer.tokenize_ids(text_a)
        text_b = item.get("text_b")
        ids_b = self._tokenizer.tokenize_ids(text_b) if text_b else None
        self._truncate_seq_pair(ids_a, ids_b, self._max_seq_length - 2)
        out = self._convert_to_indices(ids_a, ids_b, self._probability)
        out["text"] = out["tokens"]
        return out


@registry.register_processor("transformer_bbox")
class TransformerBboxProcessor:
    """processors.py:1437-1465: xyxy boxes → 5-dim normalized
    [x0/w, y0/h, x1/w, y1/h, area_fraction]."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.bbox_key = config.get("bbox_key", "bbox")
        self.image_width_key = config.get("image_width_key", "image_width")
        self.image_height_key = config.get("image_height_key",
                                           "image_height")

    def __call__(self, item: Dict[str, Any]) -> Dict[str, Any]:
        bbox = np.asarray(item[self.bbox_key], np.float32)
        w = float(item[self.image_width_key])
        h = float(item[self.image_height_key])
        loc = np.zeros((bbox.shape[0], 5), np.float32)
        loc[:, :4] = bbox[:, :4]
        loc[:, 4] = ((loc[:, 3] - loc[:, 1]) * (loc[:, 2] - loc[:, 0])
                     / (w * h))
        loc[:, 0] /= w
        loc[:, 1] /= h
        loc[:, 2] /= w
        loc[:, 3] /= h
        out = dict(item)
        out["bbox"] = loc
        return out


# ---------------------------------------------------------------------------
# full processor registry (closing C29): vocab/embedding, soft-copy,
# caption, m4c decoding, image + prediction processors
# ---------------------------------------------------------------------------

class Vocab:
    """mmf/utils/vocab.py BaseVocab (:76-170): <pad>=0 <s>=1 </s>=2
    <unk>=3 then the vocab-file words; optional embedding ``vectors``.

    ``embedding_file`` (a word<space>floats text file or an .npz with
    ``words``/``vectors``) replaces torchtext's downloaded GloVe — this
    image has no egress, so embeddings load from local files only
    ("intersected" semantics: only vocab words keep their vectors)."""

    PAD_TOKEN, SOS_TOKEN, EOS_TOKEN, UNK_TOKEN = (
        "<pad>", "<s>", "</s>", "<unk>")
    PAD_INDEX, SOS_INDEX, EOS_INDEX, UNK_INDEX = 0, 1, 2, 3

    def __init__(self, vocab_file: Optional[str] = None,
                 words: Optional[Sequence[str]] = None,
                 embedding_file: Optional[str] = None,
                 embedding_dim: int = 300, **_ignored):
        if words is None:
            if vocab_file is None:
                raise AttributeError("vocab needs vocab_file or words")
            with open(vocab_file, encoding="utf-8") as f:
                words = [ln.strip() for ln in f if ln.strip()]
        specials = [self.PAD_TOKEN, self.SOS_TOKEN, self.EOS_TOKEN,
                    self.UNK_TOKEN]
        self.itos: List[str] = specials + [w for w in words
                                           if w not in specials]
        self.stoi: Dict[str, int] = {}
        for i, w in enumerate(self.itos):
            self.stoi.setdefault(w, i)
        self.word_dict = self.stoi
        self.vectors: Optional[np.ndarray] = None
        self._dim = embedding_dim
        if embedding_file is not None:
            table: Dict[str, np.ndarray] = {}
            if embedding_file.endswith(".npz"):
                z = np.load(embedding_file, allow_pickle=True)
                table = dict(zip([str(w) for w in z["words"]],
                                 z["vectors"]))
            else:
                with open(embedding_file, encoding="utf-8") as f:
                    for ln in f:
                        parts = ln.rstrip().split(" ")
                        if len(parts) > 2:
                            table[parts[0]] = np.asarray(parts[1:],
                                                         np.float32)
            if table:
                self._dim = len(next(iter(table.values())))
            self.vectors = np.zeros((len(self.itos), self._dim),
                                    np.float32)
            for i, w in enumerate(self.itos):
                if w in table:
                    self.vectors[i] = table[w]

    def get_itos(self):
        return self.itos

    def get_stoi(self):
        return self.stoi

    def get_size(self) -> int:
        return len(self.itos)

    def get_pad_index(self) -> int:
        return self.PAD_INDEX

    def get_unk_index(self) -> int:
        return self.UNK_INDEX

    def get_embedding_dim(self) -> int:
        return self._dim

    def word2idx(self, w: str) -> int:
        return self.stoi.get(w, self.UNK_INDEX)


class Processor:
    """processors.py:126-170: {'type': name, 'params': {...}} wrapper
    that resolves the processor from the registry."""

    def __init__(self, config: Dict[str, Any]):
        if "type" not in config:
            raise AttributeError(
                "Config must have 'type' attribute to specify type of "
                "processor")
        cls = registry.get("processor", config["type"])
        self.processor = cls(config.get("params", {}) or {})

    def __call__(self, item, *args, **kwargs):
        return self.processor(item, *args, **kwargs)

    def __getattr__(self, name):
        # guard via __dict__ like the MMF original (processors.py:166-
        # 170): during deepcopy/unpickle 'processor' may not exist yet,
        # and an unguarded lookup would recurse infinitely
        if "processor" in self.__dict__:
            return getattr(self.__dict__["processor"], name)
        raise AttributeError(name)


@registry.register_processor("vocab")
class VocabProcessor:
    """processors.py:200-346: words → padded index tensor."""

    MAX_LENGTH_DEFAULT = 50
    PAD_TOKEN = "<pad>"
    PAD_INDEX = 0

    def __init__(self, config: Dict[str, Any]):
        if "vocab" not in config:
            raise AttributeError(
                "config passed to the processor has no attribute vocab")
        self.vocab = Vocab(**config["vocab"])
        self._init_extras(config)

    def _init_extras(self, config: Dict[str, Any]):
        self.max_length = config.get("max_length",
                                     self.MAX_LENGTH_DEFAULT)
        self.preprocessor = (Processor(config["preprocessor"])
                             if "preprocessor" in config else None)

    def __call__(self, item: Dict[str, Any]) -> Dict[str, Any]:
        if not isinstance(item, dict):
            raise TypeError(
                "Argument passed to the processor must be a dict with "
                "either 'text' or 'tokens' as keys")
        if "tokens" in item:
            tokens = item["tokens"]
        elif "text" in item:
            assert self.preprocessor is not None, (
                "If tokens are not provided, a text processor must be "
                "defined in the config")
            tokens = self.preprocessor({"text": item["text"]})["text"]
        else:
            raise AssertionError(
                "A dict with either 'text' or 'tokens' keys must be "
                "passed to the processor")
        indices = self._map_strings_to_indices(tokens)
        tokens, length = self._pad_tokens(tokens)
        return {"text": indices, "tokens": tokens, "length": length}

    def _pad_tokens(self, tokens: Sequence[str]):
        padded = [self.PAD_TOKEN] * self.max_length
        n = min(len(tokens), self.max_length)
        padded[:n] = tokens[:n]
        return padded, np.int64(n)

    def get_pad_index(self) -> int:
        return self.vocab.get_pad_index()

    def get_vocab_size(self) -> int:
        return self.vocab.get_size()

    def _map_strings_to_indices(self, tokens: Sequence[str]) -> np.ndarray:
        tokens = tokens[:self.max_length]
        out = np.full((self.max_length,), self.vocab.get_pad_index(),
                      np.int64)
        for i, tok in enumerate(tokens):
            out[i] = self.vocab.stoi.get(tok, self.vocab.UNK_INDEX)
        return out


@registry.register_processor("glove")
class GloVeProcessor(VocabProcessor):
    """processors.py:349-397: indices → embedding vectors.  Vectors
    come from the Vocab's local embedding_file (no egress)."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        if self.vocab.vectors is None:
            raise AttributeError(
                "glove processor needs vocab.embedding_file (offline "
                "image: torchtext download path is unavailable)")

    def __call__(self, item: Dict[str, Any]) -> Dict[str, Any]:
        indices = super().__call__(item)["text"]
        return {"text": self.vocab.vectors[indices].copy()}


@registry.register_processor("fasttext")
class FastTextProcessor(VocabProcessor):
    """processors.py:400-526.  The reference memory-maps wiki.en.bin
    through the fasttext package; offline we take a precomputed
    word→vector table (same ``embedding_file`` formats as Vocab) and
    fall back to zeros for OOV — subword hashing is not replicated."""

    def __init__(self, config: Dict[str, Any]):
        self._init_extras(config)
        table_file = config.get("model_file") or config.get(
            "embedding_file")
        if table_file is None:
            raise AttributeError(
                "fasttext processor needs model_file/embedding_file "
                "(offline image: the wiki.en.bin download path is "
                "unavailable)")
        self._table: Dict[str, np.ndarray] = {}
        if table_file.endswith(".npz"):
            z = np.load(table_file, allow_pickle=True)
            self._table = dict(zip([str(w) for w in z["words"]],
                                   z["vectors"]))
        else:
            with open(table_file, encoding="utf-8") as f:
                for ln in f:
                    parts = ln.rstrip().split(" ")
                    if len(parts) > 2:
                        self._table[parts[0]] = np.asarray(parts[1:],
                                                           np.float32)
        self._dim = (len(next(iter(self._table.values())))
                     if self._table else 300)

    def _map_strings_to_indices(self, tokens: Sequence[str]) -> np.ndarray:
        tokens = tokens[:self.max_length]
        out = np.zeros((self.max_length, self._dim), np.float32)
        for i, tok in enumerate(tokens):
            if tok in self._table:
                out[i] = self._table[tok]
        return out


@registry.register_processor("soft_copy_answer")
class SoftCopyAnswerProcessor(VQAAnswerProcessor):
    """processors.py:729-820: appends a dynamic OCR-copy answer space
    of size max_length; copy slots score by the VQA formula on the
    OCR token string."""

    DEFAULT_MAX_LENGTH = 50

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        self.max_length = config.get("max_length",
                                     self.DEFAULT_MAX_LENGTH)
        cp = config.get("context_preprocessor")
        self.context_preprocessor = Processor(cp) if cp else None

    def get_vocab_size(self) -> int:
        return self.answer_vocab.num_vocab + self.max_length

    def get_true_vocab_size(self) -> int:
        return self.answer_vocab.num_vocab

    def __call__(self, item: Dict[str, Any]) -> Dict[str, Any]:
        out = super().__call__({k: item[k] for k in
                                ("answers", "answer_tokens") if k in item})
        # the base compute_answers_scores already sized the array with
        # the +max_length copy slots (it calls the overridden
        # get_vocab_size, processors.py:813-815) — fill, don't extend
        scores = out["answers_scores"]
        answers = out["answers"]
        tokens = list(item["tokens"])
        if self.context_preprocessor is not None:
            tokens = [self.context_preprocessor({"text": t})["text"]
                      for t in tokens]
        gt_answers = list(enumerate(answers))
        counts = {}
        for a in answers:
            counts[a] = counts.get(a, 0) + 1
        for idx, token in enumerate(tokens[:self.max_length]):
            if not counts.get(token):
                continue
            accs = []
            for gt_answer in gt_answers:
                others = [it for it in gt_answers if it != gt_answer]
                matching = [it for it in others if it[1] == token]
                accs.append(min(1.0, len(matching) / 3.0))
            scores[self.answer_vocab.num_vocab + idx] = (
                sum(accs) / len(accs))
        return {"answers": answers,
                "answers_indices": out["answers_indices"],
                "answers_scores": scores}


def build_bbox_tensors(infos: Sequence[Dict[str, Any]], max_length: int
                       ) -> Dict[str, Any]:
    """mmf/utils/dataset.py:8-40."""
    num = min(max_length, len(infos))
    coords = np.zeros((max_length, 4), np.float32)
    widths = np.zeros((max_length,), np.float32)
    heights = np.zeros((max_length,), np.float32)
    for idx, info in enumerate(infos[:num]):
        bb = info["bounding_box"]
        x = bb.get("top_left_x", bb.get("topLeftX"))
        y = bb.get("top_left_y", bb.get("topLeftY"))
        coords[idx] = [x, y, x + bb["width"], y + bb["height"]]
        widths[idx] = bb["width"]
        heights[idx] = bb["height"]
    return {"coordinates": coords, "width": widths, "height": heights,
            "bbox_types": ["xyxy"] * max_length}


@registry.register_processor("bbox")
class BBoxProcessor(VocabProcessor):
    """processors.py:859-908."""

    def __init__(self, config: Dict[str, Any]):
        self._init_extras(config)

    def __call__(self, item: Dict[str, Any]) -> Dict[str, Any]:
        info = item["info"]
        if self.preprocessor is not None:
            info = self.preprocessor(info)
        return {"bbox": build_bbox_tensors(info, self.max_length)}


@registry.register_processor("caption")
class CaptionProcessor:
    """processors.py:911-940: strip SOS/EOS/PAD, join to a string."""

    def __init__(self, config: Dict[str, Any]):
        if "vocab" not in config:
            raise AttributeError(
                "config passed to the processor has no attribute vocab")
        self.vocab = Vocab(**config["vocab"])

    def __call__(self, item: Sequence[int]) -> Dict[str, Any]:
        item = list(item)
        for idx, v in enumerate(item):
            if v == self.vocab.EOS_INDEX:
                item = item[:idx]
                break
        drop = {self.vocab.SOS_INDEX, self.vocab.EOS_INDEX,
                self.vocab.PAD_INDEX}
        tokens = [self.vocab.get_itos()[w] for w in item if w not in drop]
        return {"tokens": tokens, "caption": " ".join(tokens)}


# the EvalAI normalization protocol lives in utils.m4c_evaluators; the
# processors registry exposes it under the reference name
# (processors.py:943-1153)
from transformer_mm_explainability_tpu_torch.utils.m4c_evaluators import (  # noqa: E402
    EvalAIAnswerProcessor)

registry.register_processor("evalai_answer")(EvalAIAnswerProcessor)


# ``phoc`` (processors.py:1156-1181, 604-dim PHOC vectors through the
# native cphoc op) comes with the port of ``native/`` (ROADMAP A5d).


@registry.register_processor("copy")
class CopyProcessor:
    """processors.py:1184-1198: pad/truncate a blob to max_length."""

    def __init__(self, config: Dict[str, Any]):
        self.max_length = config["max_length"]

    def __call__(self, item: Dict[str, Any]) -> Dict[str, Any]:
        blob = np.asarray(item["blob"])
        out = np.zeros((self.max_length,) + blob.shape[1:], blob.dtype)
        out[:len(blob)] = blob[:self.max_length]
        return {"blob": out}


@registry.register_processor("m4c_answer")
class M4CAnswerProcessor:
    """processors.py:1201-1378: teacher-forcing targets for M4C
    iterative decoding — per-step soft scores over vocab+OCR copy
    space, sampled decoding sequence, loss mask."""

    def __init__(self, config: Dict[str, Any]):
        self.answer_vocab = VocabDict(
            vocab_file=config.get("vocab_file"),
            words=config.get("vocab"))
        self.PAD_IDX = self.answer_vocab.word2idx("<pad>")
        self.BOS_IDX = self.answer_vocab.word2idx("<s>")
        self.EOS_IDX = self.answer_vocab.word2idx("</s>")
        self.UNK_IDX = self.answer_vocab.UNK_INDEX
        assert self.PAD_IDX != self.UNK_IDX
        assert self.BOS_IDX != self.UNK_IDX
        assert self.EOS_IDX != self.UNK_IDX
        assert self.PAD_IDX == 0
        self.answer_preprocessor = Processor(config["preprocessor"])
        self.num_answers = config["num_answers"]
        self.max_length = config["max_length"]
        self.max_copy_steps = config["max_copy_steps"]
        assert self.max_copy_steps >= 1
        self.match_answer_to_unk = False
        self._rng = np.random.RandomState(config.get("seed", 0))

    def tokenize(self, sentence: str) -> List[str]:
        return sentence.split()

    def match_answer_to_vocab_ocr_seq(self, answer: str, vocab2idx: Dict,
                                      ocr2inds: Dict,
                                      max_match_num: int = 20):
        num_vocab = len(vocab2idx)
        matches_per_word = []
        for word in self.tokenize(answer):
            matched = []
            if word in vocab2idx:
                matched.append(vocab2idx[word])
            matched.extend(num_vocab + i for i in ocr2inds.get(word, ()))
            if not matched:
                if self.match_answer_to_unk:
                    matched.append(vocab2idx.get("<unk>"))
                else:
                    return []
            matches_per_word.append(matched)
        if not matches_per_word:
            return []
        seqs = [()]
        for matched in matches_per_word:
            seqs = [s + (i,) for s in seqs for i in matched]
            if len(seqs) > max_match_num:
                seqs = seqs[:max_match_num]
        return seqs

    def get_vocab_size(self) -> int:
        return self.answer_vocab.num_vocab + self.max_length

    def get_true_vocab_size(self) -> int:
        return self.answer_vocab.num_vocab

    def compute_answer_scores(self, answers: Sequence[str]):
        gt_answers = list(enumerate(answers))
        scores = {}
        for unique_answer in sorted(set(answers)):
            accs = []
            for gt_answer in gt_answers:
                others = [it for it in gt_answers if it != gt_answer]
                matching = [it for it in others if it[1] == unique_answer]
                accs.append(min(1.0, len(matching) / 3.0))
            scores[unique_answer] = sum(accs) / len(accs)
        return scores

    def __call__(self, item: Dict[str, Any]) -> Dict[str, Any]:
        answers = item["answers"]
        if not answers:
            return {"sampled_idx_seq": None,
                    "train_prev_inds": np.zeros((self.max_copy_steps,),
                                                np.int64)}
        answers = [self.answer_preprocessor({"text": a})["text"]
                   for a in answers]
        assert len(answers) == self.num_answers
        unique_answer2score = self.compute_answer_scores(answers)
        scores = np.zeros((self.max_copy_steps, self.get_vocab_size()),
                          np.float32)
        ocr2inds: Dict[str, List[int]] = {}
        for idx, token in enumerate(item["tokens"]):
            ocr2inds.setdefault(token, []).append(idx)
        answer_dec_inds = [self.match_answer_to_vocab_ocr_seq(
            a, self.answer_vocab.word2idx_dict, ocr2inds)
            for a in answers]
        all_idx_seq_list = []
        for answer, idx_seq_list in zip(answers, answer_dec_inds):
            all_idx_seq_list.extend(idx_seq_list)
            score = unique_answer2score[answer]
            for idx_seq in idx_seq_list:
                scores[0, idx_seq[0]] = max(scores[0, idx_seq[0]], score)
        train_prev_inds = np.zeros((self.max_copy_steps,), np.int64)
        train_loss_mask = np.zeros((self.max_copy_steps,), np.float32)
        if all_idx_seq_list:
            idx_seq = all_idx_seq_list[
                self._rng.choice(len(all_idx_seq_list))]
            dec_step_num = min(1 + len(idx_seq), self.max_copy_steps)
            train_loss_mask[:dec_step_num] = 1.0
            train_prev_inds[0] = self.BOS_IDX
            for t in range(1, dec_step_num):
                train_prev_inds[t] = idx_seq[t - 1]
                score_idx = (idx_seq[t] if t < len(idx_seq)
                             else self.EOS_IDX)
                scores[t, score_idx] = 1.0
        else:
            idx_seq = ()
        return {"answers": answers, "answers_scores": scores,
                "sampled_idx_seq": idx_seq,
                "train_prev_inds": train_prev_inds,
                "train_loss_mask": train_loss_mask}


@registry.register_processor("m4c_caption")
class M4CCaptionProcessor(M4CAnswerProcessor):
    """processors.py:1381-1405: caption variant — regex tokenizer,
    UNK-matched words allowed, flat 1.0 scores."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        self.match_answer_to_unk = True

    def tokenize(self, sentence: str) -> List[str]:
        sentence = sentence.lower()
        for ch in (",", "?", "."):
            sentence = sentence.replace(ch, "")
        sentence = sentence.replace("'s", " 's")
        return [t.strip() for t in SENTENCE_SPLIT_REGEX.split(sentence)
                if t.strip()]

    def compute_answer_scores(self, answers: Sequence[str]):
        return {a: 1.0 for a in answers}


@registry.register_processor("masked_region")
class MaskedRegionProcessor:
    """processors.py:1408-1434: zero regions w.p. mask_probability×
    mask_region_probability; labels 1 (masked) / -1 (ignore)."""

    def __init__(self, config: Dict[str, Any]):
        config = config or {}
        self.mask_prob = config.get("mask_probability", 0.15)
        self.mask_region_prob = config.get("mask_region_probability", 0.9)
        self._rng = np.random.RandomState(config.get("seed", 0))

    def __call__(self, item: np.ndarray) -> np.ndarray:
        item = np.asarray(item)
        labels = np.full((item.shape[0],), -1, np.int64)
        for i in range(item.shape[0]):
            prob = self._rng.random_sample()
            if prob < self.mask_prob:
                prob /= self.mask_prob
                if prob < self.mask_region_prob:
                    item[i] = 0
                labels[i] = 1
        return labels


@registry.register_processor("multi_class_from_file")
class MultiClassFromFile:
    """processors.py:1474-1495: label string → class index (UNK slot
    subtracted)."""

    def __init__(self, config: Dict[str, Any]):
        self.label_vocab = VocabDict(vocab_file=config.get("vocab_file"),
                                     words=config.get("vocab"))

    def __call__(self, item) -> Dict[str, Any]:
        label = item["label"] if isinstance(item, dict) else item
        class_index = self.label_vocab.word2idx(label) - 1
        assert class_index != -1, f"{label} is not present in vocab file"
        return {"class_index": np.int64(class_index)}


@registry.register_processor("multi_sentence_bert_tokenizer")
class MultiSentenceBertTokenizer(BertTokenizerProcessor):
    """bert_processors.py:176-208: tokenize each sentence separately,
    segment id = sentence index, concat when fusion == 'concat'."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        self.fusion_strategy = config.get("fusion", "concat")

    def __call__(self, item: Dict[str, Any]) -> Dict[str, Any]:
        texts = item["text"]
        if not isinstance(texts, list):
            texts = [texts]
        fields = ("input_ids", "input_mask", "segment_ids",
                  "lm_label_ids")
        processed = []
        for idx, text in enumerate(texts):
            out = super().__call__({"text": text})
            out["segment_ids"] = np.full_like(out["segment_ids"], idx)
            processed.append(out)
        stacked = {k: np.stack([p[k] for p in processed])
                   for k in fields}
        if self.fusion_strategy == "concat":
            stacked = {k: v.reshape(-1) for k, v in stacked.items()}
        stacked["tokens"] = [p["tokens"] for p in processed]
        stacked["text"] = stacked["tokens"]
        return stacked


# --- image processors (image_processors.py) -------------------------------

@registry.register_processor("GrayScaleTo3Channels")
class GrayScaleTo3Channels:
    """image_processors.py:67-84: tile 1-channel CHW to 3 channels."""

    def __init__(self, config: Optional[Dict] = None):
        pass

    def __call__(self, x):
        if isinstance(x, dict):
            return {"image": self.transform(x["image"])}
        return self.transform(x)

    @staticmethod
    def transform(x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        if x.shape[0] == 1:
            x = np.concatenate([x] * 3, axis=0)
        return x


@registry.register_processor("torchvision_transforms")
class TorchvisionTransforms:
    """image_processors.py:12-64 without torchvision: the transform
    names used by MMF configs (Resize/CenterCrop/ToTensor/Normalize)
    are implemented on numpy CHW arrays, the resize and crop through the
    port's ``ops/image`` on CPU tensors; unknown names fall back to
    registered processors."""

    def __init__(self, config: Dict[str, Any]):
        import torch

        from transformer_mm_explainability_tpu_torch.ops import image as I

        specs = config["transforms"]
        if isinstance(specs, dict):
            specs = [specs]
        self._fns = []
        for spec in specs:
            if isinstance(spec, str):
                name, params = spec, {}
            else:
                name = spec["type"]
                params = spec.get("params", {}) or {}

            if name == "Resize":
                size = params.get("size", params.get("0", 224))

                def fn(x, size=size):
                    hwc = torch.from_numpy(
                        np.ascontiguousarray(np.moveaxis(x, 0, -1)))
                    if isinstance(size, int):
                        out = I.resize_shortest_edge(hwc, size)
                    else:
                        out = I.resize(hwc, tuple(size))
                    return np.moveaxis(out.numpy(), -1, 0)
            elif name == "CenterCrop":
                size = params.get("size", 224)

                def fn(x, size=size):
                    hwc = torch.from_numpy(
                        np.ascontiguousarray(np.moveaxis(x, 0, -1)))
                    return np.moveaxis(I.center_crop(hwc, size).numpy(),
                                       -1, 0)
            elif name == "ToTensor":
                def fn(x):
                    # dtype-keyed like torchvision: integers rescale
                    x = np.asarray(x)
                    if np.issubdtype(x.dtype, np.integer):
                        x = x.astype(np.float32) / 255.0
                    return x.astype(np.float32)
            elif name == "Normalize":
                mean = np.asarray(params["mean"],
                                  np.float32)[:, None, None]
                std = np.asarray(params["std"], np.float32)[:, None, None]

                def fn(x, mean=mean, std=std):
                    return (np.asarray(x, np.float32) - mean) / std
            else:
                proc = registry.get("processor", name)(params)

                def fn(x, proc=proc):
                    return proc(x)
            self._fns.append(fn)

    def __call__(self, x):
        if isinstance(x, dict):
            y = x["image"]
            for fn in self._fns:
                y = fn(y)
            return {"image": y}
        for fn in self._fns:
            x = fn(x)
        return x


@registry.register_processor("prediction.argmax")
class ArgMaxPredictionProcessor:
    """prediction_processors.py:20-38: report {scores, id} → list of
    {id, answer} dicts."""

    def __init__(self, config: Optional[Dict] = None):
        config = config or {}
        self._id_key = config.get("id_key", "id")
        self._result_key = config.get("result_key", "answer")

    def __call__(self, report: Dict[str, Any]) -> List[Dict[str, Any]]:
        answers = np.asarray(report["scores"]).argmax(axis=1)
        return [{self._id_key: int(item_id),
                 self._result_key: int(answers[idx])}
                for idx, item_id in enumerate(report["id"])]
