"""BERT WordPiece tokenizer (numpy only, no network).

A private copy of ``transformer_mm_explainability_tpu/data/tokenization.py``
(importing that module would load the JAX package). The uncased
BasicTokenizer + greedy longest-match WordPiece pipeline of the reference's
HF tokenizers; pass a ``vocab.txt`` (``bert-base-uncased`` layout: one
token per line, ``##`` continuation prefix) or a vocab dict.
``encode_vqa`` gives the MMF question encoding: [CLS] tokens [SEP], padded,
with an input mask.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, List, Optional

import numpy as np


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str, lower: bool = True) -> List[str]:
    """Whitespace + punctuation splitting with accent stripping."""
    if lower:
        text = text.lower()
    text = unicodedata.normalize("NFD", text)
    out: List[str] = []
    word: List[str] = []
    for ch in text:
        if unicodedata.category(ch) == "Mn":
            continue  # strip accents
        if ch.isspace():
            if word:
                out.append("".join(word))
                word = []
        elif _is_punct(ch):
            if word:
                out.append("".join(word))
                word = []
            out.append(ch)
        else:
            word.append(ch)
    if word:
        out.append("".join(word))
    return out


class BertTokenizer:
    def __init__(self, vocab_path: Optional[str] = None,
                 vocab: Optional[Dict[str, int]] = None,
                 lower: bool = True):
        if vocab is not None:
            self.vocab = dict(vocab)
        elif vocab_path and os.path.exists(vocab_path):
            with open(vocab_path, encoding="utf-8") as f:
                self.vocab = {line.rstrip("\n"): i
                              for i, line in enumerate(f)}
        else:
            raise FileNotFoundError(
                "BertTokenizer needs a vocab.txt (bert-base-uncased "
                "layout) or an explicit vocab dict — none found at "
                f"{vocab_path!r}")
        self.inv = {i: t for t, i in self.vocab.items()}
        self.lower = lower
        self.unk = self.vocab.get("[UNK]", 0)
        self.cls = self.vocab.get("[CLS]", 101)
        self.sep = self.vocab.get("[SEP]", 102)
        self.pad = self.vocab.get("[PAD]", 0)

    def wordpiece(self, word: str, max_chars: int = 200) -> List[int]:
        if len(word) > max_chars:
            return [self.unk]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            ids.append(cur)
            start = end
        return ids

    def tokenize_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        for w in basic_tokenize(text, self.lower):
            ids.extend(self.wordpiece(w))
        return ids

    def encode_vqa(self, question: str, max_len: int = 128
                   ) -> Dict[str, np.ndarray]:
        """[CLS] q [SEP] + padding (MMF bert_tokenizer processor)."""
        ids = [self.cls] + self.tokenize_ids(question)[:max_len - 2] \
            + [self.sep]
        out = np.full((max_len,), self.pad, np.int32)
        mask = np.zeros((max_len,), np.int32)
        out[:len(ids)] = ids
        mask[:len(ids)] = 1
        return {"input_ids": out, "input_mask": mask,
                "segment_ids": np.zeros((max_len,), np.int32)}

    def decode(self, ids) -> str:
        toks = [self.inv.get(int(i), "[UNK]") for i in ids]
        text = " ".join(toks).replace(" ##", "")
        return text
