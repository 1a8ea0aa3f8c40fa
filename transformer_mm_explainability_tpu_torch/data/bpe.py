"""CLIP byte-pair-encoding tokenizer (the vocab contract of
CLIP/clip/simple_tokenizer.py + clip.tokenize).

A private copy of ``transformer_mm_explainability_tpu/data/bpe.py``
(importing that module would load the JAX package), reading the port's own
copy of the public ``bpe_simple_vocab_16e6.txt.gz`` merges table
(``data/assets``, package data). Text is lower-cased,
whitespace-collapsed, split with the CLIP word pattern, byte-encoded,
then merged greedily by rank; sequences are wrapped in
<start_of_text>/<end_of_text> and padded to the 77-token context
(clip.py:166-195). ftfy is unavailable in this image; the basic-clean
step degrades to html unescaping (texts in the benchmarks are ASCII
prompts, where the two agree).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

try:
    import regex as _re
except ImportError:  # pragma: no cover
    import re as _re

VOCAB_PATH = os.path.join(os.path.dirname(__file__), "assets",
                          "bpe_simple_vocab_16e6.txt.gz")

_WORD_PATTERN = (
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
)
# ``re`` has no \p{...} classes: letters are [^\W\d_] and numbers \d
# there (the same pieces for every ASCII text)
_WORD_PATTERN_RE = (
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[^\W\d_]+|\d|(?:[^\s\w]|_)+"""
)


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 reversible byte→unicode mapping (printable chars for all
    256 byte values)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return _re.sub(r"\s+", " ", text).strip()


class ClipTokenizer:
    """BPE tokenizer with the OpenAI-CLIP vocab (49,408 tokens)."""

    def __init__(self, vocab_path: str = VOCAB_PATH):
        merges_raw = gzip.open(vocab_path, "rt", encoding="utf-8") \
            .read().split("\n")
        merges = [tuple(m.split()) for m in merges_raw[1:49152 - 256 - 2 + 1]]
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab: List[str] = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.pat = _re.compile(
            _WORD_PATTERN if _re.__name__ == "regex" else _WORD_PATTERN_RE,
            _re.IGNORECASE)
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}

    @property
    def sot(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eot(self) -> int:
        return self.encoder["<|endoftext|>"]

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for piece in self.pat.findall(text):
            piece = "".join(self.byte_encoder[b]
                            for b in piece.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self._bpe(piece).split(" "))
        return tokens

    def decode(self, token_ids: Sequence[int]) -> str:
        text = "".join(self.decoder[t] for t in token_ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


_default: ClipTokenizer | None = None


def tokenize(texts, context_length: int = 77,
             truncate: bool = False) -> np.ndarray:
    """clip.tokenize equivalent: [B, context_length] int32 with
    SOT ... EOT and zero padding (clip.py:166-195)."""
    global _default
    if _default is None:
        _default = ClipTokenizer()
    if isinstance(texts, str):
        texts = [texts]
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [_default.sot] + _default.encode(text) + [_default.eot]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length "
                    f"{context_length}")
            ids = ids[:context_length]
            ids[-1] = _default.eot
        out[i, :len(ids)] = ids
    return out
