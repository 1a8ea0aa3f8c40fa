"""Text utilities: ngrams, corpus vocab, caption decoders (C28/C34).

The port's copy of ``transformer_mm_explainability_tpu/data/text_utils.py``
(numpy): importing that module would load the JAX package.

Re-design of ``VisualBERT/mmf/utils/text.py``: ``generate_ngrams``
(:31-44), ``generate_ngrams_range`` (:46-61), ``VocabFromText``
(:178-216), and the caption decoding strategies ``TextDecoder``
(:219-269), ``BeamSearch`` (:272-384, registered "beam_search"),
``NucleusSampling`` (:387-467, registered "nucleus_sampling").

The decoders run on the host — beam bookkeeping is tiny numpy
state; the model step runs once per decoding step on whatever beams
remain. Randomness (nucleus) uses an explicit RandomState.
``butd_decode``, which drives the BUTD model of ``models/mmf_zoo``, comes
with the MMF models (ROADMAP A5c).
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from transformer_mm_explainability_tpu_torch.core.registry import registry
from transformer_mm_explainability_tpu_torch.data.processors import (
    Vocab, tokenize)


def _tree_map(fn: Callable, tree):
    """``fn`` on every leaf of nested dicts, tuples and lists (the
    decoders' state)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)

def generate_ngrams(tokens: List[str], n: int = 1) -> List[str]:
    """text.py:31-44."""
    shifted = [tokens[i:] for i in range(n)]
    return [" ".join(g) for g in zip(*shifted)]


def generate_ngrams_range(tokens: List[str],
                          ngram_range: Tuple[int, int] = (1, 3)
                          ) -> List[str]:
    """text.py:46-61 (range is inclusive-exclusive like the
    reference's ``range(*ngram_range)``)."""
    assert len(ngram_range) == 2, (
        "'ngram_range' should be a tuple of two elements which is range "
        "of numbers")
    out: List[str] = []
    for n in range(*ngram_range):
        out.extend(generate_ngrams(tokens, n))
    return out


class VocabFromText(Vocab):
    """text.py:178-216: vocabulary counted from sentences with a
    min_count threshold.  Token order matches the reference's
    DEFAULT_TOKENS = [<pad>, <unk>, <s>, </s>] prefix."""

    def __init__(self, sentences: Iterable[str], min_count: int = 1,
                 keep=(), remove=(), only_unk_extra: bool = False):
        counter: Counter = Counter()
        for sentence in sentences:
            counter.update(tokenize(sentence, keep=keep, remove=remove))
        token_list = [t for t in counter if counter[t] >= min_count]
        extras = ([self.UNK_TOKEN] if only_unk_extra else
                  [self.PAD_TOKEN, self.UNK_TOKEN, self.SOS_TOKEN,
                   self.EOS_TOKEN])
        self.itos = extras + token_list
        self.stoi = {w: i for i, w in enumerate(self.itos)}
        self.word_dict = self.stoi
        self.vectors = None
        self._dim = 300
        # index constants follow the actual layout (the reference's
        # _build re-derives them the same way)
        self.PAD_INDEX = self.stoi.get(self.PAD_TOKEN, 0)
        self.UNK_INDEX = self.stoi.get(self.UNK_TOKEN, 0)
        self.SOS_INDEX = self.stoi.get(self.SOS_TOKEN, -1)
        self.EOS_INDEX = self.stoi.get(self.EOS_TOKEN, -1)


class TextDecoder:
    """text.py:219-269: shared bookkeeping for decoding strategies.
    ``data`` dicts carry {"texts": [k, 1] next tokens, "state": model
    recurrent state pytree indexed along the beam axis}."""

    def __init__(self, vocab):
        self._vocab = vocab
        self._vocab_size = vocab.get_size()
        self._complete_seqs: List[Any] = []
        self._complete_seqs_scores: List[Any] = []

    def init_batch(self, image_features: np.ndarray) -> np.ndarray:
        """Expand [B, N, D] features beam-wise → [B*k, N, D]; seed the
        seqs with SOS (text.py:236-249)."""
        self._batch_size = image_features.shape[0]
        k = self._decode_size
        self.seqs = np.full((self._batch_size * k, 1),
                            self._vocab.SOS_INDEX, np.int64)
        return np.repeat(image_features, k, axis=0)

    def add_next_word(self, seqs, prev_word_inds, next_word_inds):
        return np.concatenate(
            [seqs[prev_word_inds], next_word_inds[:, None]], axis=1)

    def find_complete_inds(self, next_word_inds):
        incomplete = [i for i, w in enumerate(next_word_inds)
                      if w != self._vocab.EOS_INDEX]
        complete = sorted(set(range(len(next_word_inds)))
                          - set(incomplete))
        return complete, incomplete

    def update_data(self, data, prev_word_inds, next_word_inds,
                    incomplete_inds):
        """Re-index texts + every state leaf to the surviving beams
        (text.py:262-269 generalized to any state pytree)."""
        sel = prev_word_inds[incomplete_inds]
        data["texts"] = next_word_inds[incomplete_inds][:, None]
        data["state"] = _tree_map(lambda leaf: np.asarray(leaf)[sel],
                                  data["state"])
        return data


@registry.register_decoder("beam_search")
class BeamSearch(TextDecoder):
    """text.py:272-384: per-example shrinking beams; completed
    sequences pool per example; best-scoring sequence wins."""

    def __init__(self, vocab, beam_length: int = 5):
        super().__init__(vocab)
        self._decode_size = beam_length

    def init_batch(self, image_features: np.ndarray) -> np.ndarray:
        out = super().init_batch(image_features)
        k = self._decode_size
        self.top_k_scores = np.zeros(
            (self._batch_size * k, 1), np.float32)
        self._decode_sizes = [k] * self._batch_size
        self._complete_seqs = [[] for _ in range(self._batch_size)]
        self._complete_seqs_scores = [[] for _ in range(self._batch_size)]
        return out

    def decode(self, t: int, data: Dict[str, Any], scores: np.ndarray
               ) -> Tuple[bool, Dict[str, Any], int]:
        scores = np.asarray(scores, np.float32)
        logp = scores - _logsumexp(scores)
        logp = self.top_k_scores + logp

        top_k_scores, top_k_words = [], []
        ex_start = 0
        for decode_size in self._decode_sizes:
            ex_end = ex_start + decode_size
            if t == 0:
                flat = logp[ex_start]
            else:
                flat = logp[ex_start:ex_end].reshape(-1)
            idx = np.argsort(-flat)[:decode_size]
            top_k_scores.extend(flat[idx])
            top_k_words.append(idx)
            ex_start = ex_end
        self.top_k_scores = np.asarray(top_k_scores, np.float32)

        ex_start = 0
        prev_word_inds, next_word_inds = [], []
        for ex_idx, decode_size in enumerate(self._decode_sizes):
            prev_word_inds.extend(
                top_k_words[ex_idx] // self._vocab_size + ex_start)
            next_word_inds.extend(top_k_words[ex_idx] % self._vocab_size)
            ex_start += decode_size
        prev_word_inds = np.asarray(prev_word_inds)
        next_word_inds = np.asarray(next_word_inds)

        self.seqs = self.add_next_word(self.seqs, prev_word_inds,
                                       next_word_inds)
        complete_inds, incomplete_inds = self.find_complete_inds(
            next_word_inds)

        ex_start = 0
        for ex_idx, decode_size in enumerate(list(self._decode_sizes)):
            for beam_idx in range(ex_start, ex_start + decode_size):
                if beam_idx in complete_inds:
                    self._complete_seqs[ex_idx].append(
                        self.seqs[beam_idx].tolist())
                    self._complete_seqs_scores[ex_idx].append(
                        float(self.top_k_scores[beam_idx]))
                    self._decode_sizes[ex_idx] -= 1
            ex_start += decode_size

        if sum(self._decode_sizes) == 0:
            return True, data, 0
        self.seqs = self.seqs[incomplete_inds]
        self.top_k_scores = self.top_k_scores[incomplete_inds][:, None]
        self.last_incomplete = np.asarray(incomplete_inds)
        data = self.update_data(data, prev_word_inds, next_word_inds,
                                incomplete_inds)
        return False, data, len(incomplete_inds)

    def get_result(self) -> np.ndarray:
        """text.py:369-384 (5-pad fallback for empty pools)."""
        captions: List[List[int]] = []
        max_len = 0
        for ex_idx in range(len(self._complete_seqs_scores)):
            if not self._complete_seqs_scores[ex_idx]:
                captions.append([0] * 5)
                max_len = max(5, max_len)
            else:
                best = int(np.argmax(self._complete_seqs_scores[ex_idx]))
                captions.append(list(self._complete_seqs[ex_idx][best]))
                max_len = max(max_len, len(captions[-1]))
        for cap in captions:
            cap.extend([self._vocab.PAD_INDEX] * (max_len - len(cap)))
        return np.asarray(captions, np.float32)


@registry.register_decoder("nucleus_sampling")
class NucleusSampling(TextDecoder):
    """text.py:387-467: sample the next token from the smallest
    top-probability set whose mass exceeds sum_threshold."""

    def __init__(self, vocab, sum_threshold: float = 0.9,
                 rng: Optional[np.random.RandomState] = None):
        super().__init__(vocab)
        self._decode_size = 1
        self._threshold = sum_threshold
        self.rng = rng or np.random.RandomState(0)

    def decode(self, t: int, data: Dict[str, Any], scores: np.ndarray
               ) -> Tuple[bool, Dict[str, Any], int]:
        scores = np.asarray(scores, np.float64)
        probs = np.exp(scores - scores.max())
        probs = (probs / probs.sum(axis=-1, keepdims=True)).reshape(-1)
        order = np.argsort(-probs)
        csum = np.cumsum(probs[order])
        last = int(np.searchsorted(csum, self._threshold) + 1)
        top_words = order[:last]
        top_probs = probs[top_words] / probs[top_words].sum()

        prev_word_ind = np.asarray([0])
        next_word_ind = np.asarray(
            [top_words[self.rng.choice(len(top_words), p=top_probs)]])
        self.seqs = self.add_next_word(self.seqs, prev_word_ind,
                                       next_word_ind)
        complete_inds, incomplete_inds = self.find_complete_inds(
            next_word_ind)
        if complete_inds:
            self._complete_seqs.extend(
                self.seqs[complete_inds].tolist())
            return True, data, 0
        self.seqs = self.seqs[incomplete_inds]
        data = self.update_data(data, prev_word_ind, next_word_ind,
                                incomplete_inds)
        return False, data, 1

    def get_result(self) -> np.ndarray:
        if not self._complete_seqs:
            return np.asarray([[0.0] * 5], np.float32)
        return np.asarray([self._complete_seqs[0]], np.float32)


def _logsumexp(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=-1, keepdims=True))
