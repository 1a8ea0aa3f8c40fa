"""Vocabulary extraction from question/dialog corpora (C29 tooling).

The port's copy of
``transformer_mm_explainability_tpu/tools/extract_vocab.py`` (host
code, the same outputs; importing the JAX module would load the JAX
package).

Re-design of ``VisualBERT/tools/scripts/gqa/extract_vocabulary.py``
(and its visual_dialog sibling): tokenize every text with the MMF
tokenizer (``data/processors.tokenize`` — lowercase, strip ``,``/``?``,
split ``'s``), keep words whose count reaches ``min_freq``, sort
alphabetically, write one word per line.  The UNK token is added on
the fly by the vocab processors, exactly as the reference notes
(extract_vocabulary.py:38-40).
"""

from __future__ import annotations

import argparse
import json
import os
from collections import Counter
from typing import Iterable, List, Optional, Tuple

from transformer_mm_explainability_tpu_torch.data.processors import tokenize


def extract_vocabulary(texts: Iterable[str],
                       min_freq: int = 0) -> Tuple[List[str], List[int]]:
    """extract_vocabulary.py:25-44: (sorted vocabulary, text lengths)."""
    word_count: Counter = Counter()
    text_lengths: List[int] = []
    for text in texts:
        words = tokenize(text)
        text_lengths.append(len(words))
        word_count.update(words)
    vocabulary = sorted(
        w for w, c in word_count.items() if c >= min_freq)
    return vocabulary, text_lengths


def texts_from_question_files(input_files: Iterable[str]) -> List[str]:
    """extract_vocabulary.py:52-63: VQA/GQA question jsons — the
    ``questions`` list, either raw strings or ``{"question": ...}``
    dicts."""
    texts: List[str] = []
    for input_file in input_files:
        with open(input_file) as f:
            entries = json.load(f)["questions"]
        for q in entries:
            texts.append(q["question"] if isinstance(q, dict) else q)
    return texts


def save_vocabulary(vocabulary: List[str], out_dir: str,
                    vocab_file_name: str = "vocabulary.txt") -> str:
    os.makedirs(out_dir, exist_ok=True)
    vocab_file = os.path.join(out_dir, vocab_file_name)
    with open(vocab_file, "w") as f:
        f.writelines(w + "\n" for w in vocabulary)
    return vocab_file


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input_files", nargs="+", required=True)
    parser.add_argument("--out_dir", type=str, default="./")
    parser.add_argument("--min_freq", type=int, default=0)
    parser.add_argument("--vocab_file_name", type=str,
                        default="vocabulary.txt")
    args = parser.parse_args(argv)
    texts = texts_from_question_files(args.input_files)
    vocabulary, lengths = extract_vocabulary(texts, args.min_freq)
    save_vocabulary(vocabulary, args.out_dir, args.vocab_file_name)
    print("min text len=", min(lengths))
    print("max text len=", max(lengths))


if __name__ == "__main__":
    main()
