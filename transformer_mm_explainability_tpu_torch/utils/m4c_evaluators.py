"""TextVQA/ST-VQA/TextCaps answer evaluators (C28 metrics backends).

The port's copy of
``transformer_mm_explainability_tpu/utils/m4c_evaluators.py`` (pure
Python): importing that module would load the JAX package.

Re-design of ``VisualBERT/mmf/utils/m4c_evaluators.py``: the EvalAI
answer-normalization protocol (``EvalAIAnswerProcessor``:5-216) and the
four pred-list evaluators (TextVQA soft accuracy:219-255, STVQA exact
accuracy:258-271, STVQA ANLS:274-296, TextCaps BLEU-4:299-332).

All host-side pure Python — these consume decoded answer strings, not
tensors.  Differences from the reference, both forced by the image:
``editdistance`` is replaced by an in-module Levenshtein (identical
values), and TextCaps' Java PTBTokenizer + pycocoevalcap Bleu are
replaced by whitespace tokenization + an uncased corpus BLEU-4 with
pycocoevalcap's closest-reference brevity penalty (documented;
equivalent on pre-tokenized text).

The CONTRACTIONS / NUMBER_MAP / punctuation tables are the published
VQA-v2 EvalAI protocol constants (m4c_evaluators.py:12-174) — they are
part of the metric's definition, not code.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict, List, Sequence

_CONTRACTION_PAIRS = (
    "aint ain't|arent aren't|cant can't|couldve could've|couldnt couldn't|"
    "couldn'tve couldn't've|couldnt've couldn't've|didnt didn't|"
    "doesnt doesn't|dont don't|hadnt hadn't|hadnt've hadn't've|"
    "hadn'tve hadn't've|hasnt hasn't|havent haven't|hed he'd|"
    "hed've he'd've|he'dve he'd've|hes he's|howd how'd|howll how'll|"
    "hows how's|Id've I'd've|I'dve I'd've|Im I'm|Ive I've|isnt isn't|"
    "itd it'd|itd've it'd've|it'dve it'd've|itll it'll|let's let's|"
    "maam ma'am|mightnt mightn't|mightnt've mightn't've|"
    "mightn'tve mightn't've|mightve might've|mustnt mustn't|"
    "mustve must've|neednt needn't|notve not've|oclock o'clock|"
    "oughtnt oughtn't|ow's'at 'ow's'at|'ows'at 'ow's'at|'ow'sat 'ow's'at|"
    "shant shan't|shed've she'd've|she'dve she'd've|she's she's|"
    "shouldve should've|shouldnt shouldn't|shouldnt've shouldn't've|"
    "shouldn'tve shouldn't've|somebody'd somebodyd|"
    "somebodyd've somebody'd've|somebody'dve somebody'd've|"
    "somebodyll somebody'll|somebodys somebody's|someoned someone'd|"
    "someoned've someone'd've|someone'dve someone'd've|"
    "someonell someone'll|someones someone's|somethingd something'd|"
    "somethingd've something'd've|something'dve something'd've|"
    "somethingll something'll|thats that's|thered there'd|"
    "thered've there'd've|there'dve there'd've|therere there're|"
    "theres there's|theyd they'd|theyd've they'd've|they'dve they'd've|"
    "theyll they'll|theyre they're|theyve they've|twas 'twas|"
    "wasnt wasn't|wed've we'd've|we'dve we'd've|weve we've|"
    "werent weren't|whatll what'll|whatre what're|whats what's|"
    "whatve what've|whens when's|whered where'd|wheres where's|"
    "whereve where've|whod who'd|whod've who'd've|who'dve who'd've|"
    "wholl who'll|whos who's|whove who've|whyll why'll|whyre why're|"
    "whys why's|wont won't|wouldve would've|wouldnt wouldn't|"
    "wouldnt've wouldn't've|wouldn'tve wouldn't've|yall y'all|"
    "yall'll y'all'll|y'allll y'all'll|yall'd've y'all'd've|"
    "y'alld've y'all'd've|y'all'dve y'all'd've|youd you'd|"
    "youd've you'd've|you'dve you'd've|youll you'll|youre you're|"
    "youve you've"
)


class EvalAIAnswerProcessor:
    """EvalAI answer normalization (m4c_evaluators.py:5-216)."""

    CONTRACTIONS: Dict[str, str] = dict(
        pair.split(" ", 1) for pair in _CONTRACTION_PAIRS.split("|"))
    NUMBER_MAP = {"none": "0", "zero": "0", "one": "1", "two": "2",
                  "three": "3", "four": "4", "five": "5", "six": "6",
                  "seven": "7", "eight": "8", "nine": "9", "ten": "10"}
    ARTICLES = ("a", "an", "the")
    PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
    COMMA_STRIP = re.compile(r"(?<=\d)(\,)+(?=\d)")
    PUNCTUATIONS = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=",
                    "+", "\\", "_", "-", ">", "<", "@", "`", ",", "?", "!"]

    def word_tokenize(self, word: str) -> str:
        word = word.lower()
        word = word.replace(",", "").replace("?", "").replace("'s", " 's")
        return word.strip()

    def process_punctuation(self, in_text: str) -> str:
        out_text = in_text
        for p in self.PUNCTUATIONS:
            if ((p + " " in in_text or " " + p in in_text)
                    or re.search(self.COMMA_STRIP, in_text) is not None):
                out_text = out_text.replace(p, "")
            else:
                out_text = out_text.replace(p, " ")
        return self.PERIOD_STRIP.sub("", out_text)

    def process_digit_article(self, in_text: str) -> str:
        out_text = []
        for word in in_text.lower().split():
            word = self.NUMBER_MAP.get(word, word)
            if word not in self.ARTICLES:
                out_text.append(word)
        for i, word in enumerate(out_text):
            if word in self.CONTRACTIONS:
                out_text[i] = self.CONTRACTIONS[word]
        return " ".join(out_text)

    def __call__(self, item: str) -> str:
        item = self.word_tokenize(item)
        item = item.replace("\n", " ").replace("\t", " ").strip()
        item = self.process_punctuation(item)
        item = self.process_digit_article(item)
        return item


def levenshtein(s1: str, s2: str) -> int:
    """Edit distance (replaces the reference's ``editdistance.eval``)."""
    if len(s1) < len(s2):
        s1, s2 = s2, s1
    prev = list(range(len(s2) + 1))
    for i, c1 in enumerate(s1):
        cur = [i + 1]
        for j, c2 in enumerate(s2):
            cur.append(min(prev[j + 1] + 1, cur[j] + 1,
                           prev[j] + (c1 != c2)))
        prev = cur
    return prev[-1]


class TextVQAAccuracyEvaluator:
    """Soft VQA accuracy over 10 human answers
    (m4c_evaluators.py:219-255)."""

    def __init__(self):
        self.answer_processor = EvalAIAnswerProcessor()

    def _compute_answer_scores(self, raw_answers: Sequence[str]
                               ) -> Dict[str, float]:
        answers = [self.answer_processor(a) for a in raw_answers]
        assert len(answers) == 10
        gt_answers = list(enumerate(answers))
        scores: Dict[str, float] = {}
        for unique_answer in set(answers):
            accs = []
            for gt_answer in gt_answers:
                others = [item for item in gt_answers if item != gt_answer]
                matching = [item for item in others
                            if item[1] == unique_answer]
                accs.append(min(1.0, len(matching) / 3.0))
            scores[unique_answer] = sum(accs) / len(accs)
        return scores

    def eval_pred_list(self, pred_list: List[dict]) -> float:
        pred_scores = []
        for entry in pred_list:
            pred_answer = self.answer_processor(entry["pred_answer"])
            unique = self._compute_answer_scores(entry["gt_answers"])
            pred_scores.append(unique.get(pred_answer, 0.0))
        return sum(pred_scores) / len(pred_scores)


class STVQAAccuracyEvaluator:
    """Exact-match accuracy (m4c_evaluators.py:258-271)."""

    def __init__(self):
        self.answer_processor = EvalAIAnswerProcessor()

    def eval_pred_list(self, pred_list: List[dict]) -> float:
        pred_scores = []
        for entry in pred_list:
            pred_answer = self.answer_processor(entry["pred_answer"])
            gts = [self.answer_processor(a) for a in entry["gt_answers"]]
            pred_scores.append(1.0 if pred_answer in gts else 0.0)
        return sum(pred_scores) / len(pred_scores)


class STVQAANLSEvaluator:
    """Average Normalized Levenshtein Similarity
    (m4c_evaluators.py:274-296)."""

    def get_anls(self, s1: str, s2: str) -> float:
        s1, s2 = s1.lower().strip(), s2.lower().strip()
        iou = 1.0 - levenshtein(s1, s2) / max(len(s1), len(s2))
        return iou if iou >= 0.5 else 0.0

    def eval_pred_list(self, pred_list: List[dict]) -> float:
        pred_scores = [max(self.get_anls(entry["pred_answer"], gt)
                           for gt in entry["gt_answers"])
                       for entry in pred_list]
        return sum(pred_scores) / len(pred_scores)


def corpus_bleu4(references: List[List[List[str]]],
                 hypotheses: List[List[str]]) -> float:
    """Corpus BLEU-4: uniform 4-gram weights, corpus-pooled clipped
    counts, closest-reference-length brevity penalty — the
    pycocoevalcap ``Bleu(4)`` definition the reference's TextCaps
    evaluator calls (m4c_evaluators.py:316-332)."""
    clipped = [0] * 4
    totals = [0] * 4
    hyp_len = 0
    ref_len = 0
    for refs, hyp in zip(references, hypotheses):
        hyp_len += len(hyp)
        ref_len += min((abs(len(r) - len(hyp)), len(r)) for r in refs)[1]
        for n in range(1, 5):
            hyp_ngrams = Counter(tuple(hyp[i:i + n])
                                 for i in range(len(hyp) - n + 1))
            max_ref: Counter = Counter()
            for r in refs:
                ref_ngrams = Counter(tuple(r[i:i + n])
                                     for i in range(len(r) - n + 1))
                for g, c in ref_ngrams.items():
                    max_ref[g] = max(max_ref[g], c)
            totals[n - 1] += max(sum(hyp_ngrams.values()), 0)
            clipped[n - 1] += sum(min(c, max_ref[g])
                                  for g, c in hyp_ngrams.items())
    # pycocoevalcap adds a tiny epsilon so a single zero n-gram count
    # doesn't zero the whole corpus score
    precisions = [(clipped[i] + 1e-9) / max(totals[i], 1) for i in range(4)]
    if min(precisions) <= 0:
        return 0.0
    geo = math.exp(sum(math.log(p) for p in precisions) / 4.0)
    bp = 1.0 if hyp_len > ref_len else math.exp(1.0 - ref_len /
                                                max(hyp_len, 1))
    return bp * geo


class TextCapsBleu4Evaluator:
    """BLEU-4 over generated captions (m4c_evaluators.py:299-332).
    Whitespace tokenization on lowercased strings stands in for the
    reference's Java PTBTokenizer (unavailable offline); on
    pre-tokenized text the scores are identical."""

    def eval_pred_list(self, pred_list: List[dict]) -> float:
        refs = [[a.lower().split() for a in entry["gt_answers"]]
                for entry in pred_list]
        hyps = [entry["pred_answer"].lower().split()
                for entry in pred_list]
        return corpus_bleu4(refs, hyps)
