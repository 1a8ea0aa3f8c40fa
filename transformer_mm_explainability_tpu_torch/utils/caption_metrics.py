"""Caption metrics: corpus BLEU, ROUGE-L, CIDEr-D (C28/C34 tooling).

The port's copy of ``transformer_mm_explainability_tpu/utils/
caption_metrics.py`` (numpy only; importing that module would load the JAX
package).

Rewrite of the scorers behind
``VisualBERT/tools/scripts/coco/coco_caption_eval.py`` (which imports
pycocoevalcap — tylin/coco-caption).  The exact published semantics
are reproduced:

- **BLEU** (bleu_scorer.py): clipped n-gram precision with the
  ``tiny``/``small`` smoothing constants, *closest* reference length
  for the brevity penalty, per-image sentence scores plus the corpus
  score accumulated over total counts.
- **ROUGE-L** (rouge.py): LCS F-measure with beta=1.2, max
  precision/recall over references, corpus mean.
- **CIDEr-D** (cider_scorer.py): TF-IDF 1-4-gram vectors with
  corpus document frequency, count clipping, the gaussian length
  penalty (sigma=6, delta measured in *bigram* counts — the published
  quirk), ×10 scaling.  With a single gts image ``log(N)=0`` zeroes
  every idf weight, exactly as the reference behaves.

METEOR and SPICE are NOT implemented: both shell out to Java jars
(meteor-1.5.jar / spice-1.0.jar) that are not redistributable inside
this framework; ``COCOEvalCap`` skips them and records which scorers
ran.  Tokenization: the reference uses the Stanford PTBTokenizer via a
Java subprocess; ``ptb_tokenize`` reproduces its observable protocol
(lowercase, split on whitespace after separating punctuation, drop the
PUNCTUATIONS list) in pure Python.
"""

from __future__ import annotations

import math
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import numpy as np

# pycocoevalcap/tokenizer/ptbtokenizer.py:23-28
PUNCTUATIONS = ["''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"]

_TOKEN_RE = re.compile(r"[a-z0-9]+(?:'[a-z0-9]+)?|[^\sa-z0-9]+")


def ptb_tokenize(caption: str) -> str:
    """PTB-style tokenization: lowercase, separate punctuation, drop
    the PUNCTUATIONS tokens, re-join with single spaces."""
    toks = _TOKEN_RE.findall(caption.lower().strip())
    return " ".join(t for t in toks if t not in PUNCTUATIONS)


def _ngram_counts(words: Sequence[str], n: int = 4) -> Dict[Tuple[str, ...], int]:
    counts: Dict[Tuple[str, ...], int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


# ------------------------------------------------------------------ BLEU
class BleuScorer:
    """bleu_scorer.py semantics, option='closest'."""

    TINY = 1e-15
    SMALL = 1e-9

    def __init__(self, n: int = 4):
        self.n = n

    def _cook(self, test: str, refs: Sequence[str]):
        twords = test.split()
        testlen = len(twords)
        reflens = [len(r.split()) for r in refs]
        # closest reference length; ties break toward the shorter
        # (bleu_scorer.py:176-181 — min over (abs diff, reflen))
        reflen = min(reflens, key=lambda rl: (abs(rl - testlen), rl))
        maxcounts: Dict[Tuple[str, ...], int] = {}
        for ref in refs:
            for ng, c in _ngram_counts(ref.split(), self.n).items():
                maxcounts[ng] = max(maxcounts.get(ng, 0), c)
        guess = [max(0, testlen - k) for k in range(self.n)]
        correct = [0] * self.n
        for ng, c in _ngram_counts(twords, self.n).items():
            correct[len(ng) - 1] += min(c, maxcounts.get(ng, 0))
        return testlen, reflen, guess, correct

    @staticmethod
    def _single(testlen, reflen, guess, correct, n):
        bleus = []
        bleu = 1.0
        for k in range(n):
            bleu *= (correct[k] + BleuScorer.TINY) / (guess[k] +
                                                      BleuScorer.SMALL)
            bleus.append(bleu ** (1.0 / (k + 1)))
        ratio = (testlen + BleuScorer.TINY) / (reflen + BleuScorer.SMALL)
        if ratio < 1:
            bp = math.exp(1 - 1 / ratio)
            bleus = [b * bp for b in bleus]
        return bleus

    def compute_score(self, gts: Mapping, res: Mapping):
        """→ ([Bleu_1..Bleu_n corpus], [[per-image Bleu_k]...])."""
        totals = {"testlen": 0, "reflen": 0,
                  "guess": [0] * self.n, "correct": [0] * self.n}
        per_image: List[List[float]] = [[] for _ in range(self.n)]
        for img_id in gts:
            assert len(res[img_id]) == 1
            testlen, reflen, guess, correct = self._cook(
                res[img_id][0], gts[img_id])
            totals["testlen"] += testlen
            totals["reflen"] += reflen
            for k in range(self.n):
                totals["guess"][k] += guess[k]
                totals["correct"][k] += correct[k]
            for k, b in enumerate(self._single(
                    testlen, reflen, guess, correct, self.n)):
                per_image[k].append(b)
        corpus = self._single(totals["testlen"], totals["reflen"],
                              totals["guess"], totals["correct"], self.n)
        return corpus, per_image


# --------------------------------------------------------------- ROUGE-L
def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


class Rouge:
    """rouge.py: LCS F-measure, beta=1.2, max over refs."""

    BETA = 1.2

    def calc_score(self, candidate: Sequence[str],
                   refs: Sequence[str]) -> float:
        token_c = candidate[0].split()
        prec, rec = [], []
        for reference in refs:
            token_r = reference.split()
            lcs = _lcs_len(token_r, token_c)
            prec.append(lcs / float(len(token_c)) if token_c else 0.0)
            rec.append(lcs / float(len(token_r)) if token_r else 0.0)
        prec_max, rec_max = max(prec), max(rec)
        if prec_max != 0 and rec_max != 0:
            return ((1 + self.BETA ** 2) * prec_max * rec_max /
                    (rec_max + self.BETA ** 2 * prec_max))
        return 0.0

    def compute_score(self, gts: Mapping, res: Mapping):
        scores = [self.calc_score(res[i], gts[i]) for i in gts]
        return float(np.mean(scores)), scores


# --------------------------------------------------------------- CIDEr-D
class CiderD:
    """cider_scorer.py semantics (the CIDEr-D variant used by the
    evaluation servers): count clipping + gaussian length penalty."""

    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def _counts(self, sent: str):
        return _ngram_counts(sent.split(), self.n)

    def compute_score(self, gts: Mapping, res: Mapping):
        doc_freq: Dict[Tuple[str, ...], int] = defaultdict(int)
        crefs = {i: [self._counts(r) for r in gts[i]] for i in gts}
        for refs in crefs.values():
            for ng in set(ng for ref in refs for ng in ref):
                doc_freq[ng] += 1
        ref_len = np.log(float(len(crefs)))

        def counts2vec(cnts):
            vec = [defaultdict(float) for _ in range(self.n)]
            norm = [0.0] * self.n
            length = 0
            for ng, tf in cnts.items():
                df = np.log(max(1.0, doc_freq[ng]))
                k = len(ng) - 1
                vec[k][ng] = float(tf) * (ref_len - df)
                norm[k] += vec[k][ng] ** 2
                if k == 1:  # bigram count — the published delta quirk
                    length += tf
            return vec, [np.sqrt(x) for x in norm], length

        def sim(vec_h, norm_h, len_h, vec_r, norm_r, len_r):
            delta = float(len_h - len_r)
            val = np.zeros(self.n)
            for k in range(self.n):
                for ng, count in vec_h[k].items():
                    val[k] += min(vec_h[k][ng], vec_r[k][ng]) * vec_r[k][ng]
                if norm_h[k] != 0 and norm_r[k] != 0:
                    val[k] /= norm_h[k] * norm_r[k]
                val[k] *= math.exp(-delta ** 2 / (2 * self.sigma ** 2))
            return val

        scores = []
        for img_id in gts:
            vec, norm, length = counts2vec(self._counts(res[img_id][0]))
            score = np.zeros(self.n)
            for ref_cnts in crefs[img_id]:
                vec_r, norm_r, len_r = counts2vec(ref_cnts)
                score += sim(vec, norm, length, vec_r, norm_r, len_r)
            scores.append(float(
                np.mean(score) / len(crefs[img_id]) * 10.0))
        return float(np.mean(scores)), scores


# ------------------------------------------------------------ harness
class COCOEvalCap:
    """coco_caption_eval.py:20-85 minus the Java-bound scorers.

    ``gts``/``res``: {img_id: [{"caption": str}, ...]} annotation
    lists, exactly the structure ``calculate_metrics`` builds."""

    def __init__(self, img_ids, coco, coco_res):
        self.eval: Dict[str, float] = {}
        self.img_to_eval: Dict = {}
        self.coco = coco
        self.coco_res = coco_res
        self.skipped = ("METEOR", "SPICE")  # Java-bound; see module doc

    def evaluate(self) -> None:
        gts = {i: [ptb_tokenize(a["caption"]) for a in anns]
               for i, anns in self.coco.items()}
        res = {i: [ptb_tokenize(a["caption"]) for a in anns]
               for i, anns in self.coco_res.items()}
        scorers = [
            (BleuScorer(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
            (Rouge(), "ROUGE_L"),
            (CiderD(), "CIDEr"),
        ]
        for scorer, method in scorers:
            score, scores = scorer.compute_score(gts, res)
            if isinstance(method, list):
                for sc, scs, m in zip(score, scores, method):
                    self.eval[m] = sc
                    self._per_image(scs, gts.keys(), m)
            else:
                self.eval[method] = score
                self._per_image(scores, gts.keys(), method)

    def _per_image(self, scores, img_ids, method):
        for img_id, score in zip(img_ids, scores):
            entry = self.img_to_eval.setdefault(
                img_id, {"image_id": img_id})
            entry[method] = score


def calculate_metrics(img_ids: Iterable, dataset_gts: Mapping,
                      dataset_res: Mapping) -> Dict[str, float]:
    """coco_caption_eval.py:88-99.  Annotations outside ``img_ids``
    are ignored (the reference KeyErrors on them — pinned fix, so a
    full-val prediction file can be scored against a test subset)."""
    keep = set(img_ids)
    img_to_anns_gts = {i: [] for i in img_ids}
    for ann in dataset_gts["annotations"]:
        if ann["image_id"] in keep:
            img_to_anns_gts[ann["image_id"]] += [ann]
    img_to_anns_res = {i: [] for i in img_ids}
    for ann in dataset_res["annotations"]:
        if ann["image_id"] in keep:
            img_to_anns_res[ann["image_id"]] += [ann]
    eval_obj = COCOEvalCap(img_ids, img_to_anns_gts, img_to_anns_res)
    eval_obj.evaluate()
    return eval_obj.eval
