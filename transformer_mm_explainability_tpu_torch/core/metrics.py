"""Metric registry — every metric MMF registers, in PyTorch (C28).

Counterpart of ``transformer_mm_explainability_tpu/core/metrics.py``
(``VisualBERT/mmf/modules/metrics.py``): all 31 registered names
(accuracy:211, caption_bleu4:258, vqa_accuracy:316,
vqa_evalai_accuracy:365, r@1/r@5/r@10:478-556, mean_r:559,
mean_rr:587, textvqa_accuracy:614, stvqa_anls:661, stvqa_accuracy:671,
ocrvqa_accuracy:681, textcaps_bleu4:689, the f1 family:701-813, the
roc_auc family:816-874, the ap family:877-971, r@pk:974-1024) plus the
``Metrics`` orchestrator (:70-160).

The tensor metrics (accuracy, vqa_accuracy, top_k_accuracy, the ranks)
run on the scores' own device and return 0-d tensors there; the
sklearn-backed ones (f1/roc_auc/ap — the reference also calls sklearn),
``caption_bleu4`` (nltk) and the string-space evaluators (EvalAI
protocol) run on host numpy, importing sklearn and nltk only when called:
without them they raise ``ImportError``.

Registered callables take ``(sample_list, model_output, **params)``
dicts like the reference; ``compute(name, scores, targets)`` is the
tensor-first convenience wrapper.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Sequence, Union

import numpy as np
import torch

from transformer_mm_explainability_tpu_torch.core.registry import registry
from transformer_mm_explainability_tpu_torch.utils import m4c_evaluators

SampleDict = Mapping[str, Any]


def _np(x) -> np.ndarray:
    """A tensor (any device) or array as host numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _one_hot_np(expected: np.ndarray, output: np.ndarray) -> np.ndarray:
    """_convert_to_one_hot (metrics.py:60-67) on host arrays."""
    if np.squeeze(output).ndim != np.squeeze(expected).ndim \
            and expected.ndim == 1:
        expected = np.eye(output.shape[-1], dtype=np.float32)[expected]
    return expected


def _t(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor on ``like``'s device."""
    return torch.as_tensor(x, device=like.device)


# ---------------------------------------------------------------------------
# tensor metrics, on the scores' device
# ---------------------------------------------------------------------------

@registry.register_metric("accuracy")
def accuracy(sample_list: SampleDict, model_output: SampleDict
             ) -> torch.Tensor:
    """Accuracy (metrics.py:211-255)."""
    output = torch.as_tensor(model_output["scores"])
    expected = _t(sample_list["targets"], output)
    if output.ndim == 2:
        output = output.argmax(1)
    if expected.ndim == 2:
        # class indices in a trailing singleton stay indices; anything
        # wider is (soft) one-hot — argmax.  Squeeze either way so the
        # comparison below is [B] == [B], never a [B, B] broadcast
        expected = (expected[:, 0] if expected.shape[-1] == 1
                    else expected.argmax(1))
    return (expected == output.squeeze()).sum() / expected.shape[0]


def _masked_unk_softmax(x: torch.Tensor, mask_idx: int) -> torch.Tensor:
    """VQAAccuracy._masked_unk_softmax (metrics.py:329-334)."""
    x1 = torch.softmax(x, dim=1).clone()
    x1[:, mask_idx] = 0
    return x1 / x1.sum(dim=1, keepdim=True)


@registry.register_metric("vqa_accuracy")
def vqa_accuracy(sample_list: SampleDict, model_output: SampleDict
                 ) -> torch.Tensor:
    """VQAAccuracy (metrics.py:316-362): soft-label mass of the argmax
    answer with the UNK column (index 0) masked out; 3-dim scores take
    the first (fused) branch."""
    output = torch.as_tensor(model_output["scores"])
    if output.ndim == 3:
        output = output[:, 0]
    expected = _t(sample_list["targets"], output)
    pred = _masked_unk_softmax(output, 0).argmax(dim=1)
    picked = expected.gather(1, pred[:, None])[:, 0]
    return picked.sum() / expected.shape[0]


@registry.register_metric("top_k_accuracy")
def top_k_accuracy(sample_list: SampleDict, model_output: SampleDict,
                   k: int = 5) -> torch.Tensor:
    """Not in the reference list: hit rate within the top k (ties broken
    by the lower index, as the JAX package's stable argsort does)."""
    scores = torch.as_tensor(model_output["scores"])
    targets = _t(sample_list["targets"], scores)
    topk = torch.argsort(-scores, dim=-1, stable=True)[:, :k]
    if targets.ndim == scores.ndim:
        targets = targets.argmax(-1)
    return (topk == targets[:, None]).any(-1).float().mean()


def _ranks(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """RecallAtK.score_to_ranks+get_gt_ranks (metrics.py:441-460): rank
    (1-based) of the ground-truth candidate under descending-score
    order (stable: ties keep index order).  The reference's loop
    hard-codes 100 candidates (the VisDial protocol); this is the same
    computation for any width."""
    order = torch.argsort(-scores, dim=1, stable=True)
    ranks = torch.empty_like(order)
    ar = torch.arange(order.shape[1], device=order.device)
    ranks.scatter_(1, order, ar.expand_as(order))
    ranks = ranks + 1
    gt = targets.argmax(dim=1)
    return ranks.gather(1, gt[:, None])[:, 0].float()


def _recall_at(sample_list: SampleDict, model_output: SampleDict, k: int
               ) -> torch.Tensor:
    scores = torch.as_tensor(model_output["scores"])
    r = _ranks(scores, _t(sample_list["targets"], scores))
    return (r <= k).sum() / r.shape[0]


registry.register_metric("r@1")(
    lambda s, m, **kw: _recall_at(s, m, 1))
registry.register_metric("r@5")(
    lambda s, m, **kw: _recall_at(s, m, 5))
registry.register_metric("r@10")(
    lambda s, m, **kw: _recall_at(s, m, 10))


@registry.register_metric("mean_r")
def mean_rank(sample_list: SampleDict, model_output: SampleDict
              ) -> torch.Tensor:
    """MeanRank (metrics.py:559-584)."""
    scores = torch.as_tensor(model_output["scores"])
    return _ranks(scores, _t(sample_list["targets"], scores)).mean()


@registry.register_metric("mean_rr")
def mean_reciprocal_rank(sample_list: SampleDict, model_output: SampleDict
                         ) -> torch.Tensor:
    """MeanReciprocalRank (metrics.py:587-611)."""
    scores = torch.as_tensor(model_output["scores"])
    return (1.0 / _ranks(scores,
                         _t(sample_list["targets"], scores))).mean()


# ---------------------------------------------------------------------------
# caption / EvalAI string-space metrics (host-side)
# ---------------------------------------------------------------------------

@registry.register_metric("caption_bleu4")
def caption_bleu4(sample_list: SampleDict, model_output: SampleDict,
                  caption_processor: Callable = None) -> float:
    """CaptionBleu4Metric (metrics.py:258-313): nltk corpus BLEU-4 over
    processor-tokenized references (``sample_list['answers']``) and
    hypotheses (``model_output['captions']`` or argmax of scores)."""
    import nltk.translate.bleu_score as bleu_score
    if caption_processor is None:
        # free-form registry STATE set by the dataset builder, like the
        # reference's registry.get("coco_caption_processor")
        caption_processor = registry.get_state("coco_caption_processor")
        if caption_processor is None:
            raise KeyError(
                "no 'coco_caption_processor' in registry state — the "
                "dataset builder must register it, or pass "
                "caption_processor explicitly")
    references = [[caption_processor(list(c))["tokens"] for c in caps]
                  for caps in sample_list["answers"]]
    if "captions" in model_output:
        scores = model_output["captions"]
    else:
        scores = _np(model_output["scores"]).argmax(-1)
    hypotheses = [caption_processor(list(_np(s)))["tokens"]
                  for s in scores]
    assert len(references) == len(hypotheses)
    return float(bleu_score.corpus_bleu(references, hypotheses))


@registry.register_metric("vqa_evalai_accuracy")
def vqa_evalai_accuracy(sample_list: SampleDict, model_output: SampleDict,
                        answer_processor=None) -> float:
    """VQAEvalAIAccuracy (metrics.py:365-434): decode the UNK-masked
    argmax answer (copy-pointer ids above the vocab read from
    ``context_tokens``), EvalAI-normalize both sides, min(#match/3,1)
    averaged leave-one-out over the 10 ground-truth answers."""
    if answer_processor is None:
        key = sample_list.get("dataset_name", "vqa2") + "_answer_processor"
        answer_processor = registry.get_state(key)
        if answer_processor is None:
            raise KeyError(
                f"no {key!r} in registry state — the dataset builder "
                "must register it, or pass answer_processor explicitly")
    evalai = m4c_evaluators.EvalAIAnswerProcessor()
    output = _np(_masked_unk_softmax(
        torch.as_tensor(model_output["scores"]), 0).argmax(dim=1))
    answer_space_size = answer_processor.get_true_vocab_size()
    expected = sample_list["answers"]
    accuracy_list: List[float] = []
    for idx, answer_id in enumerate(output.tolist()):
        if answer_id >= answer_space_size:
            answer = sample_list["context_tokens"][idx][
                answer_id - answer_space_size]
        else:
            answer = answer_processor.idx2word(answer_id)
        answer = evalai(answer)
        gt_answers = list(enumerate(evalai(x) for x in expected[idx]))
        gt_acc = []
        for gt_answer in gt_answers:
            others = [item for item in gt_answers if item != gt_answer]
            matching = [item for item in others if item[1] == answer]
            gt_acc.append(min(1.0, len(matching) / 3.0))
        accuracy_list.append(sum(gt_acc) / len(gt_acc))
    return float(sum(accuracy_list) / len(accuracy_list))


def build_m4c_predictions(pred_ids: Sequence[Sequence[int]],
                          context_tokens: Sequence[Sequence[str]],
                          gt_answers: Sequence[Sequence[str]],
                          idx2word: Callable[[int], str],
                          eos_idx: int,
                          answer_space_size: int) -> List[dict]:
    """TextVQAAccuracy.calculate's decode loop (metrics.py:624-653):
    fixed-vocab ids decode through ``idx2word`` (stop at EOS);
    copy-pointer ids above the vocab read from ``context_tokens``."""
    predictions = []
    for idx, ids in enumerate(pred_ids):
        words: List[str] = []
        for answer_id in ids:
            if answer_id >= answer_space_size:
                words.append(m4c_evaluators.EvalAIAnswerProcessor()
                             .word_tokenize(
                                 context_tokens[idx][
                                     answer_id - answer_space_size]))
            else:
                if answer_id == eos_idx:
                    break
                words.append(idx2word(answer_id))
        predictions.append({
            "pred_answer": " ".join(words).replace(" 's", "'s"),
            "gt_answers": list(gt_answers[idx]),
        })
    return predictions


def _m4c_metric(evaluator_cls):
    def fn(sample_list: SampleDict, model_output: SampleDict,
           **params) -> float:
        if "predictions" in model_output:
            preds = model_output["predictions"]
        else:
            preds = build_m4c_predictions(
                _np(model_output["scores"]).argmax(-1),
                sample_list["context_tokens"],
                sample_list.get("answers", sample_list.get("ref_strs")),
                params["idx2word"], params["eos_idx"],
                params["answer_space_size"])
        return float(evaluator_cls().eval_pred_list(preds))
    return fn


registry.register_metric("textvqa_accuracy")(
    _m4c_metric(m4c_evaluators.TextVQAAccuracyEvaluator))
registry.register_metric("stvqa_accuracy")(
    _m4c_metric(m4c_evaluators.STVQAAccuracyEvaluator))
registry.register_metric("ocrvqa_accuracy")(
    _m4c_metric(m4c_evaluators.STVQAAccuracyEvaluator))
registry.register_metric("stvqa_anls")(
    _m4c_metric(m4c_evaluators.STVQAANLSEvaluator))
registry.register_metric("textcaps_bleu4")(
    _m4c_metric(m4c_evaluators.TextCapsBleu4Evaluator))


# ---------------------------------------------------------------------------
# sklearn-backed families (the reference also defers to sklearn)
# ---------------------------------------------------------------------------

def _f1(sample_list: SampleDict, model_output: SampleDict,
        multilabel: bool = False, **sk_kwargs) -> float:
    """F1 (metrics.py:701-741)."""
    from sklearn.metrics import f1_score
    scores = _np(model_output["scores"])
    expected = _np(sample_list["targets"])
    if multilabel:
        output = np.round(1.0 / (1.0 + np.exp(-scores)))
        expected = _one_hot_np(expected, output)
    else:
        output = scores.argmax(-1)
        if expected.ndim != 1:
            expected = expected.argmax(-1)
    return float(f1_score(expected, output, **sk_kwargs))


registry.register_metric("f1")(_f1)
registry.register_metric("macro_f1")(
    lambda s, m, **kw: _f1(s, m, average="macro", **kw))
registry.register_metric("micro_f1")(
    lambda s, m, **kw: _f1(s, m, average="micro", **kw))
registry.register_metric("binary_f1")(
    lambda s, m, **kw: _f1(s, m, average="micro", labels=[1], **kw))
registry.register_metric("multilabel_f1")(
    lambda s, m, **kw: _f1(s, m, multilabel=True, **kw))
registry.register_metric("multilabel_micro_f1")(
    lambda s, m, **kw: _f1(s, m, multilabel=True, average="micro", **kw))
registry.register_metric("multilabel_macro_f1")(
    lambda s, m, **kw: _f1(s, m, multilabel=True, average="macro", **kw))


def _softmax_np(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _roc_auc(sample_list: SampleDict, model_output: SampleDict,
             **sk_kwargs) -> float:
    """ROC_AUC (metrics.py:816-850)."""
    from sklearn.metrics import roc_auc_score
    output = _softmax_np(_np(model_output["scores"]))
    expected = _one_hot_np(_np(sample_list["targets"]), output)
    return float(roc_auc_score(expected, output, **sk_kwargs))


registry.register_metric("roc_auc")(_roc_auc)
registry.register_metric("micro_roc_auc")(
    lambda s, m, **kw: _roc_auc(s, m, average="micro", **kw))
registry.register_metric("macro_roc_auc")(
    lambda s, m, **kw: _roc_auc(s, m, average="macro", **kw))


def _ap(sample_list: SampleDict, model_output: SampleDict,
        **sk_kwargs) -> float:
    """AveragePrecision (metrics.py:877-908)."""
    from sklearn.metrics import average_precision_score
    output = _softmax_np(_np(model_output["scores"]))
    expected = _one_hot_np(_np(sample_list["targets"]), output)
    return float(average_precision_score(expected, output, **sk_kwargs))


@registry.register_metric("binary_ap")
def binary_ap(sample_list: SampleDict, model_output: SampleDict,
              **sk_kwargs) -> float:
    """BinaryAP (metrics.py:911-947): AP of the positive-class score."""
    from sklearn.metrics import average_precision_score
    output = _softmax_np(_np(model_output["scores"]))[:, 1]
    expected = _np(sample_list["targets"])
    if expected.ndim == 2:
        expected = expected.argmax(-1)
    return float(average_precision_score(expected, output, **sk_kwargs))


registry.register_metric("ap")(_ap)
registry.register_metric("micro_ap")(
    lambda s, m, **kw: _ap(s, m, average="micro", **kw))
registry.register_metric("macro_ap")(
    lambda s, m, **kw: _ap(s, m, average="macro", **kw))


@registry.register_metric("r@pk")
def recall_at_precision_k(sample_list: SampleDict,
                          model_output: SampleDict,
                          p_threshold: float) -> float:
    """RecallAtPrecisionK (metrics.py:974-1024)."""
    from sklearn.metrics import precision_recall_curve
    p_threshold = p_threshold if p_threshold < 1 else p_threshold / 100
    output = _softmax_np(_np(model_output["scores"]))[:, 1]
    expected = _np(sample_list["targets"])
    if expected.ndim == 2:
        expected = expected.argmax(-1)
    precision, recall, _ = precision_recall_curve(expected, output)
    try:
        value, _ = max((r, p) for p, r in zip(precision, recall)
                       if p >= p_threshold)
    except ValueError:
        value = 0.0
    return float(value)


# ---------------------------------------------------------------------------
# orchestration (metrics.py:70-160) + tensor-first convenience
# ---------------------------------------------------------------------------

MetricSpec = Union[str, Mapping[str, Any]]


class Metrics:
    """Metrics orchestrator (metrics.py:70-160): resolves each spec
    from the registry and returns ``{type}/{dataset}/{key}: value``."""

    def __init__(self, metric_list: Union[MetricSpec, List[MetricSpec]]):
        if isinstance(metric_list, (str, Mapping)):
            metric_list = [metric_list]
        self.metrics: Dict[str, Callable] = {}
        self.params: Dict[str, dict] = {}
        for spec in metric_list:
            if isinstance(spec, Mapping):
                if "type" not in spec:
                    raise ValueError(
                        f"Metric {spec} needs to have 'type' attribute "
                        "or should be a string")
                mtype = key = spec["type"]
                key = spec.get("key", key)
                params = dict(spec.get("params", {}) or {})
            else:
                if not isinstance(spec, str):
                    raise TypeError(
                        "Metric {} has inappropriate type"
                        "'dict' or 'str' allowed".format(spec))
                mtype = key = spec
                params = {}
            if key in self.metrics:
                raise RuntimeError(
                    f"Metric with type/key '{mtype}' has been defined "
                    "more than once in metric list.")
            self.metrics[key] = registry.get("metric", mtype)
            self.params[key] = params

    def __call__(self, sample_list: SampleDict, model_output: SampleDict
                 ) -> Dict[str, float]:
        dataset_type = sample_list.get("dataset_type", "val")
        dataset_name = sample_list.get("dataset_name", "unknown")
        values = {}
        for name, fn in self.metrics.items():
            key = f"{dataset_type}/{dataset_name}/{name}"
            values[key] = float(fn(sample_list, model_output,
                                   **self.params[name]))
        return values


def compute(name: str, scores, targets, **kw) -> float:
    """Tensor-first convenience: compute a registered metric from bare
    scores/targets arrays."""
    return float(registry.get("metric", name)(
        {"targets": targets}, {"scores": scores}, **kw))
