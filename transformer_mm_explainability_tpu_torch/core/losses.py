"""Loss registry — every loss MMF registers, in PyTorch (C34/C24).

Counterpart of ``transformer_mm_explainability_tpu/core/losses.py``
(``VisualBERT/mmf/modules/losses.py``): the registered losses
(``logit_bce``:192, ``triple_logit_bce``:221, ``bce``:260,
``caption_cross_entropy``:284, ``nll_loss``:323, ``multi``:360,
``attention_supervision``:417, ``weighted_softmax``:453,
``softmax_kldiv``:474, ``wrong``:494, ``bce_kl_combined``:514,
``m4c_decoding_bce_with_mask``:543, ``cross_entropy``:563) plus the
``Losses``/``MMFLoss`` orchestration wrappers (:40-189).

Every loss is a plain function of (sample_list dict, model_output dict)
→ 0-d tensor on the scores' device, with the JAX package's formulas and
reductions term for term (the stable BCE-with-logits, the sorted-length
caption mask), so the two agree to rounding; ``bce`` clamps its log
terms at -100 as torch does (``_bce`` says where the JAX package
differs). The ``Losses`` orchestrator is host-side config
plumbing.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import torch

from transformer_mm_explainability_tpu_torch.core.registry import registry

SampleDict = Mapping[str, Any]


def _bce_with_logits(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Elementwise binary_cross_entropy_with_logits, the JAX package's
    stable form ``max(x, 0) - x·t + log1p(exp(-|x|))``."""
    return x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def _bce(p: torch.Tensor, t: torch.Tensor, eps: float = 1e-12
         ) -> torch.Tensor:
    """Elementwise binary_cross_entropy on probabilities, torch's
    definition: each log term clamped at -100. The JAX package clamps the
    probability at exp(-100) instead, the same for every normal float32
    probability; but exp(-100) is subnormal in float32, XLA:CPU flushes
    it to 0, and a probability of exactly 0 or 1 gives NaN there."""
    lo = torch.log(p).clamp(min=-100.0)
    l1 = torch.log(1.0 - p).clamp(min=-100.0)
    return -(t * lo + (1.0 - t) * l1)


def _t(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor on ``like``'s device (numpy targets from
    ``collate`` are accepted)."""
    return torch.as_tensor(x, device=like.device)


@registry.register_loss("logit_bce")
def logit_bce(sample_list: SampleDict, model_output: SampleDict
              ) -> torch.Tensor:
    """LogitBinaryCrossEntropy (losses.py:192-218): mean BCE-with-logits
    scaled back by the answer-space size."""
    scores = model_output["scores"]
    targets = _t(sample_list["targets"], scores)
    return _bce_with_logits(scores, targets).mean() * targets.shape[1]


@registry.register_loss("triple_logit_bce")
def triple_logit_bce(sample_list: SampleDict, model_output: SampleDict
                     ) -> torch.Tensor:
    """TripleLogitBinaryCrossEntropy (losses.py:221-257): one BCE per
    branch of the three-branch fusion when scores is [B, 3, A]."""
    scores = model_output["scores"]
    targets = _t(sample_list["targets"], scores)
    if scores.ndim == 3:
        loss = (_bce_with_logits(scores[:, 0], targets).mean()
                + _bce_with_logits(scores[:, 1], targets).mean()
                + _bce_with_logits(scores[:, 2], targets).mean())
    else:
        loss = _bce_with_logits(scores, targets).mean()
    return loss * targets.shape[-1]


@registry.register_loss("bce")
def bce(sample_list: SampleDict, model_output: SampleDict) -> torch.Tensor:
    """BinaryCrossEntropyLoss (losses.py:260-281) on probabilities."""
    scores = model_output["scores"]
    targets = _t(sample_list["targets"], scores)
    return _bce(scores, targets).mean() * targets.shape[1]


@registry.register_loss("caption_cross_entropy")
def caption_cross_entropy(sample_list: SampleDict,
                          model_output: SampleDict) -> torch.Tensor:
    """CaptionCrossEntropyLoss (losses.py:284-320).

    scores [B, T, V], targets [B, T] int.  With ``caption_len`` the
    reference sorts the lengths descending and uses position b's
    *sorted* length-1 as row b's decode length WITHOUT reordering the
    rows (losses.py:305-306) — a protocol quirk kept exactly.
    CE is the mean over the packed (unpadded) elements.
    """
    scores = model_output["scores"]
    targets = _t(sample_list["targets"], scores).long()
    B, T = targets.shape[0], targets.shape[1]
    if sample_list.get("caption_len") is not None:
        lens = torch.sort(_t(sample_list["caption_len"], scores),
                          descending=True).values - 1
    else:
        lens = torch.full((B,), T, dtype=torch.long, device=scores.device)
    ar = torch.arange(T, device=scores.device)
    mask = (ar[None, :] < lens[:, None]).to(scores.dtype)
    logp = torch.log_softmax(scores, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


@registry.register_loss("nll_loss")
def nll_loss(sample_list: SampleDict, model_output: SampleDict
             ) -> torch.Tensor:
    """NLLLoss (losses.py:323-347): scores are log-probs, target is the
    argmax of the soft labels, scaled by answer-space size."""
    scores = model_output["scores"]
    targets = _t(sample_list["targets"], scores)
    idx = targets.argmax(dim=1)
    picked = scores.gather(1, idx[:, None])[:, 0]
    return -picked.mean() * targets.shape[1]


def _kl_div(log_x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """kl_div helper (losses.py:350-357): y·(log y − log x) with the
    y==0 rows contributing zero, summed over classes (keepdim)."""
    log_y = torch.log(torch.where(y == 0, torch.ones_like(y), y))
    res = y * (log_y - log_x)
    return res.sum(dim=1, keepdim=True)


def _normalized_targets(target_score: torch.Tensor):
    tar_sum = target_score.sum(dim=1, keepdim=True)
    tar_sum = torch.where(tar_sum == 0, torch.full_like(tar_sum, 1e-6),
                          tar_sum)
    return target_score / tar_sum, tar_sum


@registry.register_loss("weighted_softmax")
def weighted_softmax(sample_list: SampleDict, model_output: SampleDict
                     ) -> torch.Tensor:
    """WeightedSoftmaxLoss (losses.py:453-471): KL to the normalized
    soft targets, re-weighted by the target mass."""
    pred = model_output["scores"]
    tar, tar_sum = _normalized_targets(_t(sample_list["targets"], pred))
    res = torch.log_softmax(pred, dim=1)
    loss = _kl_div(res, tar) * tar_sum
    return loss.sum() / loss.shape[0]


@registry.register_loss("softmax_kldiv")
def softmax_kldiv(sample_list: SampleDict, model_output: SampleDict
                  ) -> torch.Tensor:
    """SoftmaxKlDivLoss (losses.py:474-491)."""
    pred = model_output["scores"]
    tar, _ = _normalized_targets(_t(sample_list["targets"], pred))
    loss = _kl_div(torch.log_softmax(pred, dim=1), tar)
    return loss.sum() / loss.shape[0]


@registry.register_loss("wrong")
def wrong(sample_list: SampleDict, model_output: SampleDict
          ) -> torch.Tensor:
    """WrongLoss (losses.py:494-511): F.kl_div(reduction='mean') — the
    mean is over ALL elements (the 'wrong' normalization the reference
    keeps for backward compatibility), then scaled by the class count."""
    pred = model_output["scores"]
    targets = _t(sample_list["targets"], pred)
    tar, _ = _normalized_targets(targets)
    log_x = torch.log_softmax(pred, dim=1)
    log_tar = torch.log(torch.where(tar == 0, torch.ones_like(tar), tar))
    elem = tar * (log_tar - log_x)
    return elem.mean() * targets.shape[1]


@registry.register_loss("bce_kl_combined")
def bce_kl_combined(sample_list: SampleDict, model_output: SampleDict,
                    weight_softmax: float = 1.0) -> torch.Tensor:
    """CombinedLoss (losses.py:514-540)."""
    pred = model_output["scores"]
    target = _t(sample_list["targets"], pred)
    tar, _ = _normalized_targets(target)
    loss1 = _kl_div(torch.log_softmax(pred, dim=1), tar)
    loss1 = loss1.sum() / loss1.shape[0]
    loss2 = _bce_with_logits(pred, target).mean() * target.shape[1]
    return weight_softmax * loss1 + loss2


@registry.register_loss("attention_supervision")
def attention_supervision(sample_list: SampleDict,
                          model_output: SampleDict) -> torch.Tensor:
    """AttentionSupervisionLoss (losses.py:417-450): weighted BCE of the
    first attention map against the supervision map (weight = the
    supervision itself), scaled by its second dim."""
    attn = model_output["attentions"][0]
    sup = _t(sample_list["info"]["attention_supervision"],
             attn).to(attn.dtype)
    loss = (_bce(attn, sup) * sup).mean()
    return loss * sup.shape[1]


@registry.register_loss("m4c_decoding_bce_with_mask")
def m4c_decoding_bce_with_mask(sample_list: SampleDict,
                               model_output: SampleDict) -> torch.Tensor:
    """M4CDecodingBCEWithMaskLoss (losses.py:543-560)."""
    scores = model_output["scores"]
    targets = _t(sample_list["targets"], scores)
    loss_mask = _t(sample_list["train_loss_mask"], scores)
    assert scores.ndim == 3 and loss_mask.ndim == 2
    losses = _bce_with_logits(scores, targets) * loss_mask[..., None]
    count = loss_mask.sum().clamp(min=1.0)
    return losses.sum() / count


@registry.register_loss("cross_entropy")
def cross_entropy(sample_list: SampleDict, model_output: SampleDict,
                  ignore_index: int = -100,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """CrossEntropyLoss (losses.py:563-572): int-label CE with torch's
    ``ignore_index``/``label_smoothing`` params."""
    scores = model_output["scores"]
    targets = _t(sample_list["targets"], scores).long()
    valid = targets != ignore_index
    safe = torch.where(valid, targets, torch.zeros_like(targets))
    logp = torch.log_softmax(scores, dim=-1)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    if label_smoothing:
        smooth = -logp.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    nll = nll * valid
    return nll.sum() / valid.sum().clamp(min=1)


# ---------------------------------------------------------------------------
# orchestration: Losses / MMFLoss (losses.py:40-189) + multi (:360-414)
# ---------------------------------------------------------------------------

LossSpec = Union[str, Mapping[str, Any]]


class MMFLoss:
    """MMFLoss (losses.py:118-189): resolve a loss by registry name,
    bind its params, and key the value as ``{type}/{dataset}/{name}``."""

    def __init__(self, params: Optional[LossSpec] = None):
        if params is None:
            params = {}
        if isinstance(params, str):
            name = params
        else:
            if "type" not in params:
                raise ValueError(
                    "Parameters to loss must have 'type' field to"
                    "specify type of loss to instantiate")
            name = params["type"]
        self.name = name
        if name == "multi":
            assert not isinstance(params, str)
            self.fn: Callable = _make_multi(params)
        else:
            loss_params = {} if isinstance(params, str) else dict(
                params.get("params", {}) or {})
            fn = registry.get("loss", name)
            self.fn = (functools.partial(fn, **loss_params)
                       if loss_params else fn)

    def __call__(self, sample_list: SampleDict, model_output: SampleDict
                 ) -> Dict[str, torch.Tensor]:
        loss = self.fn(sample_list, model_output)
        key = "{}/{}/{}".format(sample_list.get("dataset_type", "train"),
                                sample_list.get("dataset_name", "unknown"),
                                self.name)
        return {key: torch.atleast_1d(loss)}


def _make_multi(params: Mapping[str, Any]) -> Callable:
    """MultiLoss (losses.py:360-414): weighted sum of sub-losses."""
    subs = [(MMFLoss(p), p.get("weight", 1.0)) for p in params["params"]]

    def multi(sample_list: SampleDict, model_output: SampleDict):
        total = 0.0
        for loss_fn, weight in subs:
            (value,) = loss_fn(sample_list, model_output).values()
            total = total + weight * value[0]
        return total

    return multi


class Losses:
    """Losses (losses.py:40-115): instantiate each configured loss and
    merge their keyed values; empty dict when targets are absent."""

    def __init__(self, loss_list: List[LossSpec]):
        self.losses = [MMFLoss(spec) for spec in loss_list]

    def __call__(self, sample_list: SampleDict, model_output: SampleDict
                 ) -> Dict[str, torch.Tensor]:
        output: Dict[str, torch.Tensor] = {}
        if "targets" not in sample_list:
            return output
        for loss in self.losses:
            output.update(loss(sample_list, model_output))
        return output
