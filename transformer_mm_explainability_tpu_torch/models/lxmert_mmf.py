"""The MMF-side LXMERT, registry name ``lxmert-old``, in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/lxmert_mmf.py``
(``mmf/models/lxmert.py:633-774``): ``LXMERTForPretraining`` (masked LM,
object prediction, matching and QA heads) and ``LXMERTForClassification``
(a BertVisualAnswerHead over the pooled CLS; NLVR2 pairs the pooled
vectors) on the port's ``models/lxmert`` encoder and
``models/lxmert_pretrain`` heads, whose cross entropy and Huber term are
optax's (``softmax_cross_entropy_with_integer_labels``, ``huber_loss``).

MMF's sample list maps onto the ``batch`` dict: input_ids, segment_ids
(token types), input_mask, image_feature_0 (visual features), bbox
(visual positions) and image_mask.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from transformer_mm_explainability_tpu_torch.models import lxmert as lx
from transformer_mm_explainability_tpu_torch.models import (
    lxmert_pretrain as lxp)
from transformer_mm_explainability_tpu_torch.models import mmf_layers as L
from transformer_mm_explainability_tpu_torch.ops.attention import (
    gelu,
    layer_norm,
)


@dataclasses.dataclass(frozen=True)
class LxmertOldConfig:
    """configs/models/lxmert/pretrain.yaml defaults (reference
    lxmert.py:642-708 ``build``)."""
    lxmert: lx.LxmertConfig = lx.LXMERT_VQA
    training_head_type: str = "pretraining"  # | "vqa2" | "gqa" | "nlvr2"
    num_labels: int = 3129
    gqa_labels: int = 1842
    num_object_labels: int = 1600
    task_mask_lm: bool = True
    task_obj_predict: bool = True
    task_matched: bool = True
    task_qa: bool = True


def _init_logit_fc(gen, in_dim: int, hid: int, out_dim: int,
                   device) -> Dict[str, Any]:
    """BertVisualAnswerHead's logit_fc: Linear(in, 2·hid) → GeLU → LN →
    Linear(2·hid, out) (lxmert.py:133-139), ``[in, out]`` weights."""
    return {"w1": L.normal(gen, (in_dim, hid * 2), 0.02, device),
            "b1": torch.zeros(hid * 2, device=device),
            "ln": L.ln_init(hid * 2, device),
            "w2": L.normal(gen, (hid * 2, out_dim), 0.02, device),
            "b2": torch.zeros(out_dim, device=device)}


def _logit_fc_fwd(p: Dict[str, Any], x: torch.Tensor,
                  eps: float) -> torch.Tensor:
    h = layer_norm(gelu(x @ p["w1"] + p["b1"]), p["ln"]["scale"],
                   p["ln"]["bias"], eps)
    return h @ p["w2"] + p["b2"]


def init_params(seed: L.Seed = 0, cfg: LxmertOldConfig = LxmertOldConfig(),
                device="cuda") -> Dict[str, Any]:
    gen = L.generator(seed)
    D = cfg.lxmert.hidden_size
    params: Dict[str, Any] = {"bert": lx.init_params(gen, cfg.lxmert,
                                                     device)}
    if cfg.training_head_type == "pretraining":
        params["heads"] = lxp.init_head_params(
            gen, cfg.lxmert, cfg.num_object_labels, device)
        if cfg.task_qa:
            # BertVisualAnswerHead and its gqa twin (lxmert.py:124-131)
            params["answer_head"] = _init_logit_fc(gen, D, D,
                                                   cfg.num_labels, device)
            params["answer_head_gqa"] = _init_logit_fc(gen, D, D,
                                                       cfg.gqa_labels, device)
    else:
        nlvr2 = cfg.training_head_type == "nlvr2"
        params["classifier"] = _init_logit_fc(
            gen, D * 2 if nlvr2 else D, D, 2 if nlvr2 else cfg.num_labels,
            device)
    return params


def _backbone(params, batch: Dict[str, torch.Tensor],
              cfg: LxmertOldConfig) -> Dict[str, Any]:
    return lx.forward(params["bert"], batch["input_ids"],
                      batch["input_mask"], batch["image_feature_0"],
                      batch["bbox"], token_type_ids=batch.get("segment_ids"),
                      visual_mask=batch.get("image_mask"), cfg=cfg.lxmert)


def forward_classification(params: Dict[str, Any],
                           batch: Dict[str, torch.Tensor],
                           cfg: LxmertOldConfig) -> Dict[str, torch.Tensor]:
    """LXMERTForClassification.forward (lxmert.py:591-631)."""
    pooled = _backbone(params, batch, cfg)["pooled"]
    if cfg.training_head_type == "nlvr2":
        pooled = pooled.reshape(-1, pooled.shape[-1] * 2)
    return {"scores": _logit_fc_fwd(params["classifier"], pooled,
                                    cfg.lxmert.layer_norm_eps)}


def _masked_ce(logits: torch.Tensor, labels: torch.Tensor,
               ignore_index: int = -1) -> torch.Tensor:
    """CrossEntropyLoss(ignore_index=−1) over flattened logits / labels."""
    mask = labels != ignore_index
    return lxp._masked_mean(lxp._ce(logits, labels), mask)


def forward_pretraining(params: Dict[str, Any],
                        batch: Dict[str, torch.Tensor],
                        cfg: LxmertOldConfig, name: Optional[str] = None
                        ) -> Dict[str, torch.Tensor]:
    """LXMERTForPretraining.forward (lxmert.py:462-558) → the reference's
    loss keys. A task runs where its fields are in ``batch``:
    masked_lm_labels ``[B, St]`` (−1 unmasked), matched_label ``[B]``,
    obj_labels ``[B, Sv, C]`` soft detector scores, masked_image_labels
    ``[B, Sv]`` (1 masked), ans ``[B, A]`` soft answer scores."""
    eps = cfg.lxmert.layer_norm_eps
    out = _backbone(params, batch, cfg)
    heads = params["heads"]
    output: Dict[str, torch.Tensor] = {}
    if cfg.task_qa and "ans" in batch:
        head = (params["answer_head_gqa"] if name is not None
                and "gqa" in name else params["answer_head"])
        output["answer_loss"] = _masked_ce(
            _logit_fc_fwd(head, out["pooled"], eps), batch["ans"].argmax(-1))
    if cfg.task_mask_lm and "masked_lm_labels" in batch:
        lm = lxp.lm_logits(heads, params["bert"]["embeddings"]["word"],
                           out["lang_output"], eps)
        output["masked_lm_loss"] = _masked_ce(lm, batch["masked_lm_labels"])
    if cfg.task_matched and "matched_label" in batch:
        match_logits = out["pooled"] @ heads["matching"]["w"] \
            + heads["matching"]["b"]
        output["matched_loss"] = _masked_ce(match_logits,
                                            batch["matched_label"])
    if cfg.task_obj_predict and "obj_labels" in batch:
        # object CE against the argmax, weighted by its confidence, and
        # the smooth-L1 feature regression on masked regions
        # (lxmert.py:521-556)
        h_obj = lxp._transform(heads["obj_transform"], out["visn_output"],
                               eps)
        obj_logits = h_obj @ heads["obj_decoder"]["w"] \
            + heads["obj_decoder"]["b"]
        conf = batch["obj_labels"].amax(-1)
        idx = batch["obj_labels"].argmax(-1)
        visn_loss = (lxp._ce(obj_logits, idx) * conf).mean()
        if "masked_image_labels" in batch:
            feat_pred = h_obj @ heads["feat_decoder"]["w"] \
                + heads["feat_decoder"]["b"]
            l1 = lxp.huber(feat_pred, batch["image_feature_0"]).mean(-1)
            mask_conf = (batch["masked_image_labels"] == 1).to(l1.dtype)
            visn_loss = visn_loss + (l1.reshape(-1)
                                     * mask_conf.reshape(-1)).mean()
        output["visn_loss"] = visn_loss
    return output


def forward(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            cfg: LxmertOldConfig = LxmertOldConfig(),
            name: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """LXMERT.forward dispatch (lxmert.py:710-774)."""
    if cfg.training_head_type == "pretraining":
        return forward_pretraining(params, batch, cfg, name)
    return forward_classification(params, batch, cfg)
