"""LXMERT pretraining heads + losses (C36: pretrain/lxmert_pretrain.py
and lxmert_lrp.py:941-1120 heads), in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/lxmert_pretrain.py``.
Tasks (lxmert_pretrain.py:435 config): masked LM (decoder TIED to the word
embeddings: the same tensor, so its gradient sums both uses), visual
feature regression (Huber, delta 1), visual object classification (CE over
detector classes), cross-modality matching, and QA — summed into one loss.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch
import torch.nn.functional as F

from transformer_mm_explainability_tpu_torch.models import lxmert as lx
from transformer_mm_explainability_tpu_torch.ops.attention import (
    gelu,
    layer_norm,
)


def init_head_params(seed: Union[int, torch.Generator],
                     cfg: lx.LxmertConfig, num_object_labels: int = 1600,
                     device="cuda") -> Dict[str, Any]:
    """Random heads (normal, std 0.02; zero biases; LN at identity), drawn
    on the CPU from ``seed``."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    D = cfg.hidden_size
    nrm = lambda *shape: (torch.randn(shape, generator=gen) * 0.02).to(device)
    zeros = lambda *shape: torch.zeros(shape, device=device)
    ln = lambda: {"scale": torch.ones(D, device=device), "bias": zeros(D)}
    return {
        "lm_transform": {"w": nrm(D, D), "b": zeros(D), "ln": ln()},
        "lm_bias": zeros(cfg.vocab_size),
        "obj_transform": {"w": nrm(D, D), "b": zeros(D), "ln": ln()},
        "obj_decoder": {"w": nrm(D, num_object_labels),
                        "b": zeros(num_object_labels)},
        "feat_decoder": {"w": nrm(D, cfg.visual_feat_dim),
                         "b": zeros(cfg.visual_feat_dim)},
        "matching": {"w": nrm(D, 2), "b": zeros(2)},
    }


def _transform(p, x, eps):
    h = gelu(x @ p["w"] + p["b"])
    return layer_norm(h, p["ln"]["scale"], p["ln"]["bias"], eps)


def lm_logits(head_params, word_embedding: torch.Tensor,
              lang_output: torch.Tensor, eps: float) -> torch.Tensor:
    """Masked-LM head with the decoder TIED to the word embeddings
    (lxmert_lrp.py LxmertLMPredictionHead :924-938)."""
    h = _transform(head_params["lm_transform"], lang_output, eps)
    return h @ word_embedding.T + head_params["lm_bias"]


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position softmax cross-entropy (optax's
    ``softmax_cross_entropy_with_integer_labels``), labels clipped at 0."""
    return F.cross_entropy(logits.flatten(0, -2),
                           labels.clamp(min=0).long().flatten(),
                           reduction="none").reshape(labels.shape)


def _masked_mean(per: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, per, torch.zeros_like(per)).sum() \
        / mask.sum().clamp(min=1)


def huber(pred: torch.Tensor, target: torch.Tensor, delta: float = 1.0
          ) -> torch.Tensor:
    """``optax.huber_loss``: ½·min(|e|, δ)² + δ·(|e| − min(|e|, δ))."""
    err = (pred - target).abs()
    quad = torch.minimum(err, torch.full_like(err, delta))
    return 0.5 * quad * quad + delta * (err - quad)


def pretrain_loss(
    params: Dict[str, Any],
    head_params: Dict[str, Any],
    batch: Dict[str, torch.Tensor],
    cfg: lx.LxmertConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Batch fields: input_ids, attention_mask, visual_feats, visual_pos,
    masked_lm_labels (-100 = unmasked), obj_labels [B, Sv] (-100 pad),
    feat_targets [B, Sv, feat_dim], feat_mask [B, Sv],
    matched_label [B] {0, 1}, ans [B] (-100 = no answer).
    Returns ``(total, {masked_lm, obj_predict, feat_regress, matched,
    qa})``."""
    eps = cfg.layer_norm_eps
    out = lx.forward(params, batch["input_ids"], batch["attention_mask"],
                     batch["visual_feats"], batch["visual_pos"], cfg=cfg)
    losses: Dict[str, torch.Tensor] = {}

    # masked LM
    lm = lm_logits(head_params, params["embeddings"]["word"],
                   out["lang_output"], eps)
    labels = batch["masked_lm_labels"]
    losses["masked_lm"] = _masked_mean(_ce(lm, labels), labels != -100)

    # visual object classification + feature regression
    h_obj = _transform(head_params["obj_transform"], out["visn_output"], eps)
    obj_logits = h_obj @ head_params["obj_decoder"]["w"] \
        + head_params["obj_decoder"]["b"]
    obj_labels = batch["obj_labels"]
    losses["obj_predict"] = _masked_mean(_ce(obj_logits, obj_labels),
                                         obj_labels != -100)

    feat_pred = h_obj @ head_params["feat_decoder"]["w"] \
        + head_params["feat_decoder"]["b"]
    l1 = huber(feat_pred, batch["feat_targets"]).sum(-1)
    fm = batch["feat_mask"]
    losses["feat_regress"] = (l1 * fm).sum() / fm.sum().clamp(min=1)

    # cross-modality matching (on the pooled CLS)
    match_logits = out["pooled"] @ head_params["matching"]["w"] \
        + head_params["matching"]["b"]
    losses["matched"] = _ce(match_logits, batch["matched_label"]).mean()

    # QA (only where an answer exists AND the pair is matched)
    ans = batch["ans"]
    qa_mask = (ans != -100) & (batch["matched_label"] == 1)
    losses["qa"] = _masked_mean(_ce(out["qa_scores"], ans), qa_mask)

    total = sum(losses.values())
    return total, losses
