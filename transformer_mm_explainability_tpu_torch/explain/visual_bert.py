"""VisualBERT explanation generators (single-stream self-attention), in
PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/explain/visual_bert.py``
(the reference's ``SelfAttentionGenerator``):

  ours            — R = I; per layer R += Ê @ R; CLS row
  raw_attn        — head mean of the last layer's attention
  rollout         — un-normalised rollout of the head means
  attn_gradcam    — gradient-weighted last-layer head mean, min-max
  transformer_att — grad-weighted LRP-cam rollout
  partial_lrp     — last-layer LRP cam, min-max

Every method takes the ``[L, B, H, S, S]`` capture of
``models.visual_bert.capture`` (and the LRP ones the cams of
``models.visual_bert.relprop``) as it comes (the JAX functions run one
example under ``jax.vmap``; the rules of ``ops/relevancy`` take the batch
axis here), and returns the ``[B, S]`` row of the "CLS" token, the ``?``
at ``input_mask.sum(1) - 2``, with that position zeroed.
"""

from __future__ import annotations

import torch

from transformer_mm_explainability_tpu_torch.ops import relevancy as rl

def _cls_row(R: torch.Tensor, cls_index: torch.Tensor) -> torch.Tensor:
    """Row ``cls_index`` of each example's ``[S, S]`` matrix, with the CLS
    column zeroed."""
    B, S = R.shape[0], R.shape[-1]
    ci = cls_index.long().to(R.device)
    row = R[torch.arange(B, device=R.device), ci]
    keep = torch.arange(S, device=R.device)[None, :] != ci[:, None]
    # a select, as XLA makes of the JAX package's multiply: a NaN row (the
    # min-max of a constant cam) still reads 0 at the CLS position
    return torch.where(keep, row, torch.zeros_like(row))


def _min_max(cam: torch.Tensor) -> torch.Tensor:
    """Per-example min-max normalisation of ``[B, S, S]``."""
    lo = cam.amin(dim=(1, 2), keepdim=True)
    hi = cam.amax(dim=(1, 2), keepdim=True)
    return (cam - lo) / (hi - lo)


def generate_ours(attn: torch.Tensor, grads: torch.Tensor,
                  cls_index: torch.Tensor) -> torch.Tensor:
    """attn / grads ``[L, B, H, S, S]``; cls_index ``[B]`` → ``[B, S]``."""
    R = rl.self_attention_relevancy(attn.movedim(1, 0), grads.movedim(1, 0))
    return _cls_row(R, cls_index)


def generate_transformer_att(cams_lrp: torch.Tensor, grads: torch.Tensor,
                             cls_index: torch.Tensor,
                             start_layer: int = 0) -> torch.Tensor:
    """Grad-weighted LRP-cam rollout; ``cams_lrp`` ``[L, B, H, S, S]``
    relprop cams. The VisualBERT copy of ``compute_rollout_attention``
    has its row normalisation commented out (ExplanationGenerator.py:
    11-13), so this is the bare ∏(I+Ê) chain."""
    e = rl.avg_heads(cams_lrp, grads).movedim(1, 0)      # [B, L, S, S]
    R = rl.compute_rollout_attention(e, start_layer=start_layer,
                                     normalize=False)
    return _cls_row(R, cls_index)


def generate_partial_lrp(cams_lrp: torch.Tensor,
                         cls_index: torch.Tensor) -> torch.Tensor:
    """Head mean of the LAST layer's LRP cam, min-max normalised
    (ExplanationGenerator.py:109-131)."""
    return _cls_row(_min_max(cams_lrp[-1].mean(dim=1)), cls_index)


def generate_raw_attn(attn: torch.Tensor,
                      cls_index: torch.Tensor) -> torch.Tensor:
    """Head mean of the last layer's attention."""
    return _cls_row(attn[-1].mean(dim=1), cls_index)


def generate_rollout(attn: torch.Tensor, cls_index: torch.Tensor,
                     start_layer: int = 0) -> torch.Tensor:
    """Rollout of per-layer head means WITHOUT row normalisation (the
    reference's VisualBERT copy skips it)."""
    means = attn.mean(dim=2).movedim(1, 0)             # [B, L, S, S]
    R = rl.compute_rollout_attention(means, start_layer=start_layer,
                                     normalize=False)
    return _cls_row(R, cls_index)


def generate_attn_gradcam(attn: torch.Tensor, grads: torch.Tensor,
                          cls_index: torch.Tensor) -> torch.Tensor:
    """GradCAM on the last layer, min-max normalised."""
    return _cls_row(_min_max(rl.grad_cam(attn[-1], grads[-1])), cls_index)


METHODS_FROM_CAPTURE = {
    "ours_no_lrp": generate_ours,
    "raw_attn": lambda attn, grads, cls: generate_raw_attn(attn, cls),
    "rollout": lambda attn, grads, cls: generate_rollout(attn, cls),
    "attn_gradcam": generate_attn_gradcam,
}
