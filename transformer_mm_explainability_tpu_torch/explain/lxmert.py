"""LXMERT bi-modal explanation generators, batched, in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/explain/lxmert.py``
(the reference's ``GeneratorOurs.generate_ours``, the no-aggregation
ablation and the baselines). The JAX functions run one example under
``jax.vmap``; here every function takes the batch as it comes, captures
``[L, B, H, Sq, Sk]``, and carries ``[B, ...]`` relevancy matrices through
the batched rules of ``ops/relevancy`` with no loop over examples.

Propagation order of ``generate_ours`` (the reference's):
  1. language self-attention layers  → rules 6+7 on (R_tt, R_ti)
  2. visual self-attention layers    → rules 6+7 on (R_ii, R_it)
  3. x-layers 0..L-2: both cross-attentions (rules 10+11, from the
     PRE-update R's), then language self, then visual self
  4. last x-layer: text side only (the CLS lives in the language stream)
  5. zero R_tt[0, 0] (the CLS self-relevancy)
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from transformer_mm_explainability_tpu_torch.models.lxmert import LxmertTaps
from transformer_mm_explainability_tpu_torch.ops import relevancy as rl

Maps = Tuple[torch.Tensor, torch.Tensor]


class BiModalState(NamedTuple):
    R_t_t: torch.Tensor
    R_t_i: torch.Tensor
    R_i_i: torch.Tensor
    R_i_t: torch.Tensor


def _eye(B: int, n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(
        B, n, n).clone()


def _zero_cls(R_t_t: torch.Tensor) -> torch.Tensor:
    R_t_t = R_t_t.clone()
    R_t_t[:, 0, 0] = 0.0
    return R_t_t


def _ours(attn: LxmertTaps, grads: LxmertTaps,
          normalize_self_attention: bool = True,
          apply_self_in_rule_10: bool = True, aggregate: bool = True,
          text_valid: Optional[torch.Tensor] = None,
          visual_valid: Optional[torch.Tensor] = None) -> Maps:
    """The bi-modal propagation, batched. ``text_valid`` ``[B, St]`` /
    ``visual_valid`` ``[B, Sv]`` mark real tokens / boxes: padded rows of R
    stay identity rows whose eq. 8+9 division is 0/0, and one of them would
    NaN-poison the map through the rule-10 products, so the masks pin them
    to identity (``ops/relevancy.handle_residual``)."""
    B, St, Sv = attn.lang.shape[1], attn.lang.shape[-1], attn.visn.shape[-1]
    s = BiModalState(R_t_t=_eye(B, St, attn.lang),
                     R_t_i=attn.lang.new_zeros((B, St, Sv)),
                     R_i_i=_eye(B, Sv, attn.lang),
                     R_i_t=attn.lang.new_zeros((B, Sv, St)))

    def self_update(R_ss, R_sq, cam, grad):
        add_ss, add_sq = rl.apply_self_attention_rules(
            R_ss, R_sq, rl.avg_heads(cam, grad))
        if aggregate:
            return R_ss + add_ss, R_sq + add_sq
        return add_ss, add_sq

    def mm_update(R_ss, R_qq, R_qs, cam, grad, s_valid, q_valid):
        return rl.apply_mm_attention_rules(
            R_ss, R_qq, rl.avg_heads(cam, grad), R_qs=R_qs,
            apply_normalization=normalize_self_attention,
            apply_self_in_rule_10=apply_self_in_rule_10,
            s_valid=s_valid, q_valid=q_valid)

    # 1. language stack, 2. visual stack
    for cam, grad in zip(attn.lang, grads.lang):
        R_t_t, R_t_i = self_update(s.R_t_t, s.R_t_i, cam, grad)
        s = s._replace(R_t_t=R_t_t, R_t_i=R_t_i)
    for cam, grad in zip(attn.visn, grads.visn):
        R_i_i, R_i_t = self_update(s.R_i_i, s.R_i_t, cam, grad)
        s = s._replace(R_i_i=R_i_i, R_i_t=R_i_t)

    # 3. cross-modal layers except the last
    Lx = attn.x_lang_cross.shape[0]
    for i in range(Lx - 1):
        R_t_i_add, R_t_t_add = mm_update(
            s.R_t_t, s.R_i_i, s.R_i_t, attn.x_lang_cross[i],
            grads.x_lang_cross[i], text_valid, visual_valid)
        R_i_t_add, R_i_i_add = mm_update(
            s.R_i_i, s.R_t_t, s.R_t_i, attn.x_visn_cross[i],
            grads.x_visn_cross[i], visual_valid, text_valid)
        if aggregate:
            s = BiModalState(R_t_t=s.R_t_t + R_t_t_add,
                             R_t_i=s.R_t_i + R_t_i_add,
                             R_i_i=s.R_i_i + R_i_i_add,
                             R_i_t=s.R_i_t + R_i_t_add)
        else:
            s = BiModalState(R_t_t=R_t_t_add, R_t_i=R_t_i_add,
                             R_i_i=R_i_i_add, R_i_t=R_i_t_add)
        R_t_t, R_t_i = self_update(s.R_t_t, s.R_t_i, attn.x_lang_self[i],
                                   grads.x_lang_self[i])
        s = s._replace(R_t_t=R_t_t, R_t_i=R_t_i)
        R_i_i, R_i_t = self_update(s.R_i_i, s.R_i_t, attn.x_visn_self[i],
                                   grads.x_visn_self[i])
        s = s._replace(R_i_i=R_i_i, R_i_t=R_i_t)

    # 4. last x-layer: text side only
    R_t_i_add, R_t_t_add = mm_update(
        s.R_t_t, s.R_i_i, s.R_i_t, attn.x_lang_cross[-1],
        grads.x_lang_cross[-1], text_valid, visual_valid)
    if aggregate:
        s = s._replace(R_t_t=s.R_t_t + R_t_t_add, R_t_i=s.R_t_i + R_t_i_add)
    else:
        s = s._replace(R_t_t=R_t_t_add, R_t_i=R_t_i_add)
    R_t_t, R_t_i = self_update(s.R_t_t, s.R_t_i, attn.x_lang_self[-1],
                               grads.x_lang_self[-1])
    # 5. CLS self-relevancy masked out
    return _zero_cls(R_t_t), R_t_i


def generate_ours(attn: LxmertTaps, grads: LxmertTaps,
                  normalize_self_attention: bool = True,
                  apply_self_in_rule_10: bool = True,
                  text_valid=None, visual_valid=None) -> Maps:
    """Batched ``(R_t_t [B, St, St], R_t_i [B, St, Sv])``. ``text_valid``
    ``[B, St]`` / ``visual_valid`` ``[B, Sv]`` mark the real positions of
    padded batches."""
    return _ours(attn, grads, normalize_self_attention,
                 apply_self_in_rule_10, True, text_valid, visual_valid)


def generate_ours_no_agg(attn: LxmertTaps, grads: LxmertTaps,
                         normalize_self_attention: bool = True,
                         text_valid=None, visual_valid=None) -> Maps:
    """The no-aggregation ablation (overwrites instead of +=)."""
    return _ours(attn, grads, normalize_self_attention, True, False,
                 text_valid, visual_valid)


def generate_raw_attn(attn: LxmertTaps) -> Maps:
    """Head mean of the last x-layer's attentions."""
    R_t_i = attn.x_lang_cross[-1].mean(dim=1)
    R_t_t = attn.x_lang_self[-1].mean(dim=1)
    return _zero_cls(R_t_t), R_t_i


def generate_attn_gradcam(attn: LxmertTaps, grads: LxmertTaps) -> Maps:
    """GradCAM on the last x-layer."""
    R_t_i = rl.grad_cam(attn.x_lang_cross[-1], grads.x_lang_cross[-1])
    R_t_t = rl.grad_cam(attn.x_lang_self[-1], grads.x_lang_self[-1])
    return _zero_cls(R_t_t), R_t_i


def generate_ours_lrp(cams: LxmertTaps, grads: LxmertTaps,
                      normalize_self_attention: bool = True,
                      apply_self_in_rule_10: bool = True,
                      text_valid=None, visual_valid=None) -> Maps:
    """'ours' with use_lrp=True: the same propagation, Ê built from the
    relprop cams instead of the attention probabilities."""
    return generate_ours(cams, grads, normalize_self_attention,
                         apply_self_in_rule_10, text_valid, visual_valid)


def _minmax(x: torch.Tensor) -> torch.Tensor:
    lo = x.amin(dim=(-2, -1), keepdim=True)
    hi = x.amax(dim=(-2, -1), keepdim=True)
    return (x - lo) / (hi - lo)


def generate_partial_lrp(cams: LxmertTaps) -> Maps:
    """Head mean of the last x-layer's LRP cams, min-max normalised."""
    R_t_i = _minmax(cams.x_lang_cross[-1].mean(dim=1))
    R_t_t = _minmax(cams.x_lang_self[-1].mean(dim=1))
    return _zero_cls(R_t_t), R_t_i


def generate_transformer_att(cams: LxmertTaps, grads: LxmertTaps) -> Maps:
    """Chefer-2020 transformer-attribution baseline: grad⊙LRP-cam rollout
    over the language stream (no cross-modal coupling), bridged by the
    last x-layer's cross cam."""
    B, St = cams.lang.shape[1], cams.lang.shape[-1]
    R_t_t = _eye(B, St, cams.lang)
    chain = zip(torch.cat([cams.lang, cams.x_lang_self[:-1]]),
                torch.cat([grads.lang, grads.x_lang_self[:-1]]))
    for cam, grad in chain:
        R_t_t = R_t_t + rl.avg_heads(cam, grad) @ R_t_t
    R_t_i = rl.avg_heads(cams.x_lang_cross[-1], grads.x_lang_cross[-1])
    R_t_t = R_t_t + rl.avg_heads(cams.x_lang_self[-1],
                                 grads.x_lang_self[-1]) @ R_t_t
    return _zero_cls(R_t_t), R_t_i


def generate_rollout(attn: LxmertTaps) -> Maps:
    """Rollout baseline: text and image rollouts over the self stacks and
    the x-layers' self layers, bridged by the last cross attention."""
    heads = lambda a: a.mean(dim=2).movedim(0, 1)        # → [B, L, Sq, Sk]
    cams_text = torch.cat([heads(attn.lang), heads(attn.x_lang_self)], 1)
    cams_image = torch.cat([heads(attn.visn),
                            heads(attn.x_visn_self[:-1])], 1)
    cam_t_i = attn.x_lang_cross[-1].mean(dim=1)
    # the reference computes R_t_t without the last x self layer, R_i_i,
    # the bridge, then R_t_t again with the last x-layer's self attention
    R_t_t_partial = rl.compute_rollout_attention(cams_text[:, :-1])
    R_i_i = rl.compute_rollout_attention(cams_image)
    R_t_i = R_t_t_partial.transpose(-1, -2) @ (cam_t_i @ R_i_i)
    R_t_t = rl.compute_rollout_attention(cams_text)
    return _zero_cls(R_t_t), R_t_i
