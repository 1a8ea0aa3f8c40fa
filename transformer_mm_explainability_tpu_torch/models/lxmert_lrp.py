"""The LXMERT LRP reverse pass (relprop), in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/lxmert_lrp.py``,
the reference's model-level chain (lxmert_lrp.py):
  LxmertForQuestionAnswering.relprop (:1688-1692): answer head → cam_vis
  seeded at 0 → pooler (IndexSelect on the CLS) → LxmertEncoder.relprop
  (:855-865): x-layers reversed → relational layers reversed → language
  layers reversed.
  LxmertXLayer.relprop (:735-741): output FFNs → self attentions → cross
  attentions (both directions share weights; a clone merges them).

Activations are rematerialised from the tape of
``models/lxmert.forward(..., return_tape=True)``. It returns the attention
cams of all six families (the ``get_attn_cam()`` captures that the
use_lrp / partial_lrp / transformer_att generators read). Every sum of the
rules is per example (``ops/lrp``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from transformer_mm_explainability_tpu_torch.models import bert_lrp
from transformer_mm_explainability_tpu_torch.models.bert import unstack
from transformer_mm_explainability_tpu_torch.models.lxmert import (
    LxmertConfig,
    LxmertTaps,
)
from transformer_mm_explainability_tpu_torch.ops import lrp
from transformer_mm_explainability_tpu_torch.ops.attention import (
    CrossAttentionParams,
    gelu,
    layer_norm,
    multi_head_cross_attention,
)


def _attn_parts(p: CrossAttentionParams):
    return p.w_q, p.b_q, p.w_k, p.b_k, p.w_v, p.b_v, p.w_out, p.b_out


def _attn_block_forward(p_attn, p_ln, x_q, x_kv, H, mask, eps):
    out, _ = multi_head_cross_attention(p_attn, x_q, x_kv, H, mask=mask)
    return layer_norm(x_q + out, p_ln["scale"], p_ln["bias"], eps), out


def _attn_block_relprop(p_attn, x_q, x_kv, H, mask, attn_out_pre_res, R,
                        alpha, self_attention):
    """Reverse (attention + residual + LN): ``(cam of the query stream,
    the residual merged; cam_ctx or None; attn_cam)``."""
    cam_att, cam_res = lrp.add_relprop(attn_out_pre_res, x_q, R)
    cam_q, cam_ctx, attn_cam = bert_lrp.attention_relprop(
        *_attn_parts(p_attn), x_q, x_kv, H, mask, cam_att, alpha,
        uniform=True, self_attention=self_attention)
    cam_stream = lrp.clone_relprop(x_q, [cam_q, cam_res])
    return cam_stream, None if self_attention else cam_ctx, attn_cam


def _ffn_relprop(p, x_in, R, alpha):
    """Reverse (dense → GELU → dense + residual + LN) given its input."""
    g1 = gelu(x_in @ p["w1"] + p["b1"])
    ffn_out = g1 @ p["w2"] + p["b2"]
    cam_ffn, cam_res = lrp.add_relprop(ffn_out, x_in, R)
    cam_g1 = lrp.linear_alpha_beta(cam_ffn, g1, p["w2"], alpha)
    cam_in = lrp.linear_alpha_beta(cam_g1, x_in, p["w1"], alpha)
    return lrp.clone_relprop(x_in, [cam_in, cam_res])


def _x_layer_relprop(p, lang_in, visn_in, cam_lang, cam_vis, lang_mask,
                     visn_mask, H, eps, alpha):
    """One cross-modality layer reversed: ``(cam_lang, cam_vis, (lc, vc,
    ls, vs) cams)``."""
    # rematerialise the layer's inner streams
    lang1, cross_out_l = _attn_block_forward(
        p["cross"], p["cross_ln_lang"], lang_in, visn_in, H, visn_mask, eps)
    visn1, cross_out_v = _attn_block_forward(
        p["cross"], p["cross_ln_visn"], visn_in, lang_in, H, lang_mask, eps)
    lang2, self_out_l = _attn_block_forward(
        p["lang_self"], p["lang_self_ln"], lang1, lang1, H, lang_mask, eps)
    visn2, self_out_v = _attn_block_forward(
        p["visn_self"], p["visn_self_ln"], visn1, visn1, H, visn_mask, eps)

    # the FFNs (relprop_output, :691-700)
    cam_lang = _ffn_relprop(p["lang_ffn"], lang2, cam_lang, alpha)
    cam_vis = _ffn_relprop(p["visn_ffn"], visn2, cam_vis, alpha)
    # the self attentions (:676-680)
    cam_lang, _, cam_ls = _attn_block_relprop(
        p["lang_self"], lang1, lang1, H, lang_mask, self_out_l, cam_lang,
        alpha, self_attention=True)
    cam_vis, _, cam_vs = _attn_block_relprop(
        p["visn_self"], visn1, visn1, H, visn_mask, self_out_v, cam_vis,
        alpha, self_attention=True)
    # the cross attentions (:712-719): the visual side (the copy) first,
    # then the language side
    cam_vis_stream, cam_lang_ctx, cam_vc = _attn_block_relprop(
        p["cross"], visn_in, lang_in, H, lang_mask, cross_out_v, cam_vis,
        alpha, self_attention=False)
    cam_lang_stream, cam_vis_ctx, cam_lc = _attn_block_relprop(
        p["cross"], lang_in, visn_in, H, visn_mask, cross_out_l, cam_lang,
        alpha, self_attention=False)
    cam_lang = lrp.clone_relprop(lang_in, [cam_lang_stream, cam_lang_ctx])
    cam_vis = lrp.clone_relprop(visn_in, [cam_vis_stream, cam_vis_ctx])
    return cam_lang, cam_vis, (cam_lc, cam_vc, cam_ls, cam_vs)


def relprop(
    params: Dict[str, Any],
    tape: Dict[str, Any],
    one_hot: torch.Tensor,            # [B, num_qa_labels]
    lang_mask: Optional[torch.Tensor],
    visn_mask: Optional[torch.Tensor],
    cfg: LxmertConfig,
    alpha: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, LxmertTaps]:
    """Returns ``(cam_lang [B, St, D], cam_vis [B, Sv, D], the attention
    cams of all six families as an LxmertTaps)``."""
    H = cfg.num_attention_heads
    eps = cfg.layer_norm_eps

    # --- answer head (Linear → GELU → LN → Linear reversed; :941-960) ---
    ah = params["answer_head"]
    lang_final = tape["lang_final"]
    pooled = torch.tanh(lang_final[:, 0] @ params["pooler"]["w"]
                        + params["pooler"]["b"])
    g1 = layer_norm(gelu(pooled @ ah["w1"] + ah["b1"]), ah["ln"]["scale"],
                    ah["ln"]["bias"], eps)
    cam = lrp.linear_alpha_beta(one_hot.to(g1.dtype), g1, ah["w2"], alpha)
    cam = lrp.linear_alpha_beta(cam, pooled, ah["w1"], alpha)

    # --- pooler (dense + IndexSelect on token 0; :868-888) ---------------
    cam = lrp.linear_alpha_beta(cam, lang_final[:, 0], params["pooler"]["w"],
                                alpha)
    cam_lang = torch.zeros_like(lang_final)
    cam_lang[:, 0] = cam
    cam_vis = torch.zeros_like(tape["visn_final"])

    # --- x-layers reversed -----------------------------------------------
    lang_tape_x, visn_tape_x = tape["x"]
    n_x = lang_tape_x.shape[0]
    x_cams = [None] * n_x
    for i in reversed(range(n_x)):
        cam_lang, cam_vis, x_cams[i] = _x_layer_relprop(
            unstack(params["x_layers"], i), lang_tape_x[i], visn_tape_x[i],
            cam_lang, cam_vis, lang_mask, visn_mask, H, eps, alpha)
    x_lc, x_vc, x_ls, x_vs = (torch.stack(c) for c in zip(*x_cams))

    # --- relational (visual) stack reversed ------------------------------
    r_cfg = dataclasses.replace(cfg.bert, num_hidden_layers=cfg.r_layers)
    cam_vis, visn_cams = bert_lrp.bert_encoder_relprop(
        params["visn_layers"], tape["visn"], visn_mask, cam_vis, r_cfg,
        alpha)

    # --- language stack reversed -----------------------------------------
    cam_lang, lang_cams = bert_lrp.bert_encoder_relprop(
        params["lang_layers"], tape["lang"], lang_mask, cam_lang, cfg.bert,
        alpha)

    cams = LxmertTaps(lang=lang_cams, visn=visn_cams, x_lang_cross=x_lc,
                      x_visn_cross=x_vc, x_lang_self=x_ls, x_visn_self=x_vs)
    return cam_lang, cam_vis, cams
