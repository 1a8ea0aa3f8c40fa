"""The DETR LRP reverse pass (relprop), in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/detr_lrp.py``,
the reference chain DETR.relprop (models/detr.py:79-92: one-hot → class
head → transformer) → TransformerDecoder.relprop (transformer.py:166-198:
layers reversed, the per-layer memory cams merged by a Clone over memory)
→ TransformerEncoder.relprop (:104-111).

Per layer (transformer.py forward_post_relprop :255-276 encoder, :417-439
decoder) with the reference DETR MultiheadAttention relprop
(modules/layers.py:769-801):
  * out_proj α-β → the probs·value matmul split, halved → the attn cam;
  * softmax and dropout pass relevance through; NO mask-add relprop;
  * the q·kᵀ matmul split, halved: q carries the 1/√dh scaling INSIDE the
    matmul operand, so the q-side cam inherits it;
  * the q/k/v projections' α-β; the positional embeddings pass the cams
    through (WithPosEmbd.relprop is the identity, layers.py:107-108);
  * the value-collapse renormalisation (layers.py:786-799);
  * the Clone rule merges (q, k) and, in the encoder, the 3-way input
    clone; the decoder sums its three tgt cams (transformer.py:436-437).

**Batched over the explained queries.** The tape comes from ONE forward of
the image (``models/detr.forward(..., return_tape=True)``, B=1) and the
relevance seeds are ``[K, Q, C+1]``: each layer's forward is
rematerialised once at B=1 and broadcast against the K-batched cams, and
every sum of the rules is per query (``ops/lrp``), so each query gets what
the reference's one-query relprop gives. The tape is never expanded K
times (one ``[K, 8, S, S]`` fp32 tensor is 740 MB at K = 32, S = 850).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from transformer_mm_explainability_tpu_torch.models.detr import (
    DETRConfig,
    DETRTaps,
    _ffn_relu,
    _layer,
    _ln,
)
from transformer_mm_explainability_tpu_torch.ops import lrp
from transformer_mm_explainability_tpu_torch.ops.attention import (
    CrossAttentionParams,
    merge_heads,
    multi_head_cross_attention,
    split_heads,
)


def _all_zero(x: torch.Tensor) -> torch.Tensor:
    """``[N, ...]`` → ``[N, 1, 1]`` bool: is each example's tensor 0?"""
    return (x == 0).reshape(x.shape[0], -1).all(1).reshape(-1, 1, 1)


def mha_relprop(
    p: CrossAttentionParams,
    x_q: torch.Tensor, x_k: torch.Tensor, x_v: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor],
    R: torch.Tensor,
    alpha: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """DETR-variant attention relprop. Returns ``(cam_q_in, cam_k_in,
    cam_v_in, attn_cam [N, H, Sq, Sk])``."""
    H = num_heads
    # rematerialise with the reference's operand layout: q pre-scaled
    q = split_heads(x_q @ p.w_q + p.b_q, H)
    q = q * q.shape[-1] ** -0.5
    k = split_heads(x_k @ p.w_k + p.b_k, H)
    v = split_heads(x_v @ p.w_v + p.b_v, H)
    kT = k.transpose(-1, -2)
    scores = q @ kT
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, -1)
    ctx = merge_heads(probs @ v)

    cam_out = lrp.linear_alpha_beta(R, ctx, p.w_out, alpha)
    cam_probs, cam_v = lrp.matmul_relprop(probs, v, split_heads(cam_out, H))
    # softmax / dropout: identity; the reference skips the mask add here
    cam_q, cam_kT = lrp.matmul_relprop(q, kT, cam_probs)
    cam_q_in = lrp.linear_alpha_beta(merge_heads(cam_q), x_q, p.w_q, alpha)
    cam_k_in = lrp.linear_alpha_beta(merge_heads(cam_kT.transpose(-1, -2)),
                                     x_k, p.w_k, alpha)
    cam_v = merge_heads(cam_v)
    pre_zero = _all_zero(cam_v)
    cam_v_in = lrp.linear_alpha_beta(cam_v, x_v, p.w_v, alpha)

    # value collapse (layers.py:786-799): where the value cam becomes all
    # zero in its projection (and was not before), the attention output's
    # relevance is redistributed onto q and k, per example
    collapse = _all_zero(cam_v_in) & ~pre_zero
    k_sum, q_sum = lrp.example_sum(cam_k_in), lrp.example_sum(cam_q_in)
    tot = k_sum.abs() + q_sum.abs()
    R_total = lrp.example_sum(cam_out)  # the reference's cam_attn_output
    k_fact = lrp.safe_divide(k_sum.abs(), tot) * R_total
    q_fact = lrp.safe_divide(q_sum.abs(), tot) * R_total
    cam_k_in = torch.where(collapse,
                           cam_k_in * lrp.safe_divide(k_fact, k_sum),
                           cam_k_in)
    cam_q_in = torch.where(collapse,
                           cam_q_in * lrp.safe_divide(q_fact, q_sum),
                           cam_q_in)
    return cam_q_in, cam_k_in, cam_v_in, cam_probs


def _enc_layer_relprop(p, x_in, pos, mask, R, alpha, H):
    """Encoder layer reversed (forward_post_relprop :255-276): ``(R_in,
    attn_cam)``."""
    qk = x_in + pos
    attn_out, _ = multi_head_cross_attention(p["self_attn"], qk, qk, H,
                                             mask=mask, x_v=x_in)
    x1 = _ln(x_in + attn_out, p["norm1"])
    ffn_out = _ffn_relu(p["ffn"], x1)

    # norm2: identity
    cam_res2, cam_ffn = lrp.add_relprop(x1, ffn_out, R)
    h1 = torch.relu(x1 @ p["ffn"]["w1"] + p["ffn"]["b1"])
    cam_h1 = lrp.linear_alpha_beta(cam_ffn, h1, p["ffn"]["w2"], alpha)
    cam_x1a = lrp.linear_alpha_beta(cam_h1, x1, p["ffn"]["w1"], alpha)
    cam_x1 = lrp.clone_relprop(x1, [cam_x1a, cam_res2])
    # norm1: identity
    cam_res1, cam_attn = lrp.add_relprop(x_in, attn_out, cam_x1)
    cam_q, cam_k, cam_v, attn_cam = mha_relprop(
        p["self_attn"], qk, qk, x_in, H, mask, cam_attn, alpha)
    cam_webmd = lrp.clone_relprop(qk, [cam_q, cam_k])
    # WithPosEmbd: identity, so the (q, k) cam goes to the src stream
    return lrp.clone_relprop(x_in, [cam_webmd, cam_v, cam_res1]), attn_cam


def _dec_layer_relprop(p, tgt_in, memory, pos, query_pos, mask, R, alpha,
                       H):
    """Decoder layer reversed (:417-439): ``(R_tgt_in, cam_memory,
    self_cam, cross_cam)``."""
    qk = tgt_in + query_pos
    self_out, _ = multi_head_cross_attention(p["self_attn"], qk, qk, H,
                                             x_v=tgt_in)
    t1 = _ln(tgt_in + self_out, p["norm1"])
    q2 = t1 + query_pos
    k2 = memory + pos
    cross_out, _ = multi_head_cross_attention(p["cross_attn"], q2, k2, H,
                                              mask=mask, x_v=memory)
    t2 = _ln(t1 + cross_out, p["norm2"])
    ffn_out = _ffn_relu(p["ffn"], t2)

    # norm3: identity
    cam_res3, cam_ffn = lrp.add_relprop(t2, ffn_out, R)
    h1 = torch.relu(t2 @ p["ffn"]["w1"] + p["ffn"]["b1"])
    cam_h1 = lrp.linear_alpha_beta(cam_ffn, h1, p["ffn"]["w2"], alpha)
    cam_t2a = lrp.linear_alpha_beta(cam_h1, t2, p["ffn"]["w1"], alpha)
    cam_t2 = lrp.clone_relprop(t2, [cam_t2a, cam_res3])
    # norm2: identity
    cam_res2, cam_cross = lrp.add_relprop(t1, cross_out, cam_t2)
    cam_q, cam_k, cam_mem_v, cross_cam = mha_relprop(
        p["cross_attn"], q2, k2, memory, H, mask, cam_cross, alpha)
    cam_memory = lrp.clone_relprop(memory, [cam_k, cam_mem_v])
    cam_t1 = lrp.clone_relprop(t1, [cam_q, cam_res2])
    # norm1: identity
    cam_res1, cam_self = lrp.add_relprop(tgt_in, self_out, cam_t1)
    cam_sq, cam_sk, cam_sv, self_cam = mha_relprop(
        p["self_attn"], qk, qk, tgt_in, H, None, cam_self, alpha)
    cam_webmd = lrp.clone_relprop(qk, [cam_sq, cam_sk])
    # the reference sums the three tgt streams (transformer.py:437)
    return cam_webmd + cam_sv + cam_res1, cam_memory, self_cam, cross_cam


def _class_head_relprop(params, hs, one_hot, alpha):
    return lrp.linear_alpha_beta(one_hot.to(hs.dtype), hs,
                                 params["class_embed"]["w"], alpha)


def relprop(
    params: Dict[str, Any],
    tape: Dict[str, Any],
    hs: torch.Tensor,                   # [B, Q, D] the decoder output
    one_hot: torch.Tensor,              # [N, Q, C+1]
    cfg: DETRConfig,
    mask: Optional[torch.Tensor] = None,
    alpha: float = 1.0,
) -> Tuple[torch.Tensor, DETRTaps]:
    """The full DETR relprop → ``(cam at the encoder input [N, S, D], the
    attn cams of all three families, leaves [L, N, H, ...])``. The tape
    and ``hs`` hold B = N examples, or one (B = 1) shared by the N seeds;
    ``mask`` is the forward's key-padding bias (``[B, 1, 1, S]``)."""
    cam_hs = _class_head_relprop(params, hs, one_hot, alpha)
    return relprop_from_hs(params, tape, cam_hs, cfg, mask, alpha)


def relprop_from_hs(
    params: Dict[str, Any],
    tape: Dict[str, Any],
    cam_hs: torch.Tensor,               # [N, Q, D]
    cfg: DETRConfig,
    mask: Optional[torch.Tensor] = None,
    alpha: float = 1.0,
) -> Tuple[torch.Tensor, DETRTaps]:
    """The transformer's relprop given the relevance of hs."""
    H = cfg.nheads
    # decoder_norm: identity
    memory, pos, query_pos = tape["memory"], tape["pos"], tape["query_pos"]
    n_dec, n_enc = tape["dec"].shape[0], tape["enc"].shape[0]
    cam_mems, dec_self, dec_cross = ([None] * n_dec for _ in range(3))
    cam = cam_hs
    for i in reversed(range(n_dec)):
        cam, cam_mems[i], dec_self[i], dec_cross[i] = _dec_layer_relprop(
            _layer(params["decoder"], i), tape["dec"][i], memory, pos,
            query_pos, mask, cam, alpha, H)
    # the Clone over memory merges the per-layer memory cams
    cam = lrp.clone_relprop(memory, cam_mems)
    enc = [None] * n_enc
    for i in reversed(range(n_enc)):
        cam, enc[i] = _enc_layer_relprop(_layer(params["encoder"], i),
                                         tape["enc"][i], pos, mask, cam,
                                         alpha, H)
    return cam, DETRTaps(enc_self=torch.stack(enc),
                         dec_self=torch.stack(dec_self),
                         dec_cross=torch.stack(dec_cross))


def last_cross_cam(
    params: Dict[str, Any],
    tape: Dict[str, Any],
    hs: torch.Tensor,
    one_hot: torch.Tensor,
    cfg: DETRConfig,
    mask: Optional[torch.Tensor] = None,
    alpha: float = 1.0,
) -> torch.Tensor:
    """The last decoder cross-attention's cam ``[N, H, Q, S]`` alone: the
    first cam the reversed walk reaches, equal to ``relprop``'s
    ``dec_cross[-1]``, without the walk through the other layers. It is
    all that ``transformer_att`` and ``partial_lrp`` read."""
    last = tape["dec"].shape[0] - 1
    return _dec_layer_relprop(
        _layer(params["decoder"], last), tape["dec"][last], tape["memory"],
        tape["pos"], tape["query_pos"], mask,
        _class_head_relprop(params, hs, one_hot, alpha), alpha,
        cfg.nheads)[3]
