"""LRP reverse pass for the BERT encoder family (VisualBERT, LXMERT's
single-modality stacks), in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/bert_lrp.py``
(the reference's BERT_ours.py: BertEncoder.relprop :152-156,
BertLayer.relprop :505-516, BertSelfAttention.relprop :354-394). The
reverse pass is a Python loop over the layers, last first, that
rematerialises each layer's internals from its taped input
(``models/bert.encoder(..., return_tape=True)``) and applies the rules of
``ops/lrp``. Beside the relevance it returns every layer's attention cam
(the reference's ``get_attn_cam()``), which the explanation generators
read.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from transformer_mm_explainability_tpu_torch.models.bert import (
    BertConfig,
    unstack,
)
from transformer_mm_explainability_tpu_torch.ops import lrp
from transformer_mm_explainability_tpu_torch.ops.attention import (
    AttentionParams,
    gelu,
    layer_norm,
    merge_heads,
    split_heads,
)


class _Attention(NamedTuple):
    """One attention's rematerialised internals."""

    q: torch.Tensor        # [B, H, Sq, dh]
    kT: torch.Tensor       # [B, H, dh, Sk]
    v: torch.Tensor        # [B, H, Sk, dh]
    scores: torch.Tensor   # q kᵀ / √dh, before the mask
    probs: torch.Tensor
    ctx: torch.Tensor      # [B, Sq, D], heads merged


def _attention_forward(w_q, b_q, w_k, b_k, w_v, b_v, x_q, x_ctx,
                       num_heads: int, mask: Optional[torch.Tensor]
                       ) -> _Attention:
    q = split_heads(x_q @ w_q + b_q, num_heads)
    k = split_heads(x_ctx @ w_k + b_k, num_heads)
    v = split_heads(x_ctx @ w_v + b_v, num_heads)
    kT = k.transpose(-1, -2)
    scores = (q @ kT) / math.sqrt(q.shape[-1])
    probs = torch.softmax(scores if mask is None else scores + mask, -1)
    return _Attention(q, kT, v, scores, probs, merge_heads(probs @ v))


def _attention_relprop(fwd: _Attention, w_q, w_k, w_v, w_out, x_q, x_ctx,
                       num_heads: int, mask: Optional[torch.Tensor],
                       R: torch.Tensor, alpha: float, uniform: bool,
                       self_attention: bool):
    cam = split_heads(lrp.linear_alpha_beta(R, fwd.ctx, w_out, alpha,
                                            uniform), num_heads)
    cam_probs, cam_v = lrp.matmul_relprop(fwd.probs, fwd.v, cam)
    attn_cam = cam_probs
    # dropout, softmax: identity
    if mask is not None:
        cam_probs, _ = lrp.add_relprop(fwd.scores, mask, cam_probs)
    cam_q, cam_kT = lrp.matmul_relprop(fwd.q, fwd.kT, cam_probs)
    cam_q = lrp.linear_alpha_beta(merge_heads(cam_q), x_q, w_q, alpha,
                                  uniform)
    cam_k = lrp.linear_alpha_beta(merge_heads(cam_kT.transpose(-1, -2)),
                                  x_ctx, w_k, alpha, uniform)
    cam_v = lrp.linear_alpha_beta(merge_heads(cam_v), x_ctx, w_v, alpha,
                                  uniform)
    if self_attention:
        # self-attention: 3-way clone of the input (BERT_ours.py:304)
        cam_x = lrp.clone_relprop(x_q, [cam_q, cam_k, cam_v])
        return cam_x, cam_x, attn_cam
    # cross: the context cloned into key and value (lxmert_lrp.py:386-391)
    return cam_q, lrp.clone_relprop(x_ctx, [cam_k, cam_v]), attn_cam


def attention_relprop(
    w_q, b_q, w_k, b_k, w_v, b_v, w_out, b_out,
    x_q: torch.Tensor,
    x_ctx: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor],
    R: torch.Tensor,
    alpha: float = 1.0,
    uniform: bool = True,
    self_attention: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Relprop through one attention (self if ``x_q is x_ctx``, else
    cross). ``R`` is the relevance of the attention's dense output
    ``[B, S_q, D]``. Returns ``(cam_x_q, cam_x_ctx, attn_cam [B, H, S_q,
    S_k])``: BertSelfAttention.relprop / LxmertAttention.relprop (matmul
    halving, the mask-add split, clone sums)."""
    fwd = _attention_forward(w_q, b_q, w_k, b_k, w_v, b_v, x_q, x_ctx,
                             num_heads, mask)
    return _attention_relprop(fwd, w_q, w_k, w_v, w_out, x_q, x_ctx,
                              num_heads, mask, R, alpha, uniform,
                              self_attention)


def _split_qkv(p: AttentionParams):
    wq, wk, wv = p.w_qkv.chunk(3, dim=-1)
    bq, bk, bv = p.b_qkv.chunk(3, dim=-1)
    return wq, bq, wk, bk, wv, bv


def bert_layer_relprop(
    p: Dict[str, Any],
    x_in: torch.Tensor,
    mask: Optional[torch.Tensor],
    R: torch.Tensor,
    cfg: BertConfig,
    alpha: float = 1.0,
    uniform: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relprop one post-LN BERT layer (``p`` unstacked) given its taped
    input. Returns ``(R_in, attn_cam)``."""
    eps = cfg.layer_norm_eps
    wq, bq, wk, bk, wv, bv = _split_qkv(p["attn"])
    fwd = _attention_forward(wq, bq, wk, bk, wv, bv, x_in, x_in,
                             cfg.num_attention_heads, mask)
    attn_out = fwd.ctx @ p["attn"].w_out + p["attn"].b_out
    attn_ln_out = layer_norm(x_in + attn_out, p["attn_ln"]["scale"],
                             p["attn_ln"]["bias"], eps)
    g1 = gelu(attn_ln_out @ p["mlp"]["w1"] + p["mlp"]["b1"])
    ffn_out = g1 @ p["mlp"]["w2"] + p["mlp"]["b2"]

    # reverse: mlp_ln identity → add → ffn → clone → attn_ln identity →
    # add → output dense → attention internals
    cam_ffn, cam_ao2 = lrp.add_relprop(ffn_out, attn_ln_out, R)
    cam_g1 = lrp.linear_alpha_beta(cam_ffn, g1, p["mlp"]["w2"], alpha,
                                   uniform)
    cam_ao1 = lrp.linear_alpha_beta(cam_g1, attn_ln_out, p["mlp"]["w1"],
                                    alpha, uniform)
    cam_attn_ln = lrp.clone_relprop(attn_ln_out, [cam_ao1, cam_ao2])
    cam_attn_out, cam_res = lrp.add_relprop(attn_out, x_in, cam_attn_ln)
    cam_attn_in, _, attn_cam = _attention_relprop(
        fwd, wq, wk, wv, p["attn"].w_out, x_in, x_in,
        cfg.num_attention_heads, mask, cam_attn_out, alpha, uniform,
        self_attention=True)
    return lrp.clone_relprop(x_in, [cam_attn_in, cam_res]), attn_cam


def bert_encoder_relprop(
    params: Dict[str, Any],
    tape: torch.Tensor,          # [L, B, S, D] layer inputs
    mask: Optional[torch.Tensor],
    R: torch.Tensor,             # [B, S, D]
    cfg: BertConfig,
    alpha: float = 1.0,
    uniform: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reversed relprop over the whole encoder (BertEncoder.relprop).
    Returns ``(R at the embeddings, attn_cams [L, B, H, S, S])``, the
    cams in layer order."""
    stacked = {k: params[k] for k in ("attn", "attn_ln", "mlp", "mlp_ln")}
    cams = [None] * tape.shape[0]
    for i in reversed(range(tape.shape[0])):
        R, cams[i] = bert_layer_relprop(unstack(stacked, i), tape[i], mask,
                                        R, cfg, alpha, uniform)
    return R, torch.stack(cams)
