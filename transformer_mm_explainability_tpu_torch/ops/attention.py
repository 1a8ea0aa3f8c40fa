"""Multi-head attention with probability capture taps, in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/ops/attention.py``.
Every attention computes ``A = softmax(q kᵀ/√d)`` in fp32 and adds a
caller-supplied zero ``tap`` to it before ``A·v``; ``torch.autograd.grad``
of the target logit with respect to the stacked taps gives every layer's
∂logit/∂A from one forward and one backward. Layouts follow the JAX
package: weights are ``[in, out]`` (``x @ w + b``), per-head tensors are
``[B, H, S, Dh]``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class AttentionParams(NamedTuple):
    """Fused-QKV self-attention parameters: ``w_qkv [D_in, 3D]``,
    ``b_qkv [3D]``, ``w_out [D, D_out]``, ``b_out [D_out]``."""

    w_qkv: torch.Tensor
    b_qkv: torch.Tensor
    w_out: torch.Tensor
    b_out: torch.Tensor


class CrossAttentionParams(NamedTuple):
    """Separate-projection attention parameters (self or cross)."""

    w_q: torch.Tensor
    b_q: torch.Tensor
    w_k: torch.Tensor
    b_k: torch.Tensor
    w_v: torch.Tensor
    b_v: torch.Tensor
    w_out: torch.Tensor
    b_out: torch.Tensor


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, D] -> [B, H, S, D/H]."""
    B, S, D = x.shape
    return x.reshape(B, S, num_heads, D // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, Dh] -> [B, S, H*Dh]."""
    B, H, S, Dh = x.shape
    return x.transpose(1, 2).reshape(B, S, H * Dh)


def attention_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    tap: Optional[torch.Tensor] = None,
    probs_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scaled dot-product attention on ``[B, H, S, Dh]`` tensors.

    ``mask`` is an additive bias broadcastable to ``[B, H, S_q, S_k]``.
    ``tap`` is added to the probabilities before ``A·v``; pass zeros and
    differentiate with respect to it to get ∇A. Returns ``(out, probs)``
    with ``probs`` the un-tapped probabilities (in the tap's dtype when a
    tap is given). A query whose keys are all masked (bias ≤ -5000) gets a
    zero output row while its returned probabilities stay uniform, as in
    the JAX package (``ops/attention.py:106-116``). The scores and the
    products run in ``probs_dtype``, by default fp32 at least (float64
    inputs stay float64).
    """
    if probs_dtype is None:
        probs_dtype = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(probs_dtype),
                          k.to(probs_dtype)) * (1.0 / math.sqrt(q.shape[-1]))
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    if tap is None:
        probs_used = probs
    else:
        probs = probs.to(tap.dtype)
        probs_used = probs + tap
    out = torch.einsum("bhqk,bhkd->bhqd", probs_used.to(probs_dtype),
                       v.to(probs_dtype)).to(v.dtype)
    if mask is not None:
        any_valid = (mask > -5000.0).any(dim=-1, keepdim=True)
        out = out * any_valid.to(out.dtype)
    return out, probs


def multi_head_self_attention(
    params: AttentionParams,
    x: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    tap: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused-QKV self-attention. x: [B, S, D]. Returns (out, probs)."""
    qkv = x @ params.w_qkv + params.b_qkv
    q, k, v = (split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
    out, probs = attention_core(q, k, v, mask=mask, tap=tap)
    return merge_heads(out) @ params.w_out + params.b_out, probs


def multi_head_cross_attention(
    params: CrossAttentionParams,
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    tap: Optional[torch.Tensor] = None,
    x_v: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Separate-projection attention: self (``x_q is x_kv``), cross-modal,
    or keys with a positional embedding the values lack (``x_v``)."""
    if x_v is None:
        x_v = x_kv
    q = split_heads(x_q @ params.w_q + params.b_q, num_heads)
    k = split_heads(x_kv @ params.w_k + params.b_k, num_heads)
    v = split_heads(x_v @ params.w_v + params.b_v, num_heads)
    out, probs = attention_core(q, k, v, mask=mask, tap=tap)
    return merge_heads(out) @ params.w_out + params.b_out, probs


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics at least (float64 inputs keep
    float64) and population variance."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf-based) GELU."""
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)
