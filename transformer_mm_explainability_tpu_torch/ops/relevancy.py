"""The paper's relevancy-update rules, batched, in plain PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/ops/relevancy.py``
(Chefer et al., ICCV 2021, "Generic Attention-model Explainability"):

  * rule 5      ``avg_heads`` — head mean of relu(∇A ⊙ A);
  * rules 6+7   ``apply_self_attention_rules``;
  * eq. 8+9     ``handle_residual``;
  * rules 10+11 ``apply_mm_attention_rules``;
  * rollout     ``compute_rollout_attention`` (Abnar & Zuidema);
  * the "ours" chains ``self_attention_relevancy`` and
    ``self_attention_relevancy_update``.

The JAX functions take one example and are batched with ``jax.vmap``.
Here every function takes any number of leading batch axes: the head
axis is ``-3`` of a ``[..., H, S_q, S_k]`` capture, the layer axis is
``-4`` of a ``[..., L, H, S, S]`` stack (``-3`` of a ``[..., L, S, S]``
rollout stack), and matrices are the last two axes. Accumulation is
fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def avg_heads(cam: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """Rule 5: Ê = mean_h relu(∇A ⊙ A); ``[..., H, S_q, S_k]`` →
    ``[..., S_q, S_k]``."""
    return torch.clamp(grad * cam, min=0.0).mean(dim=-3)


def grad_cam(cam: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """GradCAM head aggregation (the ``attn_gradcam`` baseline): weight
    each head's map by the mean of its gradient, head-average, clamp."""
    weights = grad.mean(dim=(-2, -1), keepdim=True)
    return torch.clamp((cam * weights).mean(dim=-3), min=0.0)


def apply_self_attention_rules(
    R_ss: torch.Tensor, R_sq: torch.Tensor, cam_ss: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rules 6+7: ``(Ê @ R_ss, Ê @ R_sq)``."""
    return cam_ss @ R_ss, cam_ss @ R_sq


def handle_residual(R: torch.Tensor,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 8+9: R̂ = R − I; R̂ ← R̂ / Σ_k R̂[·, k]; return R̂ + I.

    A zero row sum gives NaN, as the reference's plain division does.
    ``valid`` (``[..., S]``, 1 = real token) pins padded rows to identity
    rows while valid rows keep the plain division, NaN included.
    """
    eye = _eye(R.shape[-1], R)
    R_hat = R - eye
    denom = R_hat.sum(dim=-1, keepdim=True)
    if valid is not None:
        v = valid.to(R.dtype)[..., :, None]
        R_hat = R_hat * v
        denom = torch.where(v > 0, denom, torch.ones_like(denom))
    return R_hat / denom + eye


def apply_mm_attention_rules(
    R_ss: torch.Tensor,
    R_qq: torch.Tensor,
    cam_sq: torch.Tensor,
    R_qs: Optional[torch.Tensor] = None,
    apply_normalization: bool = True,
    apply_self_in_rule_10: bool = True,
    nan_to_zero: bool = False,
    s_valid: Optional[torch.Tensor] = None,
    q_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Rules 10+11 of a cross-modal attention layer:

    R_sq_addition = norm(R_ss)ᵀ @ (Ê_sq @ norm(R_qq))      (rule 10)
    R_ss_addition = Ê_sq @ R_qs                             (rule 11)

    Rule 11 is skipped (``None``) when ``R_qs`` is None. ``nan_to_zero``
    zeroes NaN in the rule-10 result (DETR's guard).
    """
    R_ss_norm = (handle_residual(R_ss, s_valid)
                 if apply_normalization else R_ss)
    R_qq_norm = (handle_residual(R_qq, q_valid)
                 if apply_normalization else R_qq)
    R_sq_addition = R_ss_norm.transpose(-1, -2) @ (cam_sq @ R_qq_norm)
    if not apply_self_in_rule_10:
        R_sq_addition = cam_sq
    if nan_to_zero:
        R_sq_addition = torch.nan_to_num(R_sq_addition, nan=0.0)
    R_ss_addition = None if R_qs is None else cam_sq @ R_qs
    return R_sq_addition, R_ss_addition


def compute_rollout_attention(
    layer_matrices: torch.Tensor,
    start_layer: int = 0,
    normalize: bool = True,
) -> torch.Tensor:
    """Attention rollout over ``[..., L, S, S]``: add the residual
    identity, optionally row-normalise, and multiply last to first,
    ``A_{L-1} @ ... @ A_{start}``."""
    mats = layer_matrices + _eye(layer_matrices.shape[-1], layer_matrices)
    if normalize:
        mats = mats / mats.sum(dim=-1, keepdim=True)
    mats = mats[..., start_layer:, :, :]
    joint = mats[..., 0, :, :]
    for i in range(1, mats.shape[-3]):
        joint = mats[..., i, :, :] @ joint
    return joint


def e_hats(cams: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """``[..., L, H, S, S]`` captures → ``[..., L, S, S]`` Ê stack, fp32 at
    least (float64 captures keep float64)."""
    dt = torch.promote_types(cams.dtype, torch.float32)
    return avg_heads(cams.to(dt), grads.to(dt))


def rule6_chain(e_hat_stack: torch.Tensor) -> torch.Tensor:
    """R = I; per layer of the ``[..., L, S, S]`` Ê stack R += Ê @ R.
    Returns ``[..., S, S]``."""
    R = _eye(e_hat_stack.shape[-1], e_hat_stack).expand(
        e_hat_stack.shape[:-3] + e_hat_stack.shape[-2:])
    for i in range(e_hat_stack.shape[-3]):
        R = R + e_hat_stack[..., i, :, :] @ R
    return R


def self_attention_relevancy(
    cams: torch.Tensor,
    grads: torch.Tensor,
    start_layer: int = 0,
) -> torch.Tensor:
    """The "ours" chain over ``[..., L, H, S, S]``: R = I; per layer
    R += Ê @ R. Returns ``[..., S, S]``."""
    return rule6_chain(e_hats(cams, grads)[..., start_layer:, :, :])


def self_attention_relevancy_update(
    R_ss: torch.Tensor,
    R_sq: torch.Tensor,
    cams: torch.Tensor,
    grads: torch.Tensor,
    aggregate: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rules 6+7 over a ``[..., L, H, S, S]`` stack of self-attention
    layers. ``aggregate=False`` overwrites instead of adding (the
    no-aggregation ablation)."""
    e = e_hats(cams, grads)
    R_ss, R_sq = R_ss.to(e.dtype), R_sq.to(e.dtype)
    for i in range(e.shape[-3]):
        add_ss, add_sq = apply_self_attention_rules(R_ss, R_sq,
                                                    e[..., i, :, :])
        if aggregate:
            R_ss, R_sq = R_ss + add_ss, R_sq + add_sq
        else:
            R_ss, R_sq = add_ss, add_sq
    return R_ss, R_sq
