"""What the references share: the products, LayerNorm, GELU, the rule-6
chain.

``matmul(a, b, tf32)`` is ``torch.matmul`` in fp32 (with TF32 off in
cuBLAS), or, for the control, the same product on operands rounded to TF32
(10 mantissa bits, to nearest even) with fp32 sums, which is what a TF32
tensor-core product computes. The rounding also applies to the cotangent
that reaches a product in the backward, so every product of the control's
backward is a TF32 product too. The rounding is explicit, so the control
is the same on the card and on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 → the nearest TF32 value (ties to even), stored as fp32."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class _RoundOperand(torch.autograd.Function):
    """Forward: the operand rounded to TF32; backward: the cotangent as it
    comes (the rounding of a product's cotangent is ``_RoundCotangent``'s)."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundCotangent(torch.autograd.Function):
    """Forward: identity; backward: the product's cotangent rounded to TF32
    before the backward products read it."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool = False
           ) -> torch.Tensor:
    if not tf32:
        return torch.matmul(a, b)
    return _RoundCotangent.apply(
        torch.matmul(_RoundOperand.apply(a), _RoundOperand.apply(b)))


def layer_norm(x, scale, bias, eps: float):
    """Population variance, fp32."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def gelu(x):
    """The exact (erf) GELU."""
    return F.gelu(x)


def rule6_row(attn, grads, row: torch.Tensor, tf32: bool) -> torch.Tensor:
    """Rule 5 then rule 6 of Chefer et al. 2021 over every layer, the whole
    matrix: Ê_l = mean_h relu(∇A_l ⊙ A_l); R = I; R ← R + Ê_l·R from the
    first layer to the last; returns row ``row[b]`` of each image's R.
    ``attn``, ``grads``: ``[L, B, H, S, S]``."""
    e = torch.clamp(grads * attn, min=0.0).mean(dim=2)        # [L, B, S, S]
    B, S = e.shape[1], e.shape[-1]
    R = torch.eye(S, device=e.device).expand(B, S, S)
    for layer in e:
        R = R + matmul(layer, R, tf32)
    return R[torch.arange(B, device=R.device), row]
