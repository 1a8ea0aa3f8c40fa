"""Work counts of the ViT relevancy map (``configs/vit_b16.json``'s keys).

``explain_per_map``: the function's work, whatever computes it.
``block_gemms`` and ``attention_calls``: the work of the products and the
attention calls that the port's block path (``relevancy_fused_block2``)
launches for one batch, each call counted as the function of its own
inputs (for the kernel rooflines).
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def _dims(cfg: Dict) -> Tuple[int, int, int, int, int, int]:
    P = cfg["patch_size"]
    S = (cfg["image_size"] // P) ** 2 + 1
    return (S, cfg["hidden_size"], cfg["intermediate_size"],
            cfg["num_hidden_layers"], cfg["num_classes"], P * P * 3)


def forward_per_image(cfg: Dict) -> float:
    """Patch embedding, per layer the qkv, attention (q·kᵀ and A·v), output
    and MLP products, and the class token's head."""
    S, D, I, L, C, K = _dims(cfg)
    layer = 2 * S * D * 3 * D + 4 * S * S * D + 2 * S * D * D + 4 * S * D * I
    return 2 * (S - 1) * K * D + L * layer + 2 * D * C


def explain_per_map(cfg: Dict) -> float:
    """The forward, then the cotangents the map needs: the head's; in every
    layer the MLP's and the output projection's, and ∇A (dout·vᵀ); above
    the first layer also the cotangents of v, q and k and of the qkv
    projection's input; and the rule-6 row fold r·Ê (2·S² a layer)."""
    S, D, I, L, C, _ = _dims(cfg)
    first = 4 * S * D * I + 2 * S * D * D + 2 * S * S * D
    upper = first + 6 * S * S * D + 2 * S * 3 * D * D
    return (forward_per_image(cfg) + 2 * D * C + first + (L - 1) * upper
            + L * 2 * S * S)


def block_gemms(cfg: Dict, batch: int) -> Tuple[float, int]:
    """(FLOPs, launches) of the block path's products in one batch: per
    layer the forward's qkv, output and two MLP products; the MLP
    backward's a1 (recomputed), cot·w2ᵀ and ·w1ᵀ; the attention backward's
    qkv (recomputed), cot·W_outᵀ and dqkv·W_qkvᵀ."""
    S, D, I, L, _, _ = _dims(cfg)
    M = batch * S
    per_layer = 2 * M * (11 * D * D + 5 * D * I)
    return L * per_layer, L * 10


def attention_calls(cfg: Dict, batch: int) -> List[Tuple[float, float]]:
    """(FLOPs, bytes) of each attention call of one batch: per layer the
    forward (q·kᵀ, A·v; reads q, k, v, writes out) and the backward with
    the fold (q·kᵀ again, since A is not an input, dout·vᵀ, Aᵀ·dout,
    dS·k, dSᵀ·q; reads q, k, v, dout and r, writes dq, dk, dv and
    e_row), fp32."""
    S, D, _, L, _, _ = _dims(cfg)
    B, f4 = batch, 4
    fwd = (4 * B * S * S * D, f4 * 4 * B * S * D)
    bwd = (10 * B * S * S * D, f4 * (7 * B * S * D + 2 * B * S))
    return [fwd, bwd] * L
