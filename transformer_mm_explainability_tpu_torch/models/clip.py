"""CLIP (ViT or ModifiedResNet vision tower + causal text tower) with
attention capture, in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/clip.py`` (the
reference's instrumented OpenAI CLIP): residual attention blocks stacked
on a leading layer axis and run in a Python loop, LayerNorm in fp32,
QuickGELU, the causal text mask as an additive −inf upper triangle, and
the attention probabilities of both towers captured through additive zero
taps (``ops/attention``), so that ``torch.autograd.grad`` with respect to
the taps gives every ∇A. The ResNet tower (``models/clip_resnet``) has no
capture.

Weights follow ``clip.load``'s state dict after ``utils/convert``: qkv
fused (``in_proj``), linear weights input-major, the patchify conv a
``[P*P*3, D]`` matmul weight.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from transformer_mm_explainability_tpu_torch.models import bert
from transformer_mm_explainability_tpu_torch.ops.attention import (
    AttentionParams,
    layer_norm,
    multi_head_self_attention,
    quick_gelu,
)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    # vision: int = ViT depth; tuple = ModifiedResNet stage sizes
    image_resolution: int = 224
    vision_layers: Any = 12
    vision_width: int = 768
    vision_patch_size: int = 32
    # text
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12

    @property
    def is_resnet(self) -> bool:
        return isinstance(self.vision_layers, (tuple, list))

    @property
    def vision_heads(self) -> int:
        if self.is_resnet:
            return self.vision_width * 32 // 64
        return self.vision_width // 64

    @property
    def vision_seq_len(self) -> int:
        return (self.image_resolution // self.vision_patch_size) ** 2 + 1


CLIP_VIT_B_32 = CLIPConfig()
CLIP_VIT_B_16 = CLIPConfig(vision_patch_size=16)


class Taps(NamedTuple):
    """Attention-probability taps of both towers (zeros for capture)."""

    visual: torch.Tensor  # [L_v, B, H_v, S_v, S_v]; [0] for a ResNet tower
    text: torch.Tensor    # [L_t, B, H_t, S_t, S_t]


def zero_taps(cfg: CLIPConfig, n_images: int, n_texts: int, device="cpu",
              dtype: torch.dtype = torch.float32,
              requires_grad: bool = False) -> Taps:
    St = cfg.context_length
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device,
                                   requires_grad=requires_grad)
    if cfg.is_resnet:
        visual = z(0)  # no attention capture in the ResNet tower
    else:
        Sv = cfg.vision_seq_len
        visual = z(cfg.vision_layers, n_images, cfg.vision_heads, Sv, Sv)
    return Taps(visual=visual,
                text=z(cfg.transformer_layers, n_texts,
                       cfg.transformer_heads, St, St))


def _init_tower(gen: torch.Generator, width: int, layers: int, device):
    D, L, Dm = width, layers, width * 4
    nrm = lambda s, *shape: (torch.randn(shape, generator=gen) * s).to(device)
    zeros = lambda *shape: torch.zeros(shape, device=device)
    ones = lambda *shape: torch.ones(shape, device=device)
    proj_std = (D ** -0.5) * ((2 * L) ** -0.5)
    return {
        "ln1": {"scale": ones(L, D), "bias": zeros(L, D)},
        "attn": AttentionParams(
            w_qkv=nrm(D ** -0.5, L, D, 3 * D), b_qkv=zeros(L, 3 * D),
            w_out=nrm(proj_std, L, D, D), b_out=zeros(L, D)),
        "ln2": {"scale": ones(L, D), "bias": zeros(L, D)},
        "mlp": {"w1": nrm((2 * D) ** -0.5, L, D, Dm), "b1": zeros(L, Dm),
                "w2": nrm(proj_std, L, Dm, D), "b2": zeros(L, D)},
    }


def init_params(seed: Union[int, torch.Generator] = 0,
                cfg: CLIPConfig = CLIP_VIT_B_32,
                device="cuda") -> Dict[str, Any]:
    """Random weights in the JAX tree's structure and scales, drawn on the
    CPU from ``seed``; the ResNet tower from ``clip_resnet.init_params``."""
    gen = bert._generator(seed)
    nrm = lambda s, *shape: (torch.randn(shape, generator=gen) * s).to(device)
    ln = lambda n: {"scale": torch.ones(n, device=device),
                    "bias": torch.zeros(n, device=device)}
    Dv, P, Dt = cfg.vision_width, cfg.vision_patch_size, cfg.transformer_width
    if cfg.is_resnet:
        from transformer_mm_explainability_tpu_torch.models import clip_resnet

        visual = clip_resnet.init_params(gen, cfg, device)
    else:
        visual = {
            "conv1": nrm(Dv ** -0.5, P * P * 3, Dv),  # no bias
            "class_embedding": nrm(Dv ** -0.5, Dv),
            "positional_embedding": nrm(Dv ** -0.5, cfg.vision_seq_len, Dv),
            "ln_pre": ln(Dv),
            "blocks": _init_tower(gen, Dv, cfg.vision_layers, device),
            "ln_post": ln(Dv),
            "proj": nrm(Dv ** -0.5, Dv, cfg.embed_dim),
        }
    return {
        "visual": visual,
        "text": {
            "token_embedding": nrm(0.02, cfg.vocab_size, Dt),
            "positional_embedding": nrm(0.01, cfg.context_length, Dt),
            "blocks": _init_tower(gen, Dt, cfg.transformer_layers, device),
            "ln_final": ln(Dt),
            "text_projection": nrm(Dt ** -0.5, Dt, cfg.embed_dim),
        },
        "logit_scale": torch.tensor(math.log(1.0 / 0.07), device=device),
    }


def _tower(blocks: Dict[str, Any], x: torch.Tensor, num_heads: int,
           taps: Optional[torch.Tensor], mask: Optional[torch.Tensor] = None,
           ln_eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual-attention-block stack: ``(x, probs [L, B, H, S, S])``."""
    probs = []
    for i in range(blocks["ln1"]["scale"].shape[0]):
        p = bert.unstack(blocks, i)
        h = layer_norm(x, p["ln1"]["scale"], p["ln1"]["bias"], ln_eps)
        attn_out, pr = multi_head_self_attention(
            p["attn"], h, num_heads, mask=mask,
            tap=None if taps is None else taps[i])
        x = x + attn_out
        h = layer_norm(x, p["ln2"]["scale"], p["ln2"]["bias"], ln_eps)
        h = quick_gelu(h @ p["mlp"]["w1"] + p["mlp"]["b1"])
        x = x + (h @ p["mlp"]["w2"] + p["mlp"]["b2"])
        probs.append(pr)
    return x, torch.stack(probs)


def encode_image(params: Dict[str, Any], images: torch.Tensor,
                 cfg: CLIPConfig, taps: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images ``[B, H, W, 3]`` normalised → ``(features [B, E], attn)``
    (``attn`` is empty for the ResNet tower)."""
    if cfg.is_resnet:
        from transformer_mm_explainability_tpu_torch.models import clip_resnet

        feats = clip_resnet.forward(params["visual"], images,
                                    cfg.vision_heads)
        return feats, images.new_zeros((0,))
    v = params["visual"]
    B, H, W, _ = images.shape
    P = cfg.vision_patch_size
    x = images.reshape(B, H // P, P, W // P, P, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, -1, P * P * 3) @ v["conv1"]
    cls = v["class_embedding"].expand(B, 1, cfg.vision_width)
    x = torch.cat([cls, x], dim=1) + v["positional_embedding"]
    x = layer_norm(x, v["ln_pre"]["scale"], v["ln_pre"]["bias"])
    x, attn = _tower(v["blocks"], x, cfg.vision_heads, taps)
    x = layer_norm(x[:, 0], v["ln_post"]["scale"], v["ln_post"]["bias"])
    return x @ v["proj"], attn


def encode_text(params: Dict[str, Any], tokens: torch.Tensor,
                cfg: CLIPConfig, taps: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens ``[B, context_length]`` → ``(features [B, E], attn)``,
    pooled at the EOT position, the token argmax."""
    t = params["text"]
    tokens = tokens.long()
    x = t["token_embedding"][tokens] + t["positional_embedding"]
    S = cfg.context_length
    causal = torch.triu(torch.full((S, S), float("-inf"), dtype=x.dtype,
                                   device=x.device), diagonal=1)
    x, attn = _tower(t["blocks"], x, cfg.transformer_heads, taps,
                     mask=causal)
    x = layer_norm(x, t["ln_final"]["scale"], t["ln_final"]["bias"])
    eot = tokens.argmax(dim=-1)
    x = x[torch.arange(x.shape[0], device=x.device), eot]
    return x @ t["text_projection"], attn


def logits_per_image(params: Dict[str, Any], img_feat: torch.Tensor,
                     txt_feat: torch.Tensor) -> torch.Tensor:
    """``exp(logit_scale) · norm(img) @ norm(txt)ᵀ`` → ``[B_i, B_t]``."""
    img_feat = img_feat / img_feat.norm(dim=-1, keepdim=True)
    txt_feat = txt_feat / txt_feat.norm(dim=-1, keepdim=True)
    return params["logit_scale"].exp() * img_feat @ txt_feat.T


def forward(params: Dict[str, Any], images: torch.Tensor,
            tokens: torch.Tensor, cfg: CLIPConfig = CLIP_VIT_B_32,
            taps: Optional[Taps] = None
            ) -> Tuple[torch.Tensor, torch.Tensor,
                       Tuple[torch.Tensor, torch.Tensor]]:
    """Returns ``(logits_per_image [B_i, B_t], logits_per_text,
    (visual_attn, text_attn))``."""
    img_feat, v_attn = encode_image(params, images, cfg,
                                    None if taps is None else taps.visual)
    txt_feat, t_attn = encode_text(params, tokens, cfg,
                                   None if taps is None else taps.text)
    lpi = logits_per_image(params, img_feat, txt_feat)
    return lpi, lpi.T, (v_attn, t_attn)
