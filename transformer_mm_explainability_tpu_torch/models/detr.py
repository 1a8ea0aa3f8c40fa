"""DETR (ResNet backbone + encoder-decoder transformer) with attention
capture, in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/detr.py`` (the
reference's RelProp-instrumented DETR, DETR/models/detr.py:22-101,
transformer.py:20-548, position_encoding.py:12-51): a post-LN 6+6
transformer at d_model 256, 8 heads, FFN 2048, ReLU; sine positional
encodings added to the queries and keys (not the values) of the encoder
and to the decoder queries and memory keys; 100 learned object queries; a
class head (num_classes + 1) and a 3-layer box MLP with a sigmoid.

The backbone is ``models/resnet.forward`` (torchvision stem, stride in the
3×3), the attention ``ops/attention.multi_head_cross_attention`` with
additive zero taps on three families: encoder self, decoder self and
decoder cross. Padding is an additive -1e9 key bias from the pixel mask
downsampled to the feature grid. Layer weights are stacked along a leading
layer axis, as in the JAX tree, and the layers run in a Python loop.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from transformer_mm_explainability_tpu_torch._device import resolve_device
from transformer_mm_explainability_tpu_torch.models import resnet
from transformer_mm_explainability_tpu_torch.ops.attention import (
    CrossAttentionParams,
    layer_norm,
    multi_head_cross_attention,
)


@dataclasses.dataclass(frozen=True)
class DETRConfig:
    num_classes: int = 91
    num_queries: int = 100
    d_model: int = 256
    nheads: int = 8
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    dim_feedforward: int = 2048
    backbone_channels: int = 2048
    dilation: bool = False  # DC5 variant
    backbone_stages: tuple = (3, 4, 6, 3)  # R50; R101 = (3, 4, 23, 3)

    @property
    def stride(self) -> int:
        return 16 if self.dilation else 32


DETR_R50 = DETRConfig()


class DETRTaps(NamedTuple):
    """One entry per attention family. Captured probabilities and
    gradients are stacked tensors, ``[L, B, H, ...]``; the zero taps fed to
    ``forward`` are per-layer sequences of ``[B, H, ...]`` tensors, so that
    each layer's gradient is its own tensor (indexing one stacked leaf
    would make autograd write every layer's gradient into a buffer of the
    whole stack)."""

    enc_self: Any   # [Le, B, H, S, S]
    dec_self: Any   # [Ld, B, H, Q, Q]
    dec_cross: Any  # [Ld, B, H, Q, S]


def zero_taps(cfg: DETRConfig, B: int, S: int,
              dtype: torch.dtype = torch.float32, device="cuda",
              requires_grad: bool = False) -> DETRTaps:
    """Per-layer zero taps for ``forward`` (see ``DETRTaps``)."""
    H, Q = cfg.nheads, cfg.num_queries

    def family(n, *shape):
        return tuple(torch.zeros(shape, dtype=dtype, device=device,
                                 requires_grad=requires_grad)
                     for _ in range(n))

    return DETRTaps(
        enc_self=family(cfg.num_encoder_layers, B, H, S, S),
        dec_self=family(cfg.num_decoder_layers, B, H, Q, Q),
        dec_cross=family(cfg.num_decoder_layers, B, H, Q, S),
    )


def sine_position_encoding(mask_valid: torch.Tensor,
                           num_pos_feats: int = 128,
                           temperature: float = 10000.0) -> torch.Tensor:
    """DETR's normalised sine embedding (position_encoding.py:28-48).

    ``mask_valid``: ``[B, Hf, Wf]``, 1 on VALID pixels (the reference's
    ``not_mask``). Returns ``[B, Hf, Wf, 2*num_pos_feats]`` (y-features
    then x-features, channel-last)."""
    not_mask = mask_valid.float()
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)
    eps = 1e-6
    scale = 2 * math.pi
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=not_mask.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t

    def interleave(p):
        return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                           dim=-1).reshape(*p.shape[:-1], -1)

    return torch.cat([interleave(pos_y), interleave(pos_x)], dim=-1)


def init_params(seed: Union[int, torch.Generator] = 0,
                cfg: DETRConfig = DETR_R50,
                device="cuda") -> Dict[str, Any]:
    """Random weights in the JAX tree's structure and scales (weights
    uniform in ±1/√fan_in, zero biases, unit LayerNorms, normal query
    embeddings; the backbone from ``resnet.init_params``), drawn on the CPU
    from ``seed`` so that every device gets the same numbers.

    One departure from the JAX init keeps a random model's attention out
    of saturation: each residual branch of the backbone scales by 0.2 (its
    last frozen BN). With unit scales the variance of the R50 features
    doubles in every block, the encoder's attention logits reach ~1e4 and
    its softmax is one-hot: a 1e-7 relative change of a feature (cuDNN
    picking another algorithm for another batch size) moved encoder
    probabilities by 3.2e-2 on an H100."""
    device = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    D, F = cfg.d_model, cfg.dim_feedforward
    Le, Ld = cfg.num_encoder_layers, cfg.num_decoder_layers

    def u(fan, *shape):
        return ((torch.rand(shape, generator=gen) * 2 - 1)
                / math.sqrt(fan)).to(device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def attn(L):
        return CrossAttentionParams(
            w_q=u(D, L, D, D), b_q=zeros(L, D), w_k=u(D, L, D, D),
            b_k=zeros(L, D), w_v=u(D, L, D, D), b_v=zeros(L, D),
            w_out=u(D, L, D, D), b_out=zeros(L, D))

    def ln(L):
        return {"scale": torch.ones((L, D), device=device),
                "bias": zeros(L, D)}

    def ffn(L):
        return {"w1": u(D, L, D, F), "b1": zeros(L, F),
                "w2": u(F, L, F, D), "b2": zeros(L, D)}

    C = cfg.backbone_channels
    backbone = resnet.init_params(gen, stages=cfg.backbone_stages,
                                  device=device)
    for blocks in backbone["layers"]:
        for bp in blocks:
            bp["bn3"]["weight"].fill_(0.2)
    return {
        "backbone": backbone,
        "input_proj": {"w": u(C, C, D), "b": zeros(D)},
        "query_embed": torch.randn((cfg.num_queries, D),
                                   generator=gen).to(device),
        "encoder": {"self_attn": attn(Le), "norm1": ln(Le), "ffn": ffn(Le),
                    "norm2": ln(Le)},
        "decoder": {"self_attn": attn(Ld), "cross_attn": attn(Ld),
                    "norm1": ln(Ld), "norm2": ln(Ld), "norm3": ln(Ld),
                    "ffn": ffn(Ld)},
        "decoder_norm": {"scale": torch.ones(D, device=device),
                         "bias": zeros(D)},
        "class_embed": {"w": u(D, D, cfg.num_classes + 1),
                        "b": zeros(cfg.num_classes + 1)},
        "bbox_embed": [{"w": u(D, D, D), "b": zeros(D)},
                       {"w": u(D, D, D), "b": zeros(D)},
                       {"w": u(D, D, 4), "b": zeros(4)}],
    }


def _layer(tree, i: int):
    """Layer ``i`` of a tree whose leaves are stacked along axis 0."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_layer(v, i) for v in tree))
    return tree[i]


def _ln(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return layer_norm(x, p["scale"], p["bias"])


def _ffn_relu(p, x):
    return torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def transformer_forward(
    params: Dict[str, Any],
    src: torch.Tensor,        # [B, S, D] projected features
    pos: torch.Tensor,        # [B, S, D] positional encoding
    key_padding_bias: Optional[torch.Tensor],  # [B, 1, 1, S] additive
    cfg: DETRConfig,
    taps: Optional[DETRTaps] = None,
    return_tape: bool = False,
):
    """Returns ``(hs [B, Q, D], memory [B, S, D], attn)``, ``attn`` the
    stacked probabilities of the three families, and with ``return_tape``
    the tape ``models/detr_lrp.relprop`` reads fourth: ``{"enc" [Le, B, S,
    D], "dec" [Ld, B, Q, D]`` (each layer's input), ``"memory", "pos",
    "query_pos"}``."""
    B = src.shape[0]
    H = cfg.nheads
    enc_probs, dec_self_probs, dec_cross_probs = [], [], []
    enc_tape, dec_tape = [], []
    x = src
    for i in range(cfg.num_encoder_layers):
        p = _layer(params["encoder"], i)
        enc_tape.append(x)
        qk = x + pos
        attn_out, probs = multi_head_cross_attention(
            p["self_attn"], qk, qk, H, mask=key_padding_bias,
            tap=None if taps is None else taps.enc_self[i], x_v=x)
        x = _ln(x + attn_out, p["norm1"])
        x = _ln(x + _ffn_relu(p["ffn"], x), p["norm2"])
        enc_probs.append(probs)
    memory = x

    query_pos = params["query_embed"].expand(
        (B,) + tuple(params["query_embed"].shape))
    tgt = torch.zeros_like(query_pos)
    k = memory + pos
    for i in range(cfg.num_decoder_layers):
        p = _layer(params["decoder"], i)
        dec_tape.append(tgt)
        qk = tgt + query_pos
        attn_out, self_probs = multi_head_cross_attention(
            p["self_attn"], qk, qk, H,
            tap=None if taps is None else taps.dec_self[i], x_v=tgt)
        tgt = _ln(tgt + attn_out, p["norm1"])
        attn_out, cross_probs = multi_head_cross_attention(
            p["cross_attn"], tgt + query_pos, k, H, mask=key_padding_bias,
            tap=None if taps is None else taps.dec_cross[i], x_v=memory)
        tgt = _ln(tgt + attn_out, p["norm2"])
        tgt = _ln(tgt + _ffn_relu(p["ffn"], tgt), p["norm3"])
        dec_self_probs.append(self_probs)
        dec_cross_probs.append(cross_probs)
    hs = _ln(tgt, params["decoder_norm"])
    attn = DETRTaps(enc_self=torch.stack(enc_probs),
                    dec_self=torch.stack(dec_self_probs),
                    dec_cross=torch.stack(dec_cross_probs))
    if return_tape:
        tape = {"enc": torch.stack(enc_tape), "dec": torch.stack(dec_tape),
                "memory": memory, "pos": pos, "query_pos": query_pos}
        return hs, memory, attn, tape
    return hs, memory, attn


def feature_valid(pad_mask: torch.Tensor, image_hw: Tuple[int, int],
                  feat_hw: Tuple[int, int]) -> torch.Tensor:
    """``[..., Him, Wim]`` pixel validity → ``[..., Hf, Wf]`` float32 on
    the feature grid, by the reference's strided pick (``F.interpolate``
    of the bool mask, misc.py): stride ``Him // Hf``, then the first
    ``Hf`` rows (and the same for the columns)."""
    (Him, Wim), (Hf, Wf) = image_hw, feat_hw
    sh, sw = Him // Hf, Wim // Wf
    return pad_mask[..., ::sh, ::sw][..., :Hf, :Wf].float()


def forward(
    params: Dict[str, Any],
    images: torch.Tensor,                     # [B, H, W, 3] normalised
    pad_mask: Optional[torch.Tensor] = None,  # [B, H, W] 1 = valid pixel
    cfg: DETRConfig = DETR_R50,
    taps: Optional[DETRTaps] = None,
    return_tape: bool = False,
) -> Dict[str, Any]:
    """Full DETR. Returns ``{"pred_logits" [B, Q, C+1], "pred_boxes"
    [B, Q, 4]`` (cxcywh, sigmoid-normalised), ``"attn"`` (stacked
    probabilities), ``"feat_hw"}``; with ``return_tape`` also ``"tape"``,
    ``transformer_forward``'s tape with the decoder output ``"hs"`` and
    the ``"key_padding_bias"`` (None without a pad mask) that the relprop
    of ``models/detr_lrp`` takes."""
    B, Him, Wim, _ = images.shape
    feats = resnet.forward(params["backbone"], images,
                           dilation_last=cfg.dilation)
    _, Hf, Wf, C = feats.shape
    S = Hf * Wf
    if pad_mask is None:
        feat_valid = torch.ones((B, Hf, Wf), device=images.device)
        bias = None
    else:
        feat_valid = feature_valid(pad_mask, (Him, Wim), (Hf, Wf))
        bias = ((1.0 - feat_valid.reshape(B, S)) * -1e9)[:, None, None, :]
    pos = sine_position_encoding(feat_valid, cfg.d_model // 2)
    src = feats.reshape(B, S, C) @ params["input_proj"]["w"] \
        + params["input_proj"]["b"]
    pos = pos.reshape(B, S, cfg.d_model)
    hs, _, attn, *tape = transformer_forward(params, src, pos, bias, cfg,
                                             taps, return_tape)

    logits = hs @ params["class_embed"]["w"] + params["class_embed"]["b"]
    x = hs
    for i, lp in enumerate(params["bbox_embed"]):
        x = x @ lp["w"] + lp["b"]
        if i < len(params["bbox_embed"]) - 1:
            x = torch.relu(x)
    out = {"pred_logits": logits, "pred_boxes": torch.sigmoid(x),
           "attn": attn, "feat_hw": (Hf, Wf)}
    if return_tape:
        out["tape"] = dict(tape[0], hs=hs, key_padding_bias=bias)
    return out


def _tokens(cfg: DETRConfig, Him: int, Wim: int) -> int:
    return (Him // cfg.stride) * (Wim // cfg.stride)


def _detached(out: Dict[str, Any]) -> Dict[str, Any]:
    cut = lambda v: v.detach() if torch.is_tensor(v) else v
    return {k: ({n: cut(t) for n, t in v.items()} if k == "tape" else cut(v))
            for k, v in out.items() if k != "attn"}


def _flat(taps: DETRTaps) -> Sequence[torch.Tensor]:
    return [t for family in taps for t in family]


def capture(
    params: Dict[str, Any],
    images: torch.Tensor,
    one_hot: torch.Tensor,  # [B, Q, C+1] target one-hot(s) over pred_logits
    pad_mask: Optional[torch.Tensor] = None,
    cfg: DETRConfig = DETR_R50,
) -> Tuple[Dict[str, Any], DETRTaps, DETRTaps]:
    """One forward and one backward for ∂(Σ one_hot ⊙ pred_logits)/∂A on
    all three families. Returns ``(out, attn, grads)``, the last two
    stacked ``[L, B, H, ...]``.

    Summing one-hots of several queries of one image mixes their
    gradients; per-query explanations batch through ``capture_multi``."""
    B, Him, Wim, _ = images.shape
    taps = zero_taps(cfg, B, _tokens(cfg, Him, Wim), dtype=images.dtype,
                     device=images.device, requires_grad=True)
    with torch.enable_grad():
        out = forward(params, images, pad_mask, cfg, taps)
        score = (out["pred_logits"] * one_hot).sum()
        flat = torch.autograd.grad(score, _flat(taps))
    n_enc, n_dec = cfg.num_encoder_layers, cfg.num_decoder_layers
    grads = DETRTaps(torch.stack(flat[:n_enc]),
                     torch.stack(flat[n_enc:n_enc + n_dec]),
                     torch.stack(flat[n_enc + n_dec:]))
    attn = DETRTaps(*(a.detach() for a in out["attn"]))
    return _detached(out), attn, grads


def capture_multi(
    params: Dict[str, Any],
    image: torch.Tensor,                 # [H, W, 3] ONE image
    one_hots: torch.Tensor,              # [K, Q, C+1] per-query targets
    pad_valid: Optional[torch.Tensor] = None,   # [H, W] 1 = valid
    cfg: DETRConfig = DETR_R50,
    return_tape: bool = False,
) -> Tuple[Dict[str, Any], DETRTaps, DETRTaps]:
    """Shared-forward capture for K per-query explanations of ONE image.

    The forward runs ONCE (B=1) and the K per-query gradients come from ONE
    backward batched over the K one-hot cotangents
    (``torch.autograd.grad(..., is_grads_batched=True)``, the counterpart
    of the JAX package's vmapped VJP): the cost of one forward and one
    K-batched backward in place of K forwards of the same pixels. Only the
    taps require gradients, so the backward stops at them and the backbone
    is never differentiated.

    Returns ``(out, attn, grads)`` shaped like a K-batched ``capture``
    (leaves ``[L, K, H, ...]``; ``attn`` a broadcast view of the one
    forward's probabilities, not K copies); ``out`` keeps B=1, and with
    ``return_tape`` holds the forward's tape (``forward``), which the K
    relprops of the LRP methods share."""
    Him, Wim, _ = image.shape
    K = one_hots.shape[0]
    taps = zero_taps(cfg, 1, _tokens(cfg, Him, Wim), dtype=image.dtype,
                     device=image.device, requires_grad=True)
    masks = None if pad_valid is None else pad_valid[None]
    with torch.enable_grad():
        out = forward(params, image[None], masks, cfg, taps, return_tape)
        flat = torch.autograd.grad(out["pred_logits"][0], _flat(taps),
                                   grad_outputs=one_hots.to(image.dtype),
                                   is_grads_batched=True)
    n_enc, n_dec = cfg.num_encoder_layers, cfg.num_decoder_layers
    # each g is [K, 1, H, ...]; stacked → [L, K, H, ...]
    stack = lambda gs: torch.stack([g[:, 0] for g in gs])
    grads = DETRTaps(stack(flat[:n_enc]), stack(flat[n_enc:n_enc + n_dec]),
                     stack(flat[n_enc + n_dec:]))
    attn = DETRTaps(*(a.detach().expand((a.shape[0], K) + a.shape[2:])
                      for a in out["attn"]))
    return _detached(out), attn, grads
