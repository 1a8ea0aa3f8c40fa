"""DETR segmentation heads (models/segmentation.py:24-245), in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/
detr_segm_heads.py``. The explainability flow replaces DETRsegm's learned
masks with explanation masks (the reference keeps DETRsegm commented out
in build(), detr.py:357-358); the heads complete the model family:

  * ``mh_attention_map``: MHAttentionMap, per-query attention over the
    feature map (2-D softmax, no value projection);
  * ``mask_head``: MaskHeadSmallConv, a conv head fusing the attention
    maps with backbone features through FPN skips;
  * ``post_process_segm``: PostProcessSegm, bilinear upsample + sigmoid
    0.5 threshold.

Maps are channel-last ``[B, H, W, C]`` at the boundary, as in the JAX
package; conv weights are OIHW (``utils/convert``'s layout), and the convs
run in NCHW through ``models/resnet.conv``.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from transformer_mm_explainability_tpu_torch.models import resnet
from transformer_mm_explainability_tpu_torch.ops.image import resize_linear


def mh_attention_map(params: Dict[str, Any], q: torch.Tensor,
                     k_feat: torch.Tensor, num_heads: int,
                     mask_valid: torch.Tensor = None) -> torch.Tensor:
    """q ``[B, Q, D]`` decoder outputs, k_feat ``[B, H, W, D]`` projected
    features → ``[B, Q, heads, H, W]`` attention maps (softmax over
    H·W)."""
    B, Qn, D = q.shape
    _, H, W, _ = k_feat.shape
    dh = D // num_heads
    qh = (q @ params["q_w"] + params["q_b"]).reshape(B, Qn, num_heads, dh)
    kh = (k_feat @ params["k_w"] + params["k_b"]).reshape(B, H, W,
                                                          num_heads, dh)
    scores = torch.einsum("bqnd,bhwnd->bqnhw", qh, kh) / (dh ** 0.5)
    if mask_valid is not None:
        bias = (1.0 - mask_valid.to(scores.dtype)) * -1e9
        scores = scores + bias[:, None, None, :, :]
    probs = torch.softmax(scores.reshape(B, Qn, num_heads, H * W), dim=-1)
    return probs.reshape(B, Qn, num_heads, H, W)


def _gn(x: torch.Tensor, scale, bias, groups: int = 8,
        eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over channel-last maps ``[B, H, W, C]``."""
    B, H, W, C = x.shape
    g = x.reshape(B, H, W, groups, C // groups)
    mean = g.mean(dim=(1, 2, 4), keepdim=True)
    var = g.var(dim=(1, 2, 4), keepdim=True, unbiased=False)
    g = (g - mean) * torch.rsqrt(var + eps)
    return g.reshape(B, H, W, C) * scale + bias


def _conv(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Channel-last conv with an OIHW weight and a bias."""
    return resnet.to_nhwc(resnet.conv(resnet.to_nchw(x), p["w"])) + p["b"]


def mask_head(params: Dict[str, Any], feat: torch.Tensor,
              attn_maps: torch.Tensor,
              fpn_feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """MaskHeadSmallConv: concat(features, per-query attention maps) →
    conv / GroupNorm / relu ladder with FPN skip fusions → per-query mask
    logits ``[B·Q, H, W, 1]``."""
    B, H, W, D = feat.shape
    _, Qn, heads, _, _ = attn_maps.shape
    f = feat[:, None].expand(B, Qn, H, W, D).reshape(B * Qn, H, W, D)
    a = attn_maps.permute(0, 1, 3, 4, 2).reshape(B * Qn, H, W, heads)
    x = torch.cat([f, a], dim=-1)
    for i, lay in enumerate(params["convs"]):
        x = torch.relu(_gn(_conv(x, lay), lay["gn_scale"], lay["gn_bias"]))
        if i < len(fpn_feats):
            skip = fpn_feats[i]
            adapter = params["adapters"][i]
            if adapter is not None:
                skip = _conv(skip, adapter)
            sh, sw = skip.shape[1:3]
            # jax.image.resize 'nearest': source floor((i + 0.5)·in/out)
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(sh, sw),
                              mode="nearest-exact").permute(0, 2, 3, 1)
            skip_q = skip[:, None].expand((B, Qn) + tuple(skip.shape[1:]))
            x = x + skip_q.reshape(B * Qn, sh, sw, -1)
    return _conv(x, params["out"])


def post_process_segm(mask_logits: torch.Tensor,
                      out_hw: Tuple[int, int]) -> torch.Tensor:
    """PostProcessSegm (segmentation.py:218-243): linear upsample to the
    image size (``jax.image.resize``'s), sigmoid, threshold 0.5 → binary
    masks ``[K, H, W]``."""
    up = resize_linear(mask_logits[..., 0], out_hw)
    return (torch.sigmoid(up) > 0.5).float()
