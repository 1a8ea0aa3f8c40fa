"""CLIP bi-modal relevancy (the notebook's ``interpret``), in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/explain/clip.py``. The
reference repeats the image over the text batch and calls
``torch.autograd.grad(one_hot, [blk.attn_probs])`` per block; here each
tower runs ONCE with zero taps on its attention probabilities:

  * the text ∇A of every text from one backward of the sum of the
    logits (text b only reaches logit b);
  * the image ∇A of each text from ONE batched backward of the B one-hot
    logit cotangents (``is_grads_batched``, the counterpart of the JAX
    package's vmapped VJP) through the one image forward, in place of B
    backwards with ``retain_graph`` and B times their launches;
  * the chains in ``ops/relevancy``, batched over the texts.

Semantics of the notebook: the scalar of text b is ``logits_per_image[0,
b]``; ``start_layer`` / ``start_layer_text`` are Python slice starts over
the layers, so -1 means the last layer only; the image relevancy is the
CLS row without the CLS (``R[:, 0, 1:]``), the text relevancy the whole
per-text ``[S, S]`` matrix.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from transformer_mm_explainability_tpu_torch.models import clip as clip_model
from transformer_mm_explainability_tpu_torch.ops import relevancy as rl


def interpret(params: Dict[str, Any], image: torch.Tensor,
              tokens: torch.Tensor,
              cfg: clip_model.CLIPConfig = clip_model.CLIP_VIT_B_32,
              start_layer: int = -1, start_layer_text: int = -1
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """image ``[H, W, 3]`` (normalised); tokens ``[B, 77]``.

    Returns ``(text_relevance [B, S_t, S_t], image_relevance [B, S_v-1],
    logits_per_image [B, B])`` (every row of the logits is the one
    image's)."""
    B = tokens.shape[0]
    taps = clip_model.zero_taps(cfg, 1, B, device=image.device,
                                dtype=image.dtype, requires_grad=True)
    with torch.enable_grad():
        img_feat, v_attn = clip_model.encode_image(params, image[None], cfg,
                                                   taps.visual)
        txt_feat, t_attn = clip_model.encode_text(params, tokens, cfg,
                                                  taps.text)
        logits = clip_model.logits_per_image(params, img_feat, txt_feat)[0]
        (t_grads,) = torch.autograd.grad(logits.sum(), [taps.text],
                                         retain_graph=True)
        eye = torch.eye(B, dtype=logits.dtype, device=logits.device)
        (v_grads,) = torch.autograd.grad(logits, [taps.visual],
                                         grad_outputs=eye,
                                         is_grads_batched=True)
    v_attn = v_attn.detach()[:, 0]                       # [L, H, S, S]
    R_img = rl.self_attention_relevancy(                 # [B, L, H, S, S]
        v_attn.expand((B,) + v_attn.shape), v_grads[:, :, 0],
        start_layer=start_layer)
    R_txt = rl.self_attention_relevancy(
        t_attn.detach().movedim(1, 0), t_grads.movedim(1, 0),
        start_layer=start_layer_text)
    logits = logits.detach()
    return R_txt, R_img[:, 0, 1:], logits[None].expand(B, B)


def text_token_relevance(R_text: torch.Tensor,
                         tokens: torch.Tensor) -> torch.Tensor:
    """Per-text heatmap row, as the notebook's ``show_heatmap_on_text``
    reads it: the row at the EOT index, columns 1..EOT-1, zeros elsewhere
    (``[B, S]``)."""
    eot = tokens.long().argmax(dim=-1).to(R_text.device)
    rows = R_text[torch.arange(R_text.shape[0], device=R_text.device), eot]
    col = torch.arange(R_text.shape[-1], device=R_text.device)[None, :]
    mask = (col >= 1) & (col < eot[:, None])
    return torch.where(mask, rows, torch.zeros_like(rows))
