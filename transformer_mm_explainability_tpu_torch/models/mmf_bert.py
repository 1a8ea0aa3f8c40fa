"""MMFBert: the Pythia-skeleton BERT variant, in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/mmf_bert.py``
(``mmf/models/mmf_bert.py``): BERT embeddings → one text self-attention
(torch nn.MultiheadAttention) → per-stream image cross-attention (text
queries over projected image features, optional intra-image
self-attention) → optional NonLinearElementMultiply combine → BertPooler
→ the pretraining, VQA/VizWiz ('?' token at ``input_mask.sum()-2``) or
NLVR2 head. Every MultiheadAttention runs as the port's separate-
projection ``multi_head_cross_attention`` (``[in, out]`` weights).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from transformer_mm_explainability_tpu_torch.models import bert as tbert
from transformer_mm_explainability_tpu_torch.models import mmf_layers as L
from transformer_mm_explainability_tpu_torch.ops.attention import (
    CrossAttentionParams,
    gelu,
    layer_norm,
    multi_head_cross_attention,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MMFBertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_attention_heads: int = 12
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    image_feature_dim: int = 2048
    num_image_features: int = 1
    image_intra_attention: bool = False
    combine_embeddings: bool = True
    combine_hidden_dim: int = 768
    training_head_type: str = "vqa2"   # pretraining | vqa2 | vizwiz | nlvr2
    answer_space_size: int = 3129
    layer_norm_eps: float = 1e-12


def _init_mha(gen, d: int, device) -> CrossAttentionParams:
    n = lambda: L.normal(gen, (d, d), 0.02, device)
    z = lambda: torch.zeros(d, device=device)
    return CrossAttentionParams(w_q=n(), b_q=z(), w_k=n(), b_k=z(),
                                w_v=n(), b_v=z(), w_out=n(), b_out=z())


def init_transform(gen, d: int, device) -> Params:
    """BertPredictionHeadTransform: dense ``[out, in]``, LN."""
    return {"w": L.normal(gen, (d, d), 0.02, device),
            "b": torch.zeros(d, device=device), "ln": L.ln_init(d, device)}


def transform_fwd(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """dense → gelu → LN."""
    h = gelu(x @ p["w"].T + p["b"])
    return layer_norm(h, p["ln"]["scale"], p["ln"]["bias"], eps)


def init_mmf_bert(seed: L.Seed, cfg: MMFBertConfig,
                  device="cuda") -> Params:
    gen = L.generator(seed)
    D = cfg.hidden_size
    bert_cfg = tbert.BertConfig(
        vocab_size=cfg.vocab_size, hidden_size=D,
        max_position_embeddings=cfg.max_position_embeddings,
        type_vocab_size=cfg.type_vocab_size,
        layer_norm_eps=cfg.layer_norm_eps)
    params: Params = {
        "embeddings": tbert.init_embedding_params(gen, bert_cfg, device),
        "text_attention": _init_mha(gen, D, device),
        "image_projection": L.init_linear(gen, cfg.image_feature_dim, D,
                                          device),
        "image_attentions": [_init_mha(gen, D, device)
                             for _ in range(cfg.num_image_features)],
        "pooler": {"w": L.normal(gen, (D, D), 0.02, device),
                   "b": torch.zeros(D, device=device)},
        "classifier": {"transform": init_transform(gen, D, device),
                       "out": L.init_linear(gen, D, cfg.answer_space_size,
                                            device)},
        "cls": {"transform": init_transform(gen, D, device),
                "decoder_bias": torch.zeros(cfg.vocab_size, device=device),
                "seq_relationship": L.init_linear(gen, D, 2, device)},
    }
    if cfg.image_intra_attention:
        params["image_intra_attention"] = _init_mha(gen, D, device)
    if cfg.combine_embeddings:
        params["combine"] = L.init_non_linear_element_multiply(
            gen, D, D, cfg.combine_hidden_dim, device=device)
    return params


def _pad_bias(key_padding_mask: Optional[torch.Tensor]
              ) -> Optional[torch.Tensor]:
    """torch key_padding_mask (True = ignore) → additive ``[B, 1, 1, S]``
    of −inf and 0."""
    if key_padding_mask is None:
        return None
    return torch.zeros(key_padding_mask.shape, device=key_padding_mask.device
                       ).masked_fill(key_padding_mask, float("-inf")
                                     )[:, None, None, :]


def mmf_bert_encode(params: Params, cfg: MMFBertConfig,
                    input_ids: torch.Tensor, input_mask: torch.Tensor,
                    segment_ids: torch.Tensor,
                    image_features: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """mmf_bert.py:285-337 up to the joint embedding → (joint ``[B, S,
    D]``, text embedding). The image attentions take no key padding mask,
    as in the reference forward."""
    eps, H = cfg.layer_norm_eps, cfg.num_attention_heads
    emb = params["embeddings"]
    text = tbert.text_embeddings(emb, input_ids, segment_ids)
    text = layer_norm(text, emb["ln"]["scale"], emb["ln"]["bias"], eps)
    text_total, _ = multi_head_cross_attention(
        params["text_attention"], text, text, H,
        mask=_pad_bias(input_mask == 0))
    feats = []
    for p_attn, feat in zip(params["image_attentions"], image_features):
        enc = L.linear_fwd(params["image_projection"], feat)
        if cfg.image_intra_attention:
            enc, _ = multi_head_cross_attention(
                params["image_intra_attention"], enc, enc, H)
        out, _ = multi_head_cross_attention(p_attn, text_total, enc, H)
        feats.append(out)
    image_total = torch.cat(feats, dim=1)
    if cfg.combine_embeddings:
        joint = L.non_linear_element_multiply_fwd(params["combine"],
                                                  image_total, text_total)
    else:
        joint = image_total
    return joint, text_total


def mmf_bert_forward(params: Params, cfg: MMFBertConfig,
                     input_ids: torch.Tensor, input_mask: torch.Tensor,
                     segment_ids: torch.Tensor,
                     image_features: Sequence[torch.Tensor]):
    """mmf_bert.py:285-407: the head named by ``training_head_type``."""
    eps = cfg.layer_norm_eps
    joint, _ = mmf_bert_encode(params, cfg, input_ids, input_mask,
                               segment_ids, image_features)
    pooled = torch.tanh(joint[:, 0] @ params["pooler"]["w"].T
                        + params["pooler"]["b"])
    if "pretraining" in cfg.training_head_type:
        h = transform_fwd(params["cls"]["transform"], joint, eps)
        lm_logits = h @ params["embeddings"]["word"].T \
            + params["cls"]["decoder_bias"]
        return lm_logits, L.linear_fwd(params["cls"]["seq_relationship"],
                                       pooled)
    if cfg.training_head_type in ("vqa2", "vqa", "vizwiz"):
        idx = (input_mask.sum(1) - 2).long()
        gathered = joint[torch.arange(joint.shape[0],
                                      device=joint.device), idx][:, None]
        h = transform_fwd(params["classifier"]["transform"], gathered, eps)
        return L.linear_fwd(params["classifier"]["out"],
                            h).reshape(-1, cfg.answer_space_size)
    h = transform_fwd(params["classifier"]["transform"], pooled, eps)
    return L.linear_fwd(params["classifier"]["out"], h)
