"""MMFTransformer: the generic N-modality transformer, in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/mmf_transformer.py``
(``mmf/models/mmf_transformer.py`` with its huggingface backend). Each
modality has its own token embedding (a word table for text, a Linear + LN
projection for features) and position table, and a token-type row of a
table sized to the modality count; the LN'd embeddings are concatenated
and run through one BERT encoder, then a pooler, a prediction-head
transform and a linear head.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from transformer_mm_explainability_tpu_torch.models import bert as tbert
from transformer_mm_explainability_tpu_torch.models import mmf_layers as L
from transformer_mm_explainability_tpu_torch.models.mmf_bert import (
    init_transform,
    transform_fwd,
)
from transformer_mm_explainability_tpu_torch.ops.attention import layer_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Modality:
    key: str
    type: str                 # "text" | "image" | another feature stream
    segment_id: int = -1      # -1: no token-type embedding
    embedding_dim: int = 0    # feature width of a non-text modality
    position_dim: int = 512


@dataclasses.dataclass(frozen=True)
class MMFTransformerConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_labels: int = 2
    layer_norm_eps: float = 1e-12
    modalities: Tuple[Modality, ...] = (
        Modality("text", "text", 0),
        Modality("image", "image", 1, embedding_dim=2048),
    )

    def bert_cfg(self) -> tbert.BertConfig:
        return tbert.BertConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            intermediate_size=4 * self.hidden_size,
            layer_norm_eps=self.layer_norm_eps)


def init_mmf_transformer(seed: L.Seed, cfg: MMFTransformerConfig,
                         device="cuda") -> Params:
    gen = L.generator(seed)
    D = cfg.hidden_size
    per_mod = []
    for m in cfg.modalities:
        tok = ({"word": L.normal(gen, (cfg.vocab_size, D), 0.02, device)}
               if m.type == "text"
               else {"proj": L.init_linear(gen, m.embedding_dim, D, device),
                     "proj_ln": L.ln_init(D, device)})
        per_mod.append({"token": tok,
                        "position": L.normal(gen, (m.position_dim, D), 0.02,
                                             device),
                        "ln": L.ln_init(D, device)})
    return {
        "modalities": per_mod,
        "token_type": L.normal(gen, (len(cfg.modalities), D), 0.02, device),
        "encoder": tbert.init_encoder_params(gen, cfg.bert_cfg(), device),
        "pooler": {"w": L.normal(gen, (D, D), 0.02, device),
                   "b": torch.zeros(D, device=device)},
        "classifier": {"transform": init_transform(gen, D, device),
                       "out": L.init_linear(gen, D, cfg.num_labels, device)},
    }


def _modality_embedding(p: Params, m: Modality, x: torch.Tensor,
                        token_type: torch.Tensor, eps: float) -> torch.Tensor:
    """HuggingfaceEmbeddings.forward (huggingface.py:132-157) for one
    modality: token + position (+ token type when ``segment_id >= 0``),
    LN."""
    if m.type == "text":
        emb = p["token"]["word"][x.long()]
    else:
        emb = layer_norm(L.linear_fwd(p["token"]["proj"], x),
                         p["token"]["proj_ln"]["scale"],
                         p["token"]["proj_ln"]["bias"], eps)
    S = emb.shape[1]
    emb = emb + p["position"][:S][None]
    if m.segment_id >= 0:
        emb = emb + token_type[m.segment_id]
    return layer_norm(emb, p["ln"]["scale"], p["ln"]["bias"], eps)


def mmf_transformer_forward(params: Params, cfg: MMFTransformerConfig,
                            inputs: Sequence[torch.Tensor],
                            masks: Optional[Sequence[Optional[torch.Tensor]]]
                            = None) -> torch.Tensor:
    """MMFTransformer.forward (mmf_transformer.py:161-180) → scores
    ``[B, num_labels]``. ``inputs[i]`` are token ids ``[B, S_i]`` for text,
    features ``[B, S_i, embedding_dim]`` otherwise; ``masks[i]`` optional
    ``[B, S_i]`` {0, 1}, all ones by default."""
    eps = cfg.layer_norm_eps
    embs, mask_parts = [], []
    for i, m in enumerate(cfg.modalities):
        embs.append(_modality_embedding(params["modalities"][i], m,
                                        inputs[i], params["token_type"],
                                        eps))
        mask = None if masks is None else masks[i]
        if mask is None:
            mask = torch.ones(embs[-1].shape[:2], device=embs[-1].device)
        mask_parts.append(mask.to(torch.float32))
    x = torch.cat(embs, dim=1)
    bias = tbert.extended_attention_mask(torch.cat(mask_parts, dim=1),
                                         x.dtype)
    seq, _ = tbert.encoder(params["encoder"], x, cfg.bert_cfg(), mask=bias)
    pooled = torch.tanh(seq[:, 0] @ params["pooler"]["w"].T
                        + params["pooler"]["b"])
    h = transform_fwd(params["classifier"]["transform"], pooled, eps)
    return L.linear_fwd(params["classifier"]["out"], h)
