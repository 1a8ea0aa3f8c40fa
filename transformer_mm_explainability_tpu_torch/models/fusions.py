"""MMF fusion and unimodal baselines (ConcatBERT, ConcatBoW, LateFusion,
UnimodalText, UnimodalModal), in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/fusions.py``
(``mmf/models/{fusions,unimodal}.py``). The text side is the port's BERT
(pooled output, the "transformer" text encoder) or a bag-of-words
embedding reduced by sum or product; the modal side is pre-extracted
features. The classifier is MMF's "mlp" type (``mmf_layers``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from transformer_mm_explainability_tpu_torch.models import bert as tbert
from transformer_mm_explainability_tpu_torch.models import mmf_layers as L
from transformer_mm_explainability_tpu_torch.ops.attention import layer_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    text_encoder: str = "transformer"     # "transformer" | "embedding"
    vocab_size: int = 30522
    text_hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    bow_operator: str = "sum"
    modal_hidden_size: int = 2048
    num_features: int = 1
    num_labels: int = 2
    classifier_hidden_dim: Optional[int] = 768
    classifier_num_layers: int = 0
    layer_norm_eps: float = 1e-12

    def bert_cfg(self) -> tbert.BertConfig:
        return tbert.BertConfig(
            vocab_size=self.vocab_size, hidden_size=self.text_hidden_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            intermediate_size=4 * self.text_hidden_size,
            layer_norm_eps=self.layer_norm_eps)


def init_text_encoder(seed: L.Seed, cfg: FusionConfig,
                      device="cuda") -> Params:
    gen = L.generator(seed)
    if cfg.text_encoder == "transformer":
        D = cfg.text_hidden_size
        return {
            "embeddings": tbert.init_embedding_params(gen, cfg.bert_cfg(),
                                                      device),
            "encoder": tbert.init_encoder_params(gen, cfg.bert_cfg(),
                                                 device),
            "pooler": {"w": L.normal(gen, (D, D), 0.02, device),
                       "b": torch.zeros(D, device=device)},
        }
    if cfg.text_encoder == "embedding":
        return {"word": L.normal(gen, (cfg.vocab_size, cfg.text_hidden_size),
                                 0.02, device)}
    raise ValueError(f"unknown text encoder {cfg.text_encoder!r}")


def bert_pooled(p: Params, cfg: tbert.BertConfig, input_ids: torch.Tensor,
                input_mask: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BERT embeddings (LN) → encoder → tanh pooler on the first token."""
    emb = p["embeddings"]
    x = tbert.text_embeddings(emb, input_ids, segment_ids)
    x = layer_norm(x, emb["ln"]["scale"], emb["ln"]["bias"],
                   cfg.layer_norm_eps)
    bias = (tbert.extended_attention_mask(input_mask, x.dtype)
            if input_mask is not None else None)
    seq, _ = tbert.encoder(p["encoder"], x, cfg, mask=bias)
    return torch.tanh(seq[:, 0] @ p["pooler"]["w"].T + p["pooler"]["b"])


def text_encode(params: Params, cfg: FusionConfig, text: torch.Tensor,
                input_mask: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FusionBase's text path (fusions.py:44-49)."""
    p = params["text"]
    if cfg.text_encoder == "transformer":
        return bert_pooled(p, cfg.bert_cfg(), text, input_mask, segment_ids)
    vecs = p["word"][text.long()]
    if cfg.bow_operator == "sum":
        return vecs.sum(dim=1)
    if cfg.bow_operator == "mul":
        return torch.prod(vecs, dim=1)
    raise ValueError(f"unknown bow operator {cfg.bow_operator!r}")


def _classifier_in_dim(cfg: FusionConfig, with_text: bool = True,
                       with_modal: bool = True) -> int:
    return ((cfg.num_features * cfg.modal_hidden_size if with_modal else 0)
            + (cfg.text_hidden_size if with_text else 0))


def _mlp(gen, cfg: FusionConfig, in_dim: int, device) -> Params:
    return L.init_mlp_classifier(gen, in_dim, cfg.num_labels,
                                 cfg.classifier_hidden_dim,
                                 cfg.classifier_num_layers, device)


def init_concat(seed: L.Seed, cfg: FusionConfig, device="cuda") -> Params:
    """ConcatBERT / ConcatBoW (fusions.py:57-148): the config's text
    encoder decides which."""
    gen = L.generator(seed)
    return {"text": init_text_encoder(gen, cfg, device),
            "classifier": _mlp(gen, cfg, _classifier_in_dim(cfg), device)}


def concat_forward(params: Params, cfg: FusionConfig, text: torch.Tensor,
                   modal: torch.Tensor,
                   input_mask: Optional[torch.Tensor] = None,
                   segment_ids: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """ConcatBERT.forward (fusions.py:100-113)."""
    t = text_encode(params, cfg, text, input_mask, segment_ids)
    m = modal.reshape(modal.shape[0], -1)
    return L.mlp_classifier_fwd(params["classifier"], torch.cat([t, m], -1))


def init_late_fusion(seed: L.Seed, cfg: FusionConfig,
                     device="cuda") -> Params:
    gen = L.generator(seed)
    return {"text": init_text_encoder(gen, cfg, device),
            "text_classifier": _mlp(
                gen, cfg, _classifier_in_dim(cfg, with_modal=False), device),
            "modal_classifier": _mlp(
                gen, cfg, _classifier_in_dim(cfg, with_text=False), device)}


def late_fusion_forward(params: Params, cfg: FusionConfig,
                        text: torch.Tensor, modal: torch.Tensor,
                        input_mask: Optional[torch.Tensor] = None,
                        segment_ids: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """LateFusion.forward (fusions.py:177-194): the mean of the two
    classifiers' scores."""
    t = text_encode(params, cfg, text, input_mask, segment_ids)
    m = modal.reshape(modal.shape[0], -1)
    return (L.mlp_classifier_fwd(params["text_classifier"], t)
            + L.mlp_classifier_fwd(params["modal_classifier"], m)) / 2.0


def init_unimodal_text(seed: L.Seed, cfg: FusionConfig,
                       device="cuda") -> Params:
    gen = L.generator(seed)
    return {"text": init_text_encoder(gen, cfg, device),
            "classifier": _mlp(gen, cfg, cfg.text_hidden_size, device)}


def unimodal_text_forward(params: Params, cfg: FusionConfig,
                          text: torch.Tensor,
                          input_mask: Optional[torch.Tensor] = None,
                          segment_ids: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """UnimodalText.forward (unimodal.py:57-70)."""
    return L.mlp_classifier_fwd(
        params["classifier"],
        text_encode(params, cfg, text, input_mask, segment_ids))


def init_unimodal_image(seed: L.Seed, cfg: FusionConfig,
                        device="cuda") -> Params:
    return {"classifier": _mlp(L.generator(seed), cfg,
                               cfg.num_features * cfg.modal_hidden_size,
                               device)}


def unimodal_image_forward(params: Params, cfg: FusionConfig,
                           modal: torch.Tensor,
                           direct_features: bool = True) -> torch.Tensor:
    """UnimodalModal.forward (unimodal.py:94-106): direct features are
    mean-pooled over boxes, then flattened."""
    if direct_features and modal.dim() == 3:
        modal = modal.mean(dim=1)
    return L.mlp_classifier_fwd(params["classifier"],
                                modal.reshape(modal.shape[0], -1))
