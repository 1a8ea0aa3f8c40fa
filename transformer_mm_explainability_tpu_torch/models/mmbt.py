"""MMBT (the supervised Multimodal Bitransformer), in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/mmbt.py``
(``mmf/models/mmbt.py``) on the port's BERT encoder. The modal stream is
[start?] + projected modal tokens + [end?] with the shared position and
token-type tables, concatenated in front of the text embeddings; one BERT
encoder and pooler run over the joint sequence. The modal encoder is
pluggable: pre-extracted features ``[B, N, modal_hidden]`` pass straight
in (a ResNet-152 grid comes from ``models/encoders``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from transformer_mm_explainability_tpu_torch.models import bert as tbert
from transformer_mm_explainability_tpu_torch.models import mmf_layers as L
from transformer_mm_explainability_tpu_torch.models.mmf_bert import (
    init_transform,
    transform_fwd,
)
from transformer_mm_explainability_tpu_torch.ops.attention import layer_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MMBTConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    modal_hidden_size: int = 2048
    num_labels: int = 2
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    use_modal_start_token: bool = True
    use_modal_end_token: bool = True

    def bert_cfg(self) -> tbert.BertConfig:
        return tbert.BertConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            intermediate_size=4 * self.hidden_size,
            max_position_embeddings=self.max_position_embeddings,
            type_vocab_size=self.type_vocab_size,
            layer_norm_eps=self.layer_norm_eps)


def init_mmbt(seed: L.Seed, cfg: MMBTConfig, device="cuda") -> Params:
    gen = L.generator(seed)
    D = cfg.hidden_size
    return {
        "embeddings": tbert.init_embedding_params(gen, cfg.bert_cfg(),
                                                  device),
        "encoder": tbert.init_encoder_params(gen, cfg.bert_cfg(), device),
        "pooler": {"w": L.normal(gen, (D, D), 0.02, device),
                   "b": torch.zeros(D, device=device)},
        "modal_proj": L.init_linear(gen, cfg.modal_hidden_size, D, device),
        "classifier": {"transform": init_transform(gen, D, device),
                       "out": L.init_linear(gen, D, cfg.num_labels, device)},
        # BertForPreTraining.cls: the LM decoder is tied to the word table
        "cls": {"transform": init_transform(gen, D, device),
                "decoder_bias": torch.zeros(cfg.vocab_size, device=device),
                "seq_relationship": {
                    "w": L.normal(gen, (2, D), 0.02, device),
                    "b": torch.zeros(2, device=device)}},
    }


def modal_embeddings(params: Params, cfg: MMBTConfig,
                     input_modal: torch.Tensor,
                     start_token: Optional[torch.Tensor],
                     end_token: Optional[torch.Tensor],
                     modal_token_type_ids: torch.Tensor) -> torch.Tensor:
    """ModalEmbeddings.forward (mmbt.py:73-118): project the modal
    features, wrap them in the word embeddings of the start and end
    tokens, add position and token-type embeddings, LN."""
    emb = params["embeddings"]
    parts = []
    if start_token is not None:
        parts.append(emb["word"][start_token.long()][:, None, :])
    parts.append(L.linear_fwd(params["modal_proj"], input_modal))
    if end_token is not None:
        parts.append(emb["word"][end_token.long()][:, None, :])
    tok = torch.cat(parts, dim=1)
    B, S, _ = tok.shape
    pos = emb["position"][:S][None]
    tt = emb["token_type"][modal_token_type_ids.long().expand(B, S)]
    return layer_norm(tok + pos + tt, emb["ln"]["scale"], emb["ln"]["bias"],
                      cfg.layer_norm_eps)


def mmbt_encode(params: Params, cfg: MMBTConfig,
                input_modal: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: torch.Tensor, token_type_ids: torch.Tensor,
                modal_start_token: Optional[torch.Tensor] = None,
                modal_end_token: Optional[torch.Tensor] = None,
                modal_token_type_ids: Optional[torch.Tensor] = None):
    """MMBTModel.forward (mmbt.py:164-306) → (sequence, pooled)."""
    emb = params["embeddings"]
    if modal_token_type_ids is None:
        modal_token_type_ids = torch.zeros(
            input_modal.shape[0], 1, dtype=torch.long,
            device=input_modal.device)
    modal = modal_embeddings(params, cfg, input_modal, modal_start_token,
                             modal_end_token, modal_token_type_ids)
    txt = tbert.text_embeddings(emb, input_ids, token_type_ids)
    txt = layer_norm(txt, emb["ln"]["scale"], emb["ln"]["bias"],
                     cfg.layer_norm_eps)
    x = torch.cat([modal, txt], dim=1)
    full_mask = torch.cat(
        [torch.ones(x.shape[0], modal.shape[1], device=x.device),
         attention_mask.to(x.dtype)], dim=1)
    seq, _ = tbert.encoder(params["encoder"], x, cfg.bert_cfg(),
                           mask=tbert.extended_attention_mask(full_mask,
                                                              x.dtype))
    pooled = torch.tanh(seq[:, 0] @ params["pooler"]["w"].T
                        + params["pooler"]["b"])
    return seq, pooled


def mmbt_for_classification(params: Params, cfg: MMBTConfig,
                            **inputs) -> torch.Tensor:
    """MMBTForClassification.forward (mmbt.py:531-553)."""
    _, pooled = mmbt_encode(params, cfg, **inputs)
    h = transform_fwd(params["classifier"]["transform"], pooled,
                      cfg.layer_norm_eps)
    return L.linear_fwd(params["classifier"]["out"], h)


def mmbt_for_pretraining(params: Params, cfg: MMBTConfig, **inputs):
    """MMBTForPreTraining.forward (mmbt.py:467-511): masked-LM logits
    (decoder tied to the word table) and the seq-relationship score."""
    seq, pooled = mmbt_encode(params, cfg, **inputs)
    h = transform_fwd(params["cls"]["transform"], seq, cfg.layer_norm_eps)
    lm_logits = h @ params["embeddings"]["word"].T \
        + params["cls"]["decoder_bias"]
    return lm_logits, L.linear_fwd(params["cls"]["seq_relationship"], pooled)


def mmbt_pretrain_losses(params: Params, cfg: MMBTConfig,
                         lm_label_ids: torch.Tensor,
                         image_text_alignment: Optional[torch.Tensor] = None,
                         **inputs) -> Dict[str, torch.Tensor]:
    """Masked-LM CE over the last ``len(lm_label_ids)`` positions (the text,
    mmbt.py:484-495), −1 ignored, and the alignment CE."""
    lm_logits, seq_rel = mmbt_for_pretraining(params, cfg, **inputs)
    T = lm_label_ids.shape[1]
    text_scores = lm_logits[:, -T:].reshape(-1, cfg.vocab_size)
    labels = lm_label_ids.reshape(-1).long()
    valid = labels != -1
    nll = F.cross_entropy(text_scores, labels.clamp(min=0), reduction="none")
    losses = {"masked_lm_loss": torch.where(valid, nll, torch.zeros_like(
        nll)).sum() / valid.sum().clamp(min=1)}
    if image_text_alignment is not None:
        losses["alignment_loss"] = F.cross_entropy(
            seq_rel, image_text_alignment.long())
    return losses
