"""The MMF model zoo: Pythia (and its question-only, image-only and
multi-head variants), LoRRA, BAN, BUTD, CNN-LSTM and TopDownBottomUp, in
PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/mmf_zoo.py``
(``mmf/models/{pythia,lorra,ban,butd,cnn_lstm,top_down_bottom_up}.py``).
Each model is an ``init_<name>(seed, cfg, device)`` tree builder and a
``<name>_forward`` over explicit tensors in place of MMF's sample list.
BUTD decodes in a Python loop over timesteps with its two LSTM states
carried explicitly (the reference keeps them in a registry side channel;
the JAX package scans them), at a fixed batch without the reference's
shrinking ``batch_size_t``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from transformer_mm_explainability_tpu_torch.models import mmf_layers as L

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Pythia (pythia.py:19-310)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PythiaConfig:
    vocab_size: int = 100
    num_answers: int = 10
    embedding_dim: int = 300
    # text attention embedding (configs/models/pythia/defaults.yaml)
    text_hidden_dim: int = 1024
    conv1_out: int = 512
    conv2_out: int = 2
    # image streams: "finetune" = fc7 Linear + ReLU, "default" = identity
    image_feature_dim: int = 2048
    image_encoders: Sequence[str] = ("finetune", "default")
    combine_hidden_dim: int = 5000
    classifier_text_hidden: int = 300
    classifier_img_hidden: int = 5000

    @property
    def text_out_dim(self) -> int:
        return self.text_hidden_dim * self.conv2_out

    @property
    def image_out_dim(self) -> int:
        return len(self.image_encoders) * self.image_feature_dim


def _init_image_encoder(gen, kind: str, feat_dim: int, device) -> Params:
    """The encoder kind is config; FinetuneFasterRcnnFpnFc7 → ImageFinetune
    (embeddings.py:285-302) is a Linear + ReLU."""
    if kind == "finetune":
        return {"lc": L.init_linear(gen, feat_dim, feat_dim, device)}
    if kind == "default":
        return {}
    raise ValueError(f"unknown image encoder {kind!r}")


def _image_encoder_fwd(p: Params, feat: torch.Tensor,
                       kind: str) -> torch.Tensor:
    if kind == "finetune":
        return torch.relu(L.linear_fwd(p["lc"], feat))
    return feat


def _init_feature_stream(gen, feat_dim: int, text_dim: int,
                         hidden_dim: int, device) -> Params:
    """One ImageFeatureEmbedding: NonLinearElementMultiply combine, a
    weight-norm transform to one glimpse, softmax."""
    return {"combine": L.init_non_linear_element_multiply(
                gen, feat_dim, text_dim, hidden_dim, device=device),
            "transform": L.init_weight_norm_fc(gen, hidden_dim, 1, device)}


def _feature_stream_fwd(p: Params, feat: torch.Tensor, text: torch.Tensor,
                        locs: Optional[torch.Tensor],
                        normalization: str = "softmax",
                        order_vectors: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    combined = L.non_linear_element_multiply_fwd(p["combine"], feat, text)
    att = L.top_down_attention_fwd(combined, p["transform"], normalization,
                                   locs)
    return L.image_feature_embedding_fwd(att, feat,
                                         order_vectors=order_vectors)


def init_pythia(seed: L.Seed, cfg: PythiaConfig, device="cuda") -> Params:
    gen = L.generator(seed)
    word = L.normal(gen, (cfg.vocab_size, cfg.embedding_dim), device=device)
    text = L.init_attention_text_embedding(
        gen, cfg.text_hidden_dim, cfg.embedding_dim, cfg.conv1_out,
        cfg.conv2_out, device=device)
    encs = [_init_image_encoder(gen, kind, cfg.image_feature_dim, device)
            for kind in cfg.image_encoders]
    streams = [_init_feature_stream(gen, cfg.image_feature_dim,
                                    cfg.text_out_dim, cfg.combine_hidden_dim,
                                    device) for _ in cfg.image_encoders]
    return {
        "word_embedding": word,
        "text_embedding": text,
        "image_encoders": encs,
        "image_streams": streams,
        "combine": L.init_non_linear_element_multiply(
            gen, cfg.image_out_dim, cfg.text_out_dim,
            cfg.combine_hidden_dim, device=device),
        "classifier": L.init_logit_classifier(
            gen, cfg.combine_hidden_dim, cfg.num_answers,
            cfg.classifier_text_hidden, cfg.classifier_img_hidden, device),
    }


def pythia_process_text(params: Params, text_tokens: torch.Tensor
                        ) -> torch.Tensor:
    vecs = params["word_embedding"][text_tokens.long()]
    return L.attention_text_embedding_fwd(params["text_embedding"], vecs)


def pythia_process_image(params: Params, cfg: PythiaConfig,
                         image_features: Sequence[torch.Tensor],
                         text_embedding: torch.Tensor,
                         image_locs: Optional[Sequence] = None
                         ) -> Tuple[torch.Tensor, list]:
    """process_feature_embedding (pythia.py:214-281) for the image
    modality: encode each stream, attend, concatenate."""
    if image_locs is None:
        image_locs = [None] * len(image_features)
    embs, atts = [], []
    for enc_p, stream_p, feat, locs, kind in zip(
            params["image_encoders"], params["image_streams"],
            image_features, image_locs, cfg.image_encoders):
        emb, att = _feature_stream_fwd(
            stream_p, _image_encoder_fwd(enc_p, feat, kind), text_embedding,
            locs)
        embs.append(emb)
        atts.append(att[..., 0])
    return torch.cat(embs, dim=1), atts


def pythia_forward(params: Params, cfg: PythiaConfig,
                   text_tokens: torch.Tensor,
                   image_features: Sequence[torch.Tensor],
                   image_locs: Optional[Sequence] = None) -> torch.Tensor:
    """Pythia.forward (pythia.py:293-310) → answer scores ``[B, A]``."""
    text_total = pythia_process_text(params, text_tokens)
    image_total, _ = pythia_process_image(params, cfg, image_features,
                                          text_total, image_locs)
    joint = L.non_linear_element_multiply_fwd(params["combine"],
                                              image_total, text_total)
    return L.logit_classifier_fwd(params["classifier"], joint)


def pythia_question_only_forward(params: Params, cfg: PythiaConfig,
                                 text_tokens: torch.Tensor) -> torch.Tensor:
    """PythiaQuestionOnly.forward (pythia.py:314-336): a zeroed text
    embedding through the text branch only."""
    zeros = torch.zeros_like(pythia_process_text(params, text_tokens))
    joint = torch.relu(L.weight_norm_fc_fwd(params["combine"]["fa_txt"],
                                            zeros))
    cls = params["classifier"]
    return L.linear_fwd(cls["linear_text"],
                        L.relu_weight_norm_fc_fwd(cls["f_o_text"], joint))


def pythia_image_only_forward(params: Params, cfg: PythiaConfig,
                              text_tokens: torch.Tensor,
                              image_features: Sequence[torch.Tensor],
                              image_locs=None) -> torch.Tensor:
    """PythiaImageOnly.forward (pythia.py:340-365)."""
    zeros = torch.zeros_like(pythia_process_text(params, text_tokens))
    image_total, _ = pythia_process_image(params, cfg, image_features,
                                          zeros, image_locs)
    joint = torch.relu(L.weight_norm_fc_fwd(params["combine"]["fa_image"],
                                            image_total))
    return L.logit_classifier_fwd(params["classifier"], joint)


# ---------------------------------------------------------------------------
# PythiaMultiHead, registry name "multihead" (pythia.py:368-505)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PythiaMultiHeadConfig(PythiaConfig):
    """Pythia with per-stream feature projectors and multi-head attention
    feature embeddings (embeddings.py:264-282)."""
    projection_dim: int = 1024
    num_attention_heads: int = 4
    embeddings_per_stream: int = 1

    @property
    def image_out_dim(self) -> int:
        return (len(self.image_encoders) * self.embeddings_per_stream
                * self.text_out_dim)


def init_pythia_multihead(seed: L.Seed, cfg: PythiaMultiHeadConfig,
                          device="cuda") -> Params:
    """PythiaMultiHead.build (pythia.py:375-399)."""
    gen = L.generator(seed)
    word = L.normal(gen, (cfg.vocab_size, cfg.embedding_dim), device=device)
    text = L.init_attention_text_embedding(
        gen, cfg.text_hidden_dim, cfg.embedding_dim, cfg.conv1_out,
        cfg.conv2_out, device=device)
    encs, projs, embs = [], [], []
    for kind in cfg.image_encoders:
        encs.append(_init_image_encoder(gen, kind, cfg.image_feature_dim,
                                        device))
        projs.append({"lc": L.init_linear(gen, cfg.image_feature_dim,
                                          cfg.projection_dim, device)})
        embs.append([L.init_multi_head_image_feature_embedding(
            gen, cfg.projection_dim, cfg.text_out_dim,
            cfg.num_attention_heads, device)
            for _ in range(cfg.embeddings_per_stream)])
    return {
        "word_embedding": word,
        "text_embedding": text,
        "image_encoders": encs,
        "image_projectors": projs,
        "image_embeddings": embs,
        "combine": L.init_non_linear_element_multiply(
            gen, cfg.image_out_dim, cfg.text_out_dim,
            cfg.combine_hidden_dim, device=device),
        "classifier": L.init_logit_classifier(
            gen, cfg.combine_hidden_dim, cfg.num_answers,
            cfg.classifier_text_hidden, cfg.classifier_img_hidden, device),
    }


def pythia_multihead_forward(params: Params, cfg: PythiaMultiHeadConfig,
                             text_tokens: torch.Tensor,
                             image_features: Sequence[torch.Tensor]
                             ) -> torch.Tensor:
    """PythiaMultiHead.process_feature_embedding (pythia.py:435-505):
    encode → project → attend with the question as query → concatenate,
    then Pythia's combine and classifier."""
    text_total = pythia_process_text(params, text_tokens)
    embs = []
    for enc_p, proj_p, emb_ps, feat, kind in zip(
            params["image_encoders"], params["image_projectors"],
            params["image_embeddings"], image_features, cfg.image_encoders):
        projected = L.linear_fwd(proj_p["lc"],
                                 _image_encoder_fwd(enc_p, feat, kind))
        for emb_p in emb_ps:
            emb, _ = L.multi_head_image_feature_embedding_fwd(
                emb_p, projected, text_total, cfg.num_attention_heads)
            embs.append(emb)
    joint = L.non_linear_element_multiply_fwd(
        params["combine"], torch.cat(embs, dim=1), text_total)
    return L.logit_classifier_fwd(params["classifier"], joint)


# ---------------------------------------------------------------------------
# LoRRA (lorra.py:8-64): Pythia and an OCR context stream
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LorraConfig(PythiaConfig):
    context_feature_dim: int = 300
    context_max_len: int = 50
    order_vector_dim: int = 50   # context_dim 350 = 300 fasttext + 50 order

    @property
    def context_out_dim(self) -> int:
        return self.context_feature_dim + self.order_vector_dim


def init_lorra(seed: L.Seed, cfg: LorraConfig, device="cuda") -> Params:
    gen = L.generator(seed)
    params = init_pythia(gen, cfg, device)
    params["context_stream"] = _init_feature_stream(
        gen, cfg.context_feature_dim, cfg.text_out_dim,
        cfg.combine_hidden_dim, device)
    params["combine"]["fa_context"] = L.init_weight_norm_fc(
        gen, cfg.context_out_dim, cfg.combine_hidden_dim, device)
    # [image·txt ‖ context·txt] doubles the joint embedding
    params["classifier"] = L.init_logit_classifier(
        gen, 2 * cfg.combine_hidden_dim, cfg.num_answers,
        cfg.classifier_text_hidden, cfg.classifier_img_hidden, device)
    return params


def lorra_forward(params: Params, cfg: LorraConfig,
                  text_tokens: torch.Tensor,
                  image_features: Sequence[torch.Tensor],
                  context_features: torch.Tensor,
                  order_vectors: torch.Tensor, image_locs=None,
                  context_locs: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """LoRRA.forward (lorra.py:42-64): image and OCR-context streams (the
    context with sigmoid attention over order-augmented features) into the
    context-augmented combine."""
    text_total = pythia_process_text(params, text_tokens)
    image_total, _ = pythia_process_image(params, cfg, image_features,
                                          text_total, image_locs)
    context_total, _ = _feature_stream_fwd(
        params["context_stream"], context_features, text_total,
        context_locs, normalization="sigmoid", order_vectors=order_vectors)
    joint = L.non_linear_element_multiply_fwd(
        params["combine"], image_total, text_total,
        context_embedding=context_total)
    return L.logit_classifier_fwd(params["classifier"], joint)


# ---------------------------------------------------------------------------
# BAN (ban.py:10-97)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BanConfig:
    vocab_size: int = 100
    num_answers: int = 10
    embedding_dim: int = 300
    num_hidden: int = 1280
    rnn_type: str = "GRU"
    bidirectional: bool = False
    visual_feat_dim: int = 2048
    gamma: int = 4
    bc_k: int = 1


def init_ban(seed: L.Seed, cfg: BanConfig, device="cuda") -> Params:
    gen = L.generator(seed)
    H = cfg.num_hidden
    return {
        "word_embedding": L.normal(gen, (cfg.vocab_size, cfg.embedding_dim),
                                   device=device),
        "q_emb": L.init_bilstm_text_embedding(
            gen, H, cfg.embedding_dim, cfg.bidirectional, cfg.rnn_type,
            device),
        "v_att": L.init_bi_attention(gen, cfg.visual_feat_dim, H, H,
                                     cfg.gamma, k=3, device=device),
        "b_net": [L.init_bc_net(gen, cfg.visual_feat_dim, H, H, None,
                                k=cfg.bc_k, device=device)
                  for _ in range(cfg.gamma)],
        "q_prj": [L.init_fc_net(gen, [H, H], None, device)
                  for _ in range(cfg.gamma)],
        "classifier": L.init_weight_norm_classifier(
            gen, H, cfg.num_answers, H * 2, device),
    }


def ban_forward(params: Params, cfg: BanConfig, text_tokens: torch.Tensor,
                image_features: torch.Tensor) -> torch.Tensor:
    """BAN.forward (ban.py:81-97): glimpse-chained bilinear attention."""
    q = params["word_embedding"][text_tokens.long()]
    q_emb = L.bilstm_text_embedding_forward_all(params["q_emb"], q,
                                                cfg.rnn_type)
    att, _ = L.bi_attention_forward_all(params["v_att"], image_features,
                                        q_emb)
    for g in range(cfg.gamma):
        b_emb = L.bc_net_forward_with_weights(
            params["b_net"][g], image_features, q_emb, att[:, g], k=cfg.bc_k)
        q_emb = L.fc_net_fwd(params["q_prj"][g], b_emb[:, None, :],
                             act=None) + q_emb
    return L.weight_norm_classifier_fwd(params["classifier"],
                                        q_emb.sum(dim=1))


# ---------------------------------------------------------------------------
# BUTD (butd.py:9-179): captioning with the dual-LSTM top-down attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ButdConfig:
    vocab_size: int = 100
    embedding_dim: int = 300
    image_feature_dim: int = 2048
    hidden_dim: int = 1024
    attention_dim: int = 1024
    max_length: int = 20
    sos_index: int = 1


def init_butd(seed: L.Seed, cfg: ButdConfig, device="cuda") -> Params:
    gen = L.generator(seed)
    return {
        "word_embedding": L.normal(gen, (cfg.vocab_size, cfg.embedding_dim),
                                   device=device),
        "encoder": _init_image_encoder(gen, "finetune",
                                       cfg.image_feature_dim, device),
        "td_attn": L.init_top_down_attention_lstm(
            gen, cfg.image_feature_dim, cfg.embedding_dim, cfg.hidden_dim,
            cfg.attention_dim, device),
        "transform": L.init_weight_norm_fc(gen, cfg.attention_dim, 1,
                                           device),
        "decoder": L.init_language_decoder(
            gen, cfg.image_feature_dim, cfg.vocab_size, cfg.hidden_dim,
            device=device),
    }


def _butd_step(params: Params, feat: torch.Tensor, token: torch.Tensor,
               h1, c1, h2, c2):
    """One decode timestep (butd.py:146-155) with both LSTM states
    explicit → (logits, h1, c1, h2, c2)."""
    emb = params["word_embedding"][token.long()]
    joint, h1, c1 = L.top_down_attention_lstm_fwd(params["td_attn"], feat,
                                                  emb, h1, c1, h2)
    att = L.top_down_attention_fwd(joint, params["transform"], "softmax")
    attended, _ = L.image_feature_embedding_fwd(att, feat)
    logits, h2, c2 = L.language_decoder_fwd(params["decoder"], attended, h1,
                                            h2, c2)
    return logits, h1, c1, h2, c2


def butd_forward(params: Params, cfg: ButdConfig,
                 image_feature_0: torch.Tensor,
                 teacher_tokens: Optional[torch.Tensor] = None,
                 timesteps: Optional[int] = None) -> torch.Tensor:
    """BUTD.forward (butd.py:118-163): teacher forcing on ``teacher_tokens
    [B, T]``, else greedy decoding from SOS (inference type "greedy") →
    scores ``[B, T, vocab]``."""
    feat = _image_encoder_fwd(params["encoder"], image_feature_0, "finetune")
    B = feat.shape[0]
    zeros = feat.new_zeros(B, cfg.hidden_dim)
    if timesteps is None:
        timesteps = (teacher_tokens.shape[1] if teacher_tokens is not None
                     else cfg.max_length)
    h1 = c1 = h2 = c2 = zeros
    token = torch.full((B,), cfg.sos_index, dtype=torch.long,
                       device=feat.device)
    scores = []
    for t in range(timesteps):
        if teacher_tokens is not None:
            token = teacher_tokens[:, t]
        logits, h1, c1, h2, c2 = _butd_step(params, feat, token, h1, c1, h2,
                                            c2)
        scores.append(logits)
        token = logits.argmax(dim=-1)
    return torch.stack(scores, dim=1)


# ---------------------------------------------------------------------------
# the CNN-LSTM baseline (cnn_lstm.py:20-102)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CnnLstmConfig:
    vocab_size: int = 100
    num_answers: int = 2
    embedding_dim: int = 20
    lstm_hidden: int = 50
    cnn_input_dims: Sequence[int] = (3, 64, 128, 128, 64, 64)
    cnn_output_dims: Sequence[int] = (64, 128, 128, 64, 64, 10)
    cnn_kernel_sizes: Sequence[int] = (7, 5, 5, 5, 5, 1)
    classifier_in_dim: int = 450


def init_cnn_lstm(seed: L.Seed, cfg: CnnLstmConfig, device="cuda"
                  ) -> Params:
    gen = L.generator(seed)
    return {
        "word_embedding": L.normal(gen, (cfg.vocab_size, cfg.embedding_dim),
                                   device=device),
        "lstm": L.init_birnn(gen, L.init_lstm, cfg.embedding_dim,
                             cfg.lstm_hidden, bidirectional=True,
                             device=device),
        "cnn": [L.init_conv_net(gen, i, o, k, device) for i, o, k in zip(
            cfg.cnn_input_dims, cfg.cnn_output_dims, cfg.cnn_kernel_sizes)],
        "classifier": L.init_mlp_classifier(gen, cfg.classifier_in_dim,
                                            cfg.num_answers, device=device),
    }


def cnn_lstm_forward(params: Params, cfg: CnnLstmConfig,
                     text_tokens: torch.Tensor,
                     image: torch.Tensor) -> torch.Tensor:
    """CNNLSTM.forward (cnn_lstm.py:82-102); ``image`` is NCHW. The text
    summary is torch's h_n: the forward state at t = −1 and the backward
    state at t = 0."""
    emb = params["word_embedding"][text_tokens.long()]
    out = L.birnn_fwd(params["lstm"], "lstm", emb)
    H = out.shape[-1] // 2
    x = image
    for conv_p in params["cnn"]:
        x = L.conv_net_fwd(conv_p, x)
    fused = torch.cat([out[:, -1, :H], out[:, 0, H:],
                       x.reshape(x.shape[0], -1)], dim=-1)
    return L.mlp_classifier_fwd(params["classifier"], fused)


# ---------------------------------------------------------------------------
# TopDownBottomUp (top_down_bottom_up.py:9-61)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TdbuConfig:
    vocab_size: int = 100
    num_answers: int = 10
    embedding_dim: int = 300
    text_hidden_dim: int = 1024
    conv1_out: int = 512
    conv2_out: int = 2
    image_feature_dim: int = 2048
    attention_hidden: int = 512
    joint_dim: int = 1024
    classifier_hidden: int = 2048

    @property
    def text_out_dim(self) -> int:
        return self.text_hidden_dim * self.conv2_out


def init_tdbu(seed: L.Seed, cfg: TdbuConfig, device="cuda") -> Params:
    gen = L.generator(seed)
    return {
        "word_embedding": L.normal(gen, (cfg.vocab_size, cfg.embedding_dim),
                                   device=device),
        "text_embedding": L.init_attention_text_embedding(
            gen, cfg.text_hidden_dim, cfg.embedding_dim, cfg.conv1_out,
            cfg.conv2_out, device=device),
        "image_attention": L.init_project_attention(
            gen, cfg.image_feature_dim, cfg.text_out_dim,
            cfg.attention_hidden, device),
        "non_linear_text": L.init_relu_weight_norm_fc(
            gen, cfg.text_out_dim, cfg.joint_dim, device),
        "non_linear_image": L.init_relu_weight_norm_fc(
            gen, cfg.image_feature_dim, cfg.joint_dim, device),
        "classifier": L.init_weight_norm_classifier(
            gen, cfg.joint_dim, cfg.num_answers, cfg.classifier_hidden,
            device),
    }


def tdbu_forward(params: Params, cfg: TdbuConfig, text_tokens: torch.Tensor,
                 image_features: torch.Tensor) -> torch.Tensor:
    """TopDownBottomUp.forward (top_down_bottom_up.py:32-61)."""
    vecs = params["word_embedding"][text_tokens.long()]
    text = L.attention_text_embedding_fwd(params["text_embedding"], vecs)
    att = L.project_attention_fwd(params["image_attention"], image_features,
                                  text)
    image = (att * image_features).sum(dim=1)
    joint = (L.relu_weight_norm_fc_fwd(params["non_linear_text"], text)
             * L.relu_weight_norm_fc_fwd(params["non_linear_image"], image))
    return L.weight_norm_classifier_fwd(params["classifier"], joint)
