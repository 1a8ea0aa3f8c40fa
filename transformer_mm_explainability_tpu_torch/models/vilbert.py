"""ViLBERT: the two-stream co-attentional transformer, in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/vilbert.py``
(``mmf/models/vilbert.py``): text layers, image layers (with the optional
dynamic-attention gates), co-attention connection layers on the
``v_biattention_id`` × ``t_biattention_id`` schedule, the poolers, the
classification head (NLVR2 pairs the pooled vectors) and the pretraining
heads and losses. Every forward can return the text, image and co-
attention probabilities (``collect_attn``). ``fixed_t_layer`` /
``fixed_v_layer`` detach those layers' outputs, as the reference's
``torch.no_grad`` reruns do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from transformer_mm_explainability_tpu_torch.models import bert as tbert
from transformer_mm_explainability_tpu_torch.models import mmf_layers as L
from transformer_mm_explainability_tpu_torch.models.mmf_bert import (
    init_transform,
    transform_fwd,
)
from transformer_mm_explainability_tpu_torch.ops.attention import (
    gelu,
    layer_norm,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViLBERTConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    v_feature_size: int = 2048
    v_target_size: int = 1601
    v_hidden_size: int = 1024
    v_num_hidden_layers: int = 6
    v_num_attention_heads: int = 8
    v_intermediate_size: int = 1024
    bi_hidden_size: int = 1024
    bi_num_attention_heads: int = 8
    v_biattention_id: Tuple[int, ...] = (0, 1, 2, 3, 4, 5)
    t_biattention_id: Tuple[int, ...] = (6, 7, 8, 9, 10, 11)
    fusion_method: str = "mul"
    with_coattention: bool = True
    dynamic_attention: bool = False
    fixed_t_layer: int = 0
    fixed_v_layer: int = 0
    num_labels: int = 3129
    training_head_type: str = "vqa2"
    layer_norm_eps: float = 1e-12


def _attn_block(gen, d: int, d_mid: int, device) -> Params:
    lin = lambda i, o: L.init_linear(gen, i, o, device)
    return {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d),
            "out": lin(d, d), "out_ln": L.ln_init(d, device),
            "inter": lin(d, d_mid), "ffn_out": lin(d_mid, d),
            "ffn_ln": L.ln_init(d, device)}


def init_vilbert(seed: L.Seed, cfg: ViLBERTConfig, device="cuda") -> Params:
    gen = L.generator(seed)
    D, V, BI = cfg.hidden_size, cfg.v_hidden_size, cfg.bi_hidden_size
    lin = lambda i, o: L.init_linear(gen, i, o, device)
    t_layers = [_attn_block(gen, D, cfg.intermediate_size, device)
                for _ in range(cfg.num_hidden_layers)]
    v_layers = []
    for _ in range(cfg.v_num_hidden_layers):
        blk = _attn_block(gen, V, cfg.v_intermediate_size, device)
        if cfg.dynamic_attention:
            blk["dy_q"] = lin(D, V)
            blk["dy_k"] = lin(D, V)
        v_layers.append(blk)
    c_layers = [{
        # BertBiAttention (vilbert.py:389-401): stream 1 is the vision one
        "q1": lin(V, BI), "k1": lin(V, BI), "v1": lin(V, BI),
        "q2": lin(D, BI), "k2": lin(D, BI), "v2": lin(D, BI),
        # BertBiOutput (vilbert.py:539-575)
        "dense1": lin(BI, V), "ln1": L.ln_init(V, device),
        "dense2": lin(BI, D), "ln2": L.ln_init(D, device),
        "v_inter": lin(V, cfg.v_intermediate_size),
        "v_out": lin(cfg.v_intermediate_size, V),
        "v_ln": L.ln_init(V, device),
        "t_inter": lin(D, cfg.intermediate_size),
        "t_out": lin(cfg.intermediate_size, D),
        "t_ln": L.ln_init(D, device),
    } for _ in cfg.v_biattention_id]
    bert_cfg = tbert.BertConfig(
        vocab_size=cfg.vocab_size, hidden_size=D,
        max_position_embeddings=cfg.max_position_embeddings,
        type_vocab_size=cfg.type_vocab_size,
        layer_norm_eps=cfg.layer_norm_eps)
    return {
        "embeddings": tbert.init_embedding_params(gen, bert_cfg, device),
        "v_embeddings": {"image": lin(cfg.v_feature_size, V),
                         "loc": lin(5, V), "ln": L.ln_init(V, device)},
        "t_layers": t_layers, "v_layers": v_layers, "c_layers": c_layers,
        "t_pooler": lin(D, BI),
        "v_pooler": lin(V, BI),
        "classifier": {"transform": init_transform(gen, BI, device),
                       "out": lin(BI, cfg.num_labels)},
        "cls": {  # BertPreTrainingHeads (vilbert.py:926-954)
            "lm_transform": init_transform(gen, D, device),
            "lm_bias": torch.zeros(cfg.vocab_size, device=device),
            "bi_seq_relationship": lin(BI, 2),
            "img_transform": init_transform(gen, V, device),
            "img_decoder": lin(V, cfg.v_target_size),
        },
    }


def _heads_split(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, S, D = x.shape
    return x.reshape(B, S, n_heads, D // n_heads).transpose(1, 2)


def _mha(q, k, v, mask_bias):
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if mask_bias is not None:
        scores = scores + mask_bias
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    B, H, S, Dh = ctx.shape
    return ctx.transpose(1, 2).reshape(B, S, H * Dh), probs


def _ln(x, p, eps):
    return layer_norm(x, p["scale"], p["bias"], eps)


def _post_ln_tail(p, attn_out, x, eps):
    h = _ln(L.linear_fwd(p["out"], attn_out) + x, p["out_ln"], eps)
    m = gelu(L.linear_fwd(p["inter"], h))
    return _ln(L.linear_fwd(p["ffn_out"], m) + h, p["ffn_ln"], eps)


def text_layer(p: Params, x: torch.Tensor, mask_bias, n_heads: int,
               eps: float):
    """BertLayer (vilbert.py:134-154) → (hidden, probs)."""
    q, k, v = (_heads_split(L.linear_fwd(p[n], x), n_heads)
               for n in ("q", "k", "v"))
    attn_out, probs = _mha(q, k, v, mask_bias)
    return _post_ln_tail(p, attn_out, x, eps), probs


def image_layer(p: Params, x: torch.Tensor, mask_bias, txt: torch.Tensor,
                txt_mask2, n_heads: int, eps: float,
                dynamic_attention: bool = False):
    """BertImageLayer (vilbert.py:336-368) with the optional dynamic-
    attention gates (vilbert.py:218-232)."""
    mq = L.linear_fwd(p["q"], x)
    mk = L.linear_fwd(p["k"], x)
    if dynamic_attention and "dy_q" in p:
        pool = (txt * txt_mask2).sum(1) / txt_mask2.sum(1)
        mq = mq * (1.0 + torch.sigmoid(L.linear_fwd(p["dy_q"], pool))
                   )[:, None, :]
        mk = mk * (1.0 + torch.sigmoid(L.linear_fwd(p["dy_k"], pool))
                   )[:, None, :]
    attn_out, probs = _mha(_heads_split(mq, n_heads),
                           _heads_split(mk, n_heads),
                           _heads_split(L.linear_fwd(p["v"], x), n_heads),
                           mask_bias)
    return _post_ln_tail(p, attn_out, x, eps), probs


def connection_layer(p: Params, v_in: torch.Tensor, v_mask_bias,
                     t_in: torch.Tensor, t_mask_bias, n_heads: int,
                     eps: float):
    """BertConnectionLayer (vilbert.py:577-620): bi-attention, then each
    stream's output and FFN → (v_out, t_out, (probs_tq, probs_vq))."""
    sp = lambda name, x: _heads_split(L.linear_fwd(p[name], x), n_heads)
    q1, k1, v1 = sp("q1", v_in), sp("k1", v_in), sp("v1", v_in)
    q2, k2, v2 = sp("q2", t_in), sp("k2", t_in), sp("v2", t_in)
    ctx1, probs1 = _mha(q2, k1, v1, v_mask_bias)   # text queries, image keys
    ctx2, probs2 = _mha(q1, k2, v2, t_mask_bias)   # image queries, text keys
    h_v = _ln(L.linear_fwd(p["dense1"], ctx2) + v_in, p["ln1"], eps)
    h_t = _ln(L.linear_fwd(p["dense2"], ctx1) + t_in, p["ln2"], eps)
    out_v = _ln(L.linear_fwd(p["v_out"], gelu(L.linear_fwd(p["v_inter"],
                                                           h_v))) + h_v,
                p["v_ln"], eps)
    out_t = _ln(L.linear_fwd(p["t_out"], gelu(L.linear_fwd(p["t_inter"],
                                                           h_t))) + h_t,
                p["t_ln"], eps)
    return out_v, out_t, (probs1, probs2)


def vilbert_encoder(params: Params, cfg: ViLBERTConfig, txt: torch.Tensor,
                    img: torch.Tensor, t_bias, t_mask2, v_bias,
                    collect_attn: bool = False):
    """BertEncoder.forward's schedule (vilbert.py:653-861)."""
    eps = cfg.layer_norm_eps
    attn_t: List = []
    attn_v: List = []
    attn_c: List = []

    def run_t(i, txt):
        txt, pa = text_layer(params["t_layers"][i], txt, t_bias,
                             cfg.num_attention_heads, eps)
        if collect_attn:
            attn_t.append(pa)
        return txt

    def run_v(i, img):
        img, pa = image_layer(params["v_layers"][i], img, v_bias, txt,
                              t_mask2, cfg.v_num_attention_heads, eps,
                              cfg.dynamic_attention)
        if collect_attn:
            attn_v.append(pa)
        return img

    t_start = v_start = 0
    for count, (v_end, t_end) in enumerate(
            zip(cfg.v_biattention_id, cfg.t_biattention_id)):
        for i in range(t_start, t_end):
            txt = run_t(i, txt)
            if i < cfg.fixed_t_layer:
                txt = txt.detach()
        for i in range(v_start, v_end):
            img = run_v(i, img)
            if i < cfg.fixed_v_layer:
                img = img.detach()
        if cfg.with_coattention:
            img, txt, pc = connection_layer(
                params["c_layers"][count], img, v_bias, txt, t_bias,
                cfg.bi_num_attention_heads, eps)
            if collect_attn:
                attn_c.append(pc)
        t_start, v_start = t_end, v_end
    for i in range(v_start, cfg.v_num_hidden_layers):
        img = run_v(i, img)
    for i in range(t_start, cfg.num_hidden_layers):
        txt = run_t(i, txt)
    return txt, img, (attn_t, attn_v, attn_c)


def vilbert_base(params: Params, cfg: ViLBERTConfig,
                 input_txt: torch.Tensor, image_feature: torch.Tensor,
                 image_location: torch.Tensor,
                 token_type_ids: Optional[torch.Tensor] = None,
                 attention_mask: Optional[torch.Tensor] = None,
                 image_attention_mask: Optional[torch.Tensor] = None,
                 collect_attn: bool = False):
    """ViLBERTBase.forward (vilbert.py:1001-1118) → (seq_t, seq_v,
    pooled_t, pooled_v, attn)."""
    eps = cfg.layer_norm_eps
    B, T = input_txt.shape
    dev = image_feature.device
    if attention_mask is None:
        attention_mask = torch.ones(B, T, device=dev)
    if image_attention_mask is None:
        image_attention_mask = torch.ones(image_feature.shape[:2],
                                          device=dev)
    t_bias = tbert.extended_attention_mask(attention_mask)
    v_bias = tbert.extended_attention_mask(image_attention_mask)
    t_mask2 = attention_mask.to(torch.float32)[:, :, None]
    emb = params["embeddings"]
    txt = _ln(tbert.text_embeddings(emb, input_txt, token_type_ids),
              emb["ln"], eps)
    ve = params["v_embeddings"]
    img = _ln(L.linear_fwd(ve["image"], image_feature)
              + L.linear_fwd(ve["loc"], image_location), ve["ln"], eps)
    txt, img, attn = vilbert_encoder(params, cfg, txt, img, t_bias, t_mask2,
                                     v_bias, collect_attn)
    pooled_t = torch.relu(L.linear_fwd(params["t_pooler"], txt[:, 0]))
    pooled_v = torch.relu(L.linear_fwd(params["v_pooler"], img[:, 0]))
    return txt, img, pooled_t, pooled_v, attn


def _fuse(cfg: ViLBERTConfig, pooled_t, pooled_v):
    if cfg.fusion_method == "sum":
        return pooled_t + pooled_v
    if cfg.fusion_method == "mul":
        return pooled_t * pooled_v
    raise ValueError(f"unknown fusion {cfg.fusion_method!r}")


def vilbert_for_classification(params: Params, cfg: ViLBERTConfig,
                               input_txt: torch.Tensor,
                               image_feature: torch.Tensor,
                               image_location: torch.Tensor,
                               **kw) -> torch.Tensor:
    """ViLBERTForClassification.forward (vilbert.py:1347-1401); the NLVR2
    head takes the pooled pair as ``[B/2, 2·bi]``."""
    _, _, pt, pv, _ = vilbert_base(params, cfg, input_txt, image_feature,
                                   image_location, **kw)
    pooled = _fuse(cfg, pt, pv)
    if cfg.training_head_type == "nlvr2":
        pooled = pooled.reshape(-1, pooled.shape[1] * 2)
    h = transform_fwd(params["classifier"]["transform"], pooled,
                      cfg.layer_norm_eps)
    return L.linear_fwd(params["classifier"]["out"], h)


def vilbert_pretraining_heads(params: Params, cfg: ViLBERTConfig,
                              seq_t, seq_v, pooled_t, pooled_v):
    """BertPreTrainingHeads.forward (vilbert.py:934-954): text LM logits
    (decoder tied to the word table), image predictions, and the bimodal
    seq-relationship score."""
    cls = params["cls"]
    eps = cfg.layer_norm_eps
    scores_t = transform_fwd(cls["lm_transform"], seq_t, eps) \
        @ params["embeddings"]["word"].T + cls["lm_bias"]
    scores_v = L.linear_fwd(cls["img_decoder"],
                            transform_fwd(cls["img_transform"], seq_v, eps))
    seq_rel = L.linear_fwd(cls["bi_seq_relationship"],
                           _fuse(cfg, pooled_t, pooled_v))
    return scores_t, scores_v, seq_rel


def vilbert_pretrain_losses(params: Params, cfg: ViLBERTConfig,
                            input_txt, image_feature, image_location,
                            masked_lm_labels, image_label, image_target,
                            visual_target: int = 0,
                            **kw) -> Dict[str, torch.Tensor]:
    """ViLBERTForPretraining's losses (vilbert.py:1163-1307): masked-LM CE
    (−1 ignored) and the masked-region loss, KL divergence over the
    log-softmax (``visual_target`` 0, with torch's 0·log 0 = 0) or MSE
    (1)."""
    seq_t, seq_v, pt, pv, _ = vilbert_base(params, cfg, input_txt,
                                           image_feature, image_location,
                                           **kw)
    scores_t, scores_v, _ = vilbert_pretraining_heads(params, cfg, seq_t,
                                                      seq_v, pt, pv)
    out: Dict[str, torch.Tensor] = {}
    labels = masked_lm_labels.reshape(-1).long()
    valid = labels != -1
    nll = F.cross_entropy(scores_t.reshape(-1, cfg.vocab_size),
                          labels.clamp(min=0), reduction="none")
    out["masked_lm_loss"] = torch.where(valid, nll, torch.zeros_like(nll)
                                        ).sum() / valid.sum().clamp(min=1)
    sel = (image_label == 1).to(scores_v.dtype)[:, :, None]
    if visual_target == 0:
        logq = torch.log_softmax(scores_v, dim=2)
        kld = torch.where(
            image_target > 0,
            image_target * (torch.log(image_target.clamp(min=1e-30)) - logq),
            torch.zeros_like(logq))
        out["masked_img_loss"] = (kld * sel).sum() / (
            image_label == 1).sum().clamp(min=1)
    elif visual_target == 1:
        mse = (scores_v - image_target) ** 2
        out["masked_img_loss"] = (mse * sel).sum() / (
            sel * torch.ones_like(mse)).sum().clamp(min=1)
    return out
