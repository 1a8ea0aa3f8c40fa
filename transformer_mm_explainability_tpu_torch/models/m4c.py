"""M4C (Multimodal Multi-Copy Mesh) for TextVQA and TextCaps, in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/m4c.py``
(``mmf/models/m4c.py``): TextBert and the MMT on the port's BERT encoder,
the object and OCR encodings, the previous-prediction embeddings, the
prefix-LM mask (every position sees the valid encoder positions, decode
positions are causal among themselves) and the OCR pointer net. Greedy
decoding reruns the whole MMT once per step and feeds the argmax back, in
a Python loop as in the reference (the JAX package scans it);
``remove_unk_idx`` selects ``m4c_captioner``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from transformer_mm_explainability_tpu_torch.models import bert as tbert
from transformer_mm_explainability_tpu_torch.models import mmf_layers as L
from transformer_mm_explainability_tpu_torch.ops.attention import layer_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class M4CConfig:
    vocab_size: int = 100            # question wordpiece vocab
    num_fixed_answers: int = 20      # classifier out (already minus OCR)
    hidden_size: int = 768
    num_heads: int = 12
    text_bert_layers: int = 3
    mmt_layers: int = 4
    obj_in_dim: int = 2048           # obj.mmt_in_dim
    ocr_in_dim: int = 3002           # ocr.mmt_in_dim (300+604+2048+50)
    ocr_fc7_dim: int = 2048
    max_dec_length: int = 100
    max_type_num: int = 5
    layer_norm_eps: float = 1e-12
    bos_idx: int = 1

    def bert_cfg(self, layers: int) -> tbert.BertConfig:
        return tbert.BertConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            num_hidden_layers=layers, num_attention_heads=self.num_heads,
            intermediate_size=4 * self.hidden_size,
            layer_norm_eps=self.layer_norm_eps)


def init_m4c(seed: L.Seed, cfg: M4CConfig, device="cuda") -> Params:
    gen = L.generator(seed)
    D = cfg.hidden_size
    lin = lambda i, o: L.init_linear(gen, i, o, device)

    def modality(in_dim):
        return {"fc7": lin(cfg.ocr_fc7_dim, cfg.ocr_fc7_dim),
                "feat": lin(in_dim, D), "bbox": lin(4, D),
                "feat_ln": L.ln_init(D, device),
                "bbox_ln": L.ln_init(D, device)}

    return {
        "text_bert": {
            "embeddings": tbert.init_embedding_params(
                gen, cfg.bert_cfg(cfg.text_bert_layers), device),
            "encoder": tbert.init_encoder_params(
                gen, cfg.bert_cfg(cfg.text_bert_layers), device),
        },
        "obj": modality(cfg.obj_in_dim),
        "ocr": modality(cfg.ocr_in_dim),
        "mmt": {
            "encoder": tbert.init_encoder_params(
                gen, cfg.bert_cfg(cfg.mmt_layers), device),
            "prev_pred": {
                "position": L.normal(gen, (cfg.max_dec_length, D), 0.02,
                                     device),
                "token_type": L.normal(gen, (cfg.max_type_num, D), 0.02,
                                       device),
                "ans_ln": L.ln_init(D, device),
                "ocr_ln": L.ln_init(D, device),
                "emb_ln": L.ln_init(D, device),
            },
        },
        "classifier": lin(D, cfg.num_fixed_answers),
        "ocr_ptr_net": {"query": lin(D, D), "key": lin(D, D)},
    }


def get_mask(nums: torch.Tensor, max_num: int) -> torch.Tensor:
    """_get_mask (m4c.py:547-553): counts ``[B]`` → ``[B, max_num]`` {0,1}."""
    ar = torch.arange(max_num, device=nums.device)[None, :]
    return (ar < nums[:, None]).to(torch.float32)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize over the last axis, x / max(‖x‖, eps), the norm summed as
    ``mmf_layers.l2_norm`` sums it."""
    return x / L.l2_norm(x, dim=-1, keepdim=True).clamp(min=eps)


def _ln(x, p, eps):
    return layer_norm(x, p["scale"], p["bias"], eps)


def text_bert_fwd(params: Params, cfg: M4CConfig, txt_inds: torch.Tensor,
                  txt_mask: torch.Tensor) -> torch.Tensor:
    """TextBert.forward (m4c.py:344-366)."""
    emb = params["text_bert"]["embeddings"]
    x = _ln(tbert.text_embeddings(emb, txt_inds), emb["ln"],
            cfg.layer_norm_eps)
    out, _ = tbert.encoder(params["text_bert"]["encoder"], x,
                           cfg.bert_cfg(cfg.text_bert_layers),
                           mask=tbert.extended_attention_mask(txt_mask))
    return out


def obj_encoding_fwd(params: Params, cfg: M4CConfig, obj_fc6: torch.Tensor,
                     obj_bbox: torch.Tensor) -> torch.Tensor:
    """_forward_obj_encoding (m4c.py:196-214)."""
    p, eps = params["obj"], cfg.layer_norm_eps
    fc7 = l2_normalize(torch.relu(L.linear_fwd(p["fc7"], obj_fc6)))
    return (_ln(L.linear_fwd(p["feat"], fc7), p["feat_ln"], eps)
            + _ln(L.linear_fwd(p["bbox"], obj_bbox), p["bbox_ln"], eps))


def ocr_encoding_fwd(params: Params, cfg: M4CConfig,
                     ocr_fasttext: torch.Tensor, ocr_phoc: torch.Tensor,
                     ocr_fc6: torch.Tensor, ocr_order: torch.Tensor,
                     ocr_bbox: torch.Tensor) -> torch.Tensor:
    """_forward_ocr_encoding (m4c.py:216-255); the reference zeroes the
    order vectors, which stay in the layout."""
    p, eps = params["ocr"], cfg.layer_norm_eps
    fc7 = l2_normalize(torch.relu(L.linear_fwd(p["fc7"], ocr_fc6)))
    feat = torch.cat([l2_normalize(ocr_fasttext), l2_normalize(ocr_phoc), fc7,
                      torch.zeros_like(ocr_order)], dim=-1)
    return (_ln(L.linear_fwd(p["feat"], feat), p["feat_ln"], eps)
            + _ln(L.linear_fwd(p["bbox"], ocr_bbox), p["bbox_ln"], eps))


def prev_pred_embeddings_fwd(params: Params, cfg: M4CConfig,
                             ans_emb: torch.Tensor, ocr_emb: torch.Tensor,
                             prev_inds: torch.Tensor) -> torch.Tensor:
    """PrevPredEmbeddings.forward (m4c.py:510-544)."""
    p, eps = params["mmt"]["prev_pred"], cfg.layer_norm_eps
    B, T = prev_inds.shape
    A = ans_emb.shape[0]
    ans = _ln(ans_emb, p["ans_ln"], eps)
    ocr = _ln(ocr_emb, p["ocr_ln"], eps)
    cat = torch.cat([ans[None].expand(B, -1, -1), ocr], dim=1)
    raw = torch.gather(cat, 1, prev_inds.long()[:, :, None].expand(
        -1, -1, cat.shape[-1]))
    pos = p["position"][:T][None]
    tok = p["token_type"][(prev_inds >= A).long()]
    return raw + _ln(pos + tok, p["emb_ln"], eps)


def _mmt_mask(txt_mask, obj_mask, ocr_mask, dec_len: int) -> torch.Tensor:
    """The prefix-LM additive bias (m4c.py:400-440)."""
    enc = torch.cat([txt_mask, obj_mask, ocr_mask,
                     txt_mask.new_zeros(txt_mask.shape[0], dec_len)], dim=1)
    S = enc.shape[1]
    m = enc[:, None, None, :].expand(-1, 1, S, S).clone()
    m[:, :, -dec_len:, -dec_len:] = torch.tril(
        torch.ones(dec_len, dec_len, dtype=enc.dtype, device=enc.device))
    return (1.0 - m) * -10000.0


def mmt_fwd(params: Params, cfg: M4CConfig, txt_emb, txt_mask, obj_emb,
            obj_mask, ocr_emb, ocr_mask, fixed_ans_emb, prev_inds
            ) -> Dict[str, torch.Tensor]:
    """MMT.forward (m4c.py:378-459)."""
    dec_emb = prev_pred_embeddings_fwd(params, cfg, fixed_ans_emb, ocr_emb,
                                       prev_inds)
    x = torch.cat([txt_emb, obj_emb, ocr_emb, dec_emb], dim=1)
    bias = _mmt_mask(txt_mask, obj_mask, ocr_mask, dec_emb.shape[1])
    out, _ = tbert.encoder(params["mmt"]["encoder"], x,
                           cfg.bert_cfg(cfg.mmt_layers), mask=bias)
    t_end = txt_mask.shape[1]
    ocr_begin = t_end + obj_mask.shape[1]
    ocr_end = ocr_begin + ocr_mask.shape[1]
    dec_len = prev_inds.shape[1]
    return {"mmt_seq_output": out,
            "mmt_txt_output": out[:, :t_end],
            "mmt_ocr_output": out[:, ocr_begin:ocr_end],
            "mmt_dec_output": out[:, -dec_len:]}


def ocr_ptr_net_fwd(params: Params, cfg: M4CConfig, query_inputs,
                    key_inputs, attention_mask) -> torch.Tensor:
    """OcrPtrNet.forward (m4c.py:472-494)."""
    p = params["ocr_ptr_net"]
    q = L.linear_fwd(p["query"], query_inputs)
    k = L.linear_fwd(p["key"], key_inputs)
    scores = torch.einsum("btd,bkd->btk", q, k) / math.sqrt(cfg.hidden_size)
    return scores + ((1.0 - attention_mask) * -10000.0)[:, None, :]


def _scores(params: Params, cfg: M4CConfig, inputs: Params,
            prev_inds: torch.Tensor,
            remove_unk_idx: Optional[int] = None) -> torch.Tensor:
    """One MMT pass and the output heads (m4c.py:259-286);
    ``remove_unk_idx`` sets that score to −1e10 (m4c_captioner.py:16-23)."""
    res = mmt_fwd(params, cfg, inputs["txt_emb"], inputs["txt_mask"],
                  inputs["obj_emb"], inputs["obj_mask"], inputs["ocr_emb"],
                  inputs["ocr_mask"], params["classifier"]["w"], prev_inds)
    fixed = L.linear_fwd(params["classifier"], res["mmt_dec_output"])
    dyn = ocr_ptr_net_fwd(params, cfg, res["mmt_dec_output"],
                          res["mmt_ocr_output"], inputs["ocr_mask"])
    scores = torch.cat([fixed, dyn], dim=-1)
    if remove_unk_idx is not None:
        scores[..., remove_unk_idx] = -1e10
    return scores


def m4c_forward(params: Params, cfg: M4CConfig,
                txt_inds: torch.Tensor, txt_len: torch.Tensor,
                obj_fc6: torch.Tensor, obj_bbox: torch.Tensor,
                obj_nums: torch.Tensor,
                ocr_fasttext: torch.Tensor, ocr_phoc: torch.Tensor,
                ocr_fc6: torch.Tensor, ocr_order: torch.Tensor,
                ocr_bbox: torch.Tensor, ocr_nums: torch.Tensor,
                prev_inds: Optional[torch.Tensor] = None,
                dec_steps: Optional[int] = None,
                remove_unk_idx: Optional[int] = None) -> torch.Tensor:
    """M4C.forward (m4c.py:173-302). With ``prev_inds``, one teacher-
    forced pass; without, ``dec_steps`` greedy passes, returning the last
    pass's scores ``[B, dec_steps, A + OCR]`` (their argmax is the decoded
    sequence)."""
    txt_mask = get_mask(txt_len, txt_inds.shape[1])
    txt_emb = text_bert_fwd(params, cfg, txt_inds, txt_mask)
    obj_emb = obj_encoding_fwd(params, cfg, obj_fc6, obj_bbox)
    ocr_emb = ocr_encoding_fwd(params, cfg, ocr_fasttext, ocr_phoc,
                               ocr_fc6, ocr_order, ocr_bbox)
    inputs = {"txt_emb": txt_emb, "txt_mask": txt_mask,
              "obj_emb": obj_emb,
              "obj_mask": get_mask(obj_nums, obj_emb.shape[1]),
              "ocr_emb": ocr_emb,
              "ocr_mask": get_mask(ocr_nums, ocr_emb.shape[1])}
    if prev_inds is not None:
        return _scores(params, cfg, inputs, prev_inds, remove_unk_idx)
    if dec_steps is None:
        raise ValueError("greedy decoding needs dec_steps")
    inds = torch.zeros(txt_inds.shape[0], dec_steps, dtype=torch.long,
                       device=txt_inds.device)
    inds[:, 0] = cfg.bos_idx
    for _ in range(dec_steps):
        scores = _scores(params, cfg, inputs, inds, remove_unk_idx)
        nxt = scores.argmax(dim=-1)
        inds = torch.cat([inds[:, :1], nxt[:, :-1]], dim=1)
    return scores
