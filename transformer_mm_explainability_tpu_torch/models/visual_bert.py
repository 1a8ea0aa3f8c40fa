"""VisualBERT (single-stream vision-language BERT) with attention capture,
in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/visual_bert.py``
(MMF's ``visual_bert``): text embeddings (word + position + type)
concatenated with projected visual features (+ visual type and position
embeddings) under one LayerNorm, the 12-layer BERT encoder of
``models/bert`` with the −10000 padding mask, and the VQA head: pool at
token ``input_mask.sum(1) - 2`` (the ``?`` token acts as CLS), then
dense + GELU + LN and the classifier.

Text length and box count are fixed per batch; ``input_mask`` and
``visual_mask`` carry validity. ``capture`` returns ``(scores, A, ∇A)``
from one forward and one backward through zero taps on the probabilities;
``relevancy_row`` is the streamed explain step of ``ours_no_lrp``, which
never holds the ``[L, B, H, S, S]`` stacks.

``relprop`` is the LRP pass from the answer one-hot back through the head,
the ``?`` token and the encoder (``models/bert_lrp``), on the tape that
``forward(..., return_tape=True)`` or ``capture(..., return_tape=True)``
returns. ``pretrain_forward`` (masked LM on the decoder tied to the word
embeddings + ``seq_relationship``), ``forward_nlvr2`` (the paired-image
classifier on the concatenated poolers) and ``forward_bypass`` (text-only
encoder, then one extra layer over text and boxes) are the model's other
heads, each with its ``init_*``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from transformer_mm_explainability_tpu_torch.models import bert
from transformer_mm_explainability_tpu_torch.models import bert_lrp
from transformer_mm_explainability_tpu_torch.ops import lrp
from transformer_mm_explainability_tpu_torch.ops import relevancy as rl
from transformer_mm_explainability_tpu_torch.ops.attention import (
    gelu,
    layer_norm,
)


@dataclasses.dataclass(frozen=True)
class VisualBERTConfig:
    bert: bert.BertConfig = bert.BERT_BASE
    visual_embedding_dim: int = 2048
    num_labels: int = 3129  # VQA2 answer vocabulary
    pooler_strategy: str = "vqa"  # "vqa" | "default"


VISUAL_BERT_VQA2 = VisualBERTConfig()


def init_params(seed: Union[int, torch.Generator] = 0,
                cfg: VisualBERTConfig = VISUAL_BERT_VQA2,
                device="cuda") -> Dict[str, Any]:
    """Random weights in the JAX tree's structure (normal, std 0.02; zero
    biases; LN at identity), drawn on the CPU from ``seed``."""
    gen = bert._generator(seed)
    D = cfg.bert.hidden_size
    nrm = lambda *shape: bert._normal(gen, device, *shape)
    zeros = lambda *shape: torch.zeros(shape, device=device)
    return {
        "embeddings": bert.init_embedding_params(gen, cfg.bert, device),
        "visual": {
            "projection": {"w": nrm(cfg.visual_embedding_dim, D),
                           "b": zeros(D)},
            "token_type": nrm(cfg.bert.type_vocab_size, D),
            "position": nrm(cfg.bert.max_position_embeddings, D),
        },
        "encoder": bert.init_encoder_params(gen, cfg.bert, device),
        "pooler": {"w": nrm(D, D), "b": zeros(D)},
        "head": {
            "transform": {"w": nrm(D, D), "b": zeros(D),
                          "ln": {"scale": torch.ones(D, device=device),
                                 "bias": zeros(D)}},
            "classifier": {"w": nrm(D, cfg.num_labels),
                           "b": zeros(cfg.num_labels)},
        },
    }


def embed(params: Dict[str, Any], input_ids: torch.Tensor,
          token_type_ids: Optional[torch.Tensor],
          visual_embeddings: Optional[torch.Tensor],
          visual_embeddings_type: Optional[torch.Tensor],
          cfg: VisualBERTConfig,
          image_text_alignment: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """Concatenated text + visual embeddings under the shared LayerNorm.

    ``image_text_alignment`` ``[B, N_v, A]`` (−1 = pad): each box's
    aligned word positions; its visual position embedding becomes the MEAN
    of the TEXT position embeddings there (``max(count, 1)`` as the
    divisor) plus visual position row 0. Without it every box gets row 0.
    """
    x = bert.text_embeddings(params["embeddings"], input_ids, token_type_ids)
    if visual_embeddings is not None:
        v = params["visual"]
        ve = visual_embeddings @ v["projection"]["w"] + v["projection"]["b"]
        if visual_embeddings_type is None:
            visual_embeddings_type = torch.zeros(
                visual_embeddings.shape[:2], dtype=torch.long,
                device=visual_embeddings.device)
        ve = ve + v["token_type"][visual_embeddings_type.long()]
        if image_text_alignment is not None:
            m = (image_text_alignment != -1).long()
            ita = m * image_text_alignment.long()       # −1 → position 0
            pe = (params["embeddings"]["position"][ita]
                  * m[..., None].to(ve.dtype))          # [B, N, A, D]
            denom = m.sum(dim=2).clamp(min=1)
            ve = ve + pe.sum(dim=2) / denom[..., None].to(ve.dtype)
        ve = ve + v["position"][0]
        x = torch.cat([x, ve], dim=1)
    ln = params["embeddings"]["ln"]
    return layer_norm(x, ln["scale"], ln["bias"], cfg.bert.layer_norm_eps)


def _full_mask(input_mask: torch.Tensor,
               visual_embeddings: Optional[torch.Tensor],
               visual_mask: Optional[torch.Tensor],
               dtype: torch.dtype) -> torch.Tensor:
    """Additive ``[B, 1, 1, S]`` mask over text then boxes; boxes default
    to all valid."""
    if visual_embeddings is not None:
        if visual_mask is None:
            visual_mask = torch.ones(visual_embeddings.shape[:2],
                                     dtype=input_mask.dtype,
                                     device=input_mask.device)
        input_mask = torch.cat([input_mask, visual_mask.to(input_mask.dtype)],
                               dim=1)
    return bert.extended_attention_mask(input_mask, dtype)


def cls_index(input_mask: torch.Tensor) -> torch.Tensor:
    """The VQA pooler's token, ``input_mask.sum(1) - 2`` (the ``?``)."""
    return input_mask.long().sum(dim=1) - 2


def _pooler(params: Dict[str, Any], hidden: torch.Tensor) -> torch.Tensor:
    """BertPooler: tanh of the first token's dense projection."""
    return torch.tanh(hidden[:, 0] @ params["pooler"]["w"]
                      + params["pooler"]["b"])


def _transform(t: Dict[str, Any], x: torch.Tensor, eps: float
               ) -> torch.Tensor:
    """BertPredictionHeadTransform: dense + GELU + LayerNorm."""
    return layer_norm(gelu(x @ t["w"] + t["b"]), t["ln"]["scale"],
                      t["ln"]["bias"], eps)


def _head(params: Dict[str, Any], hidden: torch.Tensor,
          input_mask: torch.Tensor, cfg: VisualBERTConfig):
    """Pooler + answer head: ``(scores, pooled)``."""
    if cfg.pooler_strategy == "vqa":
        idx = cls_index(input_mask)
        pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device),
                        idx]
    else:
        pooled = _pooler(params, hidden)
    h = _transform(params["head"]["transform"], pooled,
                   cfg.bert.layer_norm_eps)
    c = params["head"]["classifier"]
    return h @ c["w"] + c["b"], pooled


def forward(params: Dict[str, Any], input_ids: torch.Tensor,
            input_mask: torch.Tensor,
            visual_embeddings: Optional[torch.Tensor] = None,
            token_type_ids: Optional[torch.Tensor] = None,
            visual_embeddings_type: Optional[torch.Tensor] = None,
            visual_mask: Optional[torch.Tensor] = None,
            image_text_alignment: Optional[torch.Tensor] = None,
            cfg: VisualBERTConfig = VISUAL_BERT_VQA2,
            taps: Optional[torch.Tensor] = None,
            return_tape: bool = False) -> Dict[str, Any]:
    """Returns {"scores": [B, num_labels], "attn": [L, B, H, S, S],
    "sequence_output": [B, S, D]} (+ "tape" with the per-layer inputs, the
    mask, the pooled vector and the CLS index when ``return_tape``).

    ``input_mask``: [B, S_text] text validity; ``visual_mask``: [B, N_v]
    box validity (all ones by default, as the reference attends to every
    padded feature row unless masked)."""
    x = embed(params, input_ids, token_type_ids, visual_embeddings,
              visual_embeddings_type, cfg, image_text_alignment)
    mask = _full_mask(input_mask, visual_embeddings, visual_mask, x.dtype)
    hidden, attn, tape = bert.encoder(params["encoder"], x, cfg.bert, mask,
                                      taps, return_tape=True)
    scores, pooled = _head(params, hidden, input_mask, cfg)
    out = {"scores": scores, "attn": attn, "sequence_output": hidden}
    if return_tape:
        out["tape"] = {"encoder": tape, "mask": mask, "pooled": pooled,
                       "cls_index": (cls_index(input_mask)
                                     if cfg.pooler_strategy == "vqa"
                                     else None)}
    return out


def _picked_score(scores: torch.Tensor,
                  targets: Optional[torch.Tensor]) -> torch.Tensor:
    """Σ_b scores[b, t_b]; ``targets=None`` takes the argmax outside the
    graph (the reference's ``index=None → argmax(output)``)."""
    t = scores.detach().argmax(-1) if targets is None else targets
    return scores.gather(1, t[:, None].long().to(scores.device)).sum()


def capture(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            targets: Optional[torch.Tensor],
            cfg: VisualBERTConfig = VISUAL_BERT_VQA2,
            return_tape: bool = False) -> Tuple[torch.Tensor, ...]:
    """One forward and one backward: ``(scores, A, ∇A)``, A and ∇A
    ``[L, B, H, S, S]``. ``targets``: ``[B]`` answer indices, or ``None``
    to explain the PREDICTED answer, resolved inside the same pass. With
    ``return_tape`` the same forward's tape (``forward``'s, detached)
    comes fourth, for ``relprop``."""
    ve = batch.get("visual_embeddings")
    B, S_t = batch["input_ids"].shape
    S = S_t + (0 if ve is None else ve.shape[1])
    bc = cfg.bert
    taps = torch.zeros((bc.num_hidden_layers, B, bc.num_attention_heads, S,
                        S), device=batch["input_ids"].device,
                       dtype=params["embeddings"]["word"].dtype,
                       requires_grad=True)
    with torch.enable_grad():
        out = forward(params, batch["input_ids"], batch["input_mask"], ve,
                      batch.get("token_type_ids"),
                      batch.get("visual_embeddings_type"),
                      batch.get("visual_mask"),
                      batch.get("image_text_alignment"), cfg, taps,
                      return_tape)
        (grads,) = torch.autograd.grad(
            _picked_score(out["scores"], targets), [taps])
    got = (out["scores"].detach(), out["attn"].detach(), grads)
    if return_tape:
        return got + (bert.detach_tape(out["tape"]),)
    return got


def relprop(params: Dict[str, Any], tape: Dict[str, Any],
            one_hot: torch.Tensor,
            cfg: VisualBERTConfig = VISUAL_BERT_VQA2, alpha: float = 1.0,
            uniform: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """LRP from the answer one-hot ``[B, num_labels]`` back through the
    classifier, the vqa pooler and the encoder
    (VisualBERTForClassification.relprop, visual_bert.py:398-403). Returns
    ``(R at the embeddings [B, S, D], attn cams [L, B, H, S, S])``.
    ``uniform=False`` is the BERT_orig_lrp (layers_lrp) variant: per-branch
    S1 = R/Z1, S2 = R/Z2 in every α-β rule. Each example's relevance is
    its own (``ops/lrp``: per-example sums)."""
    if tape["cls_index"] is None:
        raise ValueError("relprop follows the vqa pooler (the '?' token); "
                         "this config pools with the default pooler")
    t = params["head"]["transform"]
    c = params["head"]["classifier"]
    pooled = tape["pooled"]
    g1 = _transform(t, pooled, cfg.bert.layer_norm_eps)
    cam = lrp.linear_alpha_beta(one_hot.to(g1.dtype), g1, c["w"], alpha,
                                uniform)
    cam = lrp.linear_alpha_beta(cam, pooled, t["w"], alpha, uniform)
    # the vqa pooler: scatter back to the '?' token
    enc = tape["encoder"]
    R = torch.zeros(enc.shape[1:], dtype=cam.dtype, device=cam.device)
    R[torch.arange(R.shape[0], device=R.device), tape["cls_index"]] = cam
    return bert_lrp.bert_encoder_relprop(params["encoder"], enc,
                                         tape["mask"], R, cfg.bert, alpha,
                                         uniform)


def relevancy_row(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                  targets: Optional[torch.Tensor],
                  cfg: VisualBERTConfig = VISUAL_BERT_VQA2
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``capture`` + ``explain.visual_bert.generate_ours``, streamed:
    ``(scores, cam [B, S])``, the CLS row of the rule-6 chain, without the
    ``[L, B, H, S, S]`` A/∇A stacks.

    The forward keeps only each layer's input. The reverse pass recomputes
    one layer at a time with a zero tap on its probabilities; one
    ``torch.autograd.grad`` gives the layer's input cotangent and ∇A, and
    the row folds ``r ← r + r·Ê_l`` from ``one_hot(cls_index)``, last layer
    first: the CLS row of ``R = (I+Ê_L)···(I+Ê_1)``. The CLS position
    itself is zeroed, as ``generate_ours``' row read does."""
    bc = cfg.bert
    input_mask = batch["input_mask"]
    ve = batch.get("visual_embeddings")
    layers = [bert.unstack(params["encoder"], i)
              for i in range(bc.num_hidden_layers)]
    with torch.no_grad():
        x = embed(params, batch["input_ids"], batch.get("token_type_ids"),
                  ve, batch.get("visual_embeddings_type"), cfg,
                  batch.get("image_text_alignment"))
        mask = _full_mask(input_mask, ve, batch.get("visual_mask"), x.dtype)
        tape = []
        for p in layers:
            tape.append(x)
            x, _ = bert.layer(p, x, bc, mask)
    B, S, _ = x.shape
    with torch.enable_grad():
        x_final = x.detach().requires_grad_(True)
        scores, _ = _head(params, x_final, input_mask, cfg)
        (cot_x,) = torch.autograd.grad(_picked_score(scores, targets),
                                       [x_final])
        ci = cls_index(input_mask)
        r = torch.nn.functional.one_hot(ci, S).to(torch.float32)
        zero_tap = torch.zeros((B, bc.num_attention_heads, S, S),
                               dtype=x.dtype, device=x.device)
        for p, x_in in zip(reversed(layers), reversed(tape)):
            x_in = x_in.detach().requires_grad_(True)
            tap = zero_tap.clone().requires_grad_(True)
            x_out, probs = bert.layer(p, x_in, bc, mask, tap)
            cot_x, grad_a = torch.autograd.grad(x_out, [x_in, tap], cot_x)
            e_hat = rl.avg_heads(probs.detach().float(), grad_a.float())
            r = r + torch.einsum("bj,bjk->bk", r, e_hat)
    keep = torch.arange(S, device=r.device)[None, :] != ci[:, None]
    return scores.detach(), torch.where(keep, r, torch.zeros_like(r))


# ---------------------------------------------------------------------------
# pretraining head (VisualBERTForPretraining, visual_bert.py:156-280)
# ---------------------------------------------------------------------------

def init_pretrain_params(seed: Union[int, torch.Generator] = 0,
                         cfg: VisualBERTConfig = VISUAL_BERT_VQA2,
                         device="cuda") -> Dict[str, Any]:
    """BertPreTrainingHeads: masked-LM predictions (transform
    dense+gelu+LN, decoder TIED to the word embeddings + free bias)
    and the 2-way seq_relationship head (tie_weights, :223-230); normal
    std 0.02, zero biases, drawn on the CPU from ``seed``."""
    gen = bert._generator(seed)
    D = cfg.bert.hidden_size
    nrm = lambda *shape: bert._normal(gen, device, *shape)
    zeros = lambda *shape: torch.zeros(shape, device=device)
    return {
        "transform": {"w": nrm(D, D), "b": zeros(D),
                      "ln": {"scale": torch.ones(D, device=device),
                             "bias": zeros(D)}},
        "decoder_bias": zeros(cfg.bert.vocab_size),
        "seq_relationship": {"w": nrm(D, 2), "b": zeros(2)},
    }


def pretrain_forward(params: Dict[str, Any], head: Dict[str, Any],
                     input_ids: torch.Tensor, input_mask: torch.Tensor,
                     visual_embeddings: Optional[torch.Tensor] = None,
                     token_type_ids: Optional[torch.Tensor] = None,
                     visual_embeddings_type: Optional[torch.Tensor] = None,
                     visual_mask: Optional[torch.Tensor] = None,
                     masked_lm_labels: Optional[torch.Tensor] = None,
                     image_text_alignment: Optional[torch.Tensor] = None,
                     cfg: VisualBERTConfig = VISUAL_BERT_VQA2
                     ) -> Dict[str, torch.Tensor]:
    """VisualBERTForPretraining.forward (visual_bert.py:233-280).

    ``masked_lm_labels``: [B, S_text] text-side LM labels (-1 = ignore);
    they are extended with -1 over the visual span exactly like
    ``add_post_flatten_params`` (:455-465). Returns {"logits" [B, S,
    vocab], "seq_relationship" [B, 2], "attn", "masked_lm_loss", "loss"}
    — the loss is the mean CE over non-ignored positions (torch
    ``CrossEntropyLoss(ignore_index=-1)``, :211), 0 when none is."""
    x = embed(params, input_ids, token_type_ids, visual_embeddings,
              visual_embeddings_type, cfg, image_text_alignment)
    mask = _full_mask(input_mask, visual_embeddings, visual_mask, x.dtype)
    hidden, attn = bert.encoder(params["encoder"], x, cfg.bert, mask)
    # the default pooler, not the VQA '?'-token one
    pooled = _pooler(params, hidden)
    h = _transform(head["transform"], hidden, cfg.bert.layer_norm_eps)
    logits = h @ params["embeddings"]["word"].T + head["decoder_bias"]
    sr = head["seq_relationship"]
    out = {"logits": logits, "seq_relationship": pooled @ sr["w"] + sr["b"],
           "attn": attn}
    if masked_lm_labels is not None:
        B, S = hidden.shape[:2]
        labels = torch.full((B, S), -1, dtype=torch.long,
                            device=hidden.device)
        labels[:, :masked_lm_labels.shape[1]] = masked_lm_labels.long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        valid = labels >= 0
        picked = logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
        loss = -(picked * valid).sum() / valid.sum().clamp(min=1)
        out["masked_lm_loss"] = out["loss"] = loss
    return out


# ---------------------------------------------------------------------------
# NLVR2 paired-image classification (visual_bert.py:321-365)
# ---------------------------------------------------------------------------

def init_nlvr2_head(seed: Union[int, torch.Generator] = 0,
                    cfg: VisualBERTConfig = VISUAL_BERT_VQA2,
                    num_labels: int = 2, device="cuda") -> Dict[str, Any]:
    """training_head_type == "nlvr2": the classifier operates on the
    CONCATENATED pooled pair, so its transform/classifier are sized
    2·hidden (``self.bert.config.hidden_size *= 2``, :321-326)."""
    gen = bert._generator(seed)
    D2 = 2 * cfg.bert.hidden_size
    nrm = lambda *shape: bert._normal(gen, device, *shape)
    zeros = lambda *shape: torch.zeros(shape, device=device)
    return {
        "transform": {"w": nrm(D2, D2), "b": zeros(D2),
                      "ln": {"scale": torch.ones(D2, device=device),
                             "bias": zeros(D2)}},
        "classifier": {"w": nrm(D2, num_labels), "b": zeros(num_labels)},
    }


def forward_nlvr2(params: Dict[str, Any], head: Dict[str, Any],
                  input_ids: torch.Tensor, input_mask: torch.Tensor,
                  visual_embeddings: torch.Tensor,
                  token_type_ids: Optional[torch.Tensor] = None,
                  visual_embeddings_type: Optional[torch.Tensor] = None,
                  visual_mask: Optional[torch.Tensor] = None,
                  image_text_alignment: Optional[torch.Tensor] = None,
                  cfg: VisualBERTConfig = VISUAL_BERT_VQA2
                  ) -> Dict[str, torch.Tensor]:
    """VisualBERTForClassification.forward, nlvr2 path (:360-365): the
    two images of a pair ride the batch axis (``input_ids`` [2B, S], rows
    [:B] = img0, [B:] = img1 — the reference's ``2B·H → B·2H`` concat),
    pooled with the default BertPooler, concatenated, then
    transform+classifier. Returns {"scores": [B, num_labels], "attn"}."""
    x = embed(params, input_ids, token_type_ids, visual_embeddings,
              visual_embeddings_type, cfg, image_text_alignment)
    mask = _full_mask(input_mask, visual_embeddings, visual_mask, x.dtype)
    hidden, attn = bert.encoder(params["encoder"], x, cfg.bert, mask)
    pooled = _pooler(params, hidden)
    b = pooled.shape[0]
    pooled = torch.cat([pooled[:b // 2], pooled[b // 2:]], dim=1)
    h = _transform(head["transform"], pooled, cfg.bert.layer_norm_eps)
    c = head["classifier"]
    return {"scores": h @ c["w"] + c["b"], "attn": attn}


# ---------------------------------------------------------------------------
# bypass_transformer mode (VisualBERTBase.forward, visual_bert.py:107-131)
# ---------------------------------------------------------------------------

def init_bypass_layer(seed: Union[int, torch.Generator] = 0,
                      cfg: VisualBERTConfig = VISUAL_BERT_VQA2,
                      device="cuda") -> Dict[str, Any]:
    """The ``additional_layer`` (one BertLayer) the bypass mode appends
    (:58-60), stacked as a one-layer encoder."""
    one = dataclasses.replace(cfg.bert, num_hidden_layers=1)
    return bert.init_encoder_params(seed, one, device)


def forward_bypass(params: Dict[str, Any],
                   additional_layer: Dict[str, Any],
                   input_ids: torch.Tensor, input_mask: torch.Tensor,
                   visual_embeddings: torch.Tensor,
                   token_type_ids: Optional[torch.Tensor] = None,
                   visual_embeddings_type: Optional[torch.Tensor] = None,
                   visual_mask: Optional[torch.Tensor] = None,
                   image_text_alignment: Optional[torch.Tensor] = None,
                   cfg: VisualBERTConfig = VISUAL_BERT_VQA2
                   ) -> Dict[str, torch.Tensor]:
    """``bypass_transformer=True`` (dormant in every shipped config, but
    part of the model surface): the encoder sees ONLY the text span under
    a text-only mask (:114-124), then one additional BertLayer runs over
    [encoded_text ; visual_embedding_part] with the full mask (:125-130);
    pooled = BertPooler on token 0. Returns {"sequence_output",
    "pooled_output", "text_attn", "joint_attn"}."""
    x = embed(params, input_ids, token_type_ids, visual_embeddings,
              visual_embeddings_type, cfg, image_text_alignment)
    text_length = input_ids.shape[1]
    text_mask = bert.extended_attention_mask(input_mask, x.dtype)
    hidden_t, text_attn = bert.encoder(params["encoder"], x[:, :text_length],
                                       cfg.bert, text_mask)
    full_mask = _full_mask(input_mask, visual_embeddings, visual_mask,
                           x.dtype)
    new_input = torch.cat([hidden_t, x[:, text_length:]], dim=1)
    one = dataclasses.replace(cfg.bert, num_hidden_layers=1)
    final, joint_attn = bert.encoder(additional_layer, new_input, one,
                                     full_mask)
    return {"sequence_output": final, "pooled_output": _pooler(params, final),
            "text_attn": text_attn, "joint_attn": joint_attn}
