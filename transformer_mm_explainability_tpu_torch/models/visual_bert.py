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
returns. The pretraining, NLVR2 and bypass heads wait for ROADMAP A5.
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


def _head(params: Dict[str, Any], hidden: torch.Tensor,
          input_mask: torch.Tensor, cfg: VisualBERTConfig):
    """Pooler + answer head: ``(scores, pooled)``."""
    if cfg.pooler_strategy == "vqa":
        idx = cls_index(input_mask)
        pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device),
                        idx]
    else:
        pooled = torch.tanh(hidden[:, 0] @ params["pooler"]["w"]
                            + params["pooler"]["b"])
    t = params["head"]["transform"]
    h = gelu(pooled @ t["w"] + t["b"])
    h = layer_norm(h, t["ln"]["scale"], t["ln"]["bias"],
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
    g1 = layer_norm(gelu(pooled @ t["w"] + t["b"]), t["ln"]["scale"],
                    t["ln"]["bias"], cfg.bert.layer_norm_eps)
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
