"""Plain VisualBERT on VQA2 (Li et al. 2019; MMF's ``visual_bert`` with the
``vqa`` pooler), its ``ours_no_lrp`` explanation and the image-perturbation
protocol of Chefer et al. 2021, in PyTorch.

The model: text embeddings (word + position + token type 0) and the boxes'
2048-d features projected to the hidden width (+ visual token type 0 and
visual position 0, no text alignment), concatenated under one LayerNorm;
post-LN BERT layers with the additive −10000 padding mask over text then
boxes; the answer head reads the hidden state at token
``Σ input_mask − 2`` (the question mark), then dense + GELU + LayerNorm and
the classifier. No query row is ever fully masked (the [CLS] token is
always valid), so no row needs the all-masked rule.

``explain``: one forward with zero taps on every layer's probabilities A,
one backward of Σ_b scores[b, targets[b]] to the taps, rule 5 and rule 6 on
the whole matrix (``common.rule6_row``), the row of the pooled token with
its own column zeroed. ``perturb`` is the protocol in the port's place (the
control): the answer is the argmax of the scores, each step keeps the
``int((1 − step)·n)`` boxes of highest relevancy (a stable sort), and a
step's accuracy is the soft score of the argmax answer of the forward with
only those boxes unmasked. Computed in blocks of ``block`` samples.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from portbench.core import seeds
from portbench.reference import common


def layout(cfg) -> List[seeds.Leaf]:
    """Normal (std ``init_std``) tables and products, LayerNorm at
    identity, zero biases; the encoder's leaves stacked over layers."""
    D, I, L = (cfg["hidden_size"], cfg["intermediate_size"],
               cfg["num_hidden_layers"])
    Pn, T = cfg["max_position_embeddings"], cfg["type_vocab_size"]
    return [
        ("word", (cfg["vocab_size"], D), "normal"),
        ("position", (Pn, D), "normal"), ("token_type", (T, D), "normal"),
        ("emb_ln_scale", (D,), "ones"), ("emb_ln_bias", (D,), "zeros"),
        ("vis_w", (cfg["visual_embedding_dim"], D), "normal"),
        ("vis_b", (D,), "zeros"),
        ("vis_token_type", (T, D), "normal"),
        ("vis_position", (Pn, D), "normal"),
        ("w_qkv", (L, D, 3 * D), "normal"), ("b_qkv", (L, 3 * D), "zeros"),
        ("w_out", (L, D, D), "normal"), ("b_out", (L, D), "zeros"),
        ("attn_ln_scale", (L, D), "ones"), ("attn_ln_bias", (L, D), "zeros"),
        ("w1", (L, D, I), "normal"), ("b1", (L, I), "zeros"),
        ("w2", (L, I, D), "normal"), ("b2", (L, D), "zeros"),
        ("mlp_ln_scale", (L, D), "ones"), ("mlp_ln_bias", (L, D), "zeros"),
        ("head_w", (D, D), "normal"), ("head_b", (D,), "zeros"),
        ("head_ln_scale", (D,), "ones"), ("head_ln_bias", (D,), "zeros"),
        ("cls_w", (D, cfg["num_labels"]), "normal"),
        ("cls_b", (cfg["num_labels"],), "zeros"),
    ]


def weights(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    return seeds.draw_leaves(layout(cfg), seed, device, cfg["init_std"])


def _forward(w, cfg, batch, taps, tf32: bool):
    """(scores [B, labels], A per layer or None)."""
    mm = lambda a, b: common.matmul(a, b, tf32)
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    eps = cfg["layer_norm_eps"]
    ids, tmask = batch["input_ids"].long(), batch["input_mask"]
    feats, vmask = batch["visual_embeddings"], batch["visual_mask"]
    B, St = ids.shape
    x = w["word"][ids] + w["position"][:St] + w["token_type"][0]
    v = (mm(feats, w["vis_w"]) + w["vis_b"] + w["vis_token_type"][0]
         + w["vis_position"][0])
    x = common.layer_norm(torch.cat([x, v], dim=1), w["emb_ln_scale"],
                          w["emb_ln_bias"], eps)
    valid = torch.cat([tmask, vmask], dim=1).float()
    bias = ((1.0 - valid) * -10000.0)[:, None, None, :]
    S, dh = x.shape[1], D // H
    attn = []
    for l in range(cfg["num_hidden_layers"]):
        p = lambda k: w[k][l]
        qkv = mm(x, p("w_qkv")) + p("b_qkv")
        q, k, v = qkv.view(B, S, 3, H, dh).permute(2, 0, 3, 1, 4)
        a = torch.softmax(mm(q, k.transpose(-1, -2)) / math.sqrt(dh) + bias,
                          dim=-1)
        o = mm(a if taps is None else a + taps[l], v)
        o = mm(o.transpose(1, 2).reshape(B, S, D), p("w_out")) + p("b_out")
        x = common.layer_norm(x + o, p("attn_ln_scale"), p("attn_ln_bias"),
                              eps)
        h = mm(common.gelu(mm(x, p("w1")) + p("b1")), p("w2")) + p("b2")
        x = common.layer_norm(x + h, p("mlp_ln_scale"), p("mlp_ln_bias"),
                              eps)
        attn.append(a)
    pooled = x[torch.arange(B, device=x.device), pooled_index(tmask)]
    h = common.layer_norm(common.gelu(mm(pooled, w["head_w"]) + w["head_b"]),
                          w["head_ln_scale"], w["head_ln_bias"], eps)
    return mm(h, w["cls_w"]) + w["cls_b"], torch.stack(attn)


def pooled_index(input_mask: torch.Tensor) -> torch.Tensor:
    """The ``vqa`` pooler's token: the question mark before [SEP]."""
    return input_mask.long().sum(dim=1) - 2


def _blocks(batch, block: int):
    B = batch["input_ids"].shape[0]
    for i in range(0, B, block):
        yield i, {k: t[i:i + block] for k, t in batch.items()}


def forward(w, cfg, batch, tf32: bool = False, block: int = 8
            ) -> torch.Tensor:
    """Scores ``[B, labels]``, no gradient."""
    with torch.no_grad():
        return torch.cat([_forward(w, cfg, b, None, tf32)[0]
                          for _, b in _blocks(batch, block)])


def explain(w, cfg, batch, targets, tf32: bool = False, block: int = 8):
    """``(scores [B, labels], cam [B, S])`` for answers ``targets``."""
    out = [_explain(w, cfg, b, targets[i:i + len(b["input_ids"])], tf32)
           for i, b in _blocks(batch, block)]
    return torch.cat([s for s, _ in out]), torch.cat([c for _, c in out])


def _explain(w, cfg, batch, targets, tf32):
    B, St = batch["input_ids"].shape
    S = St + batch["visual_embeddings"].shape[1]
    L, H = cfg["num_hidden_layers"], cfg["num_attention_heads"]
    taps = torch.zeros((L, B, H, S, S), device=targets.device,
                       requires_grad=True)
    with torch.enable_grad():
        scores, attn = _forward(w, cfg, batch, taps, tf32)
        pick = scores.gather(1, targets.long()[:, None]).sum()
        (grads,) = torch.autograd.grad(pick, taps)
    ci = pooled_index(batch["input_mask"])
    with torch.no_grad():
        cam = common.rule6_row(attn.detach(), grads, ci, tf32)
        cam[torch.arange(B, device=cam.device), ci] = 0.0
    return scores.detach(), cam


def num_keep(steps: Sequence[float], n: int) -> List[int]:
    """Boxes kept at each step of ``n`` valid ones: ``int((1 − step)·n)``
    in float64, as the protocol's reference computes it."""
    return [int((1.0 - s) * n) for s in steps]


def keep_masks(cam_image: torch.Tensor, valid: torch.Tensor,
               steps: Sequence[float]) -> torch.Tensor:
    """``[N, n_steps, Nb]`` bool: at each step the ``num_keep`` valid boxes
    of highest relevancy (a stable descending sort; invalid boxes last)."""
    N, Nb = cam_image.shape
    out = torch.zeros((N, len(steps), Nb), dtype=torch.bool,
                      device=cam_image.device)
    ranked = torch.where(valid.bool(), cam_image,
                         torch.full_like(cam_image, float("-inf")))
    order = torch.argsort(-ranked, dim=-1, stable=True)
    for n in range(N):
        keeps = num_keep(steps, int(valid[n].sum()))
        for s, k in enumerate(keeps):
            out[n, s, order[n, :k]] = True
    return out


def perturb(w, cfg, batch, soft, steps, tf32: bool = False,
            block: int = 8):
    """The image-perturbation protocol (negative perturbation, the
    predicted answer explained): ``(accuracies [N, n_steps], record)``;
    the record holds what the judge reads of a run (``scores``, ``cam``,
    ``masks`` [N·n_steps, Nb], ``fwd`` [N·n_steps, labels])."""
    scores = forward(w, cfg, batch, tf32, block)
    answers = scores.argmax(-1)
    scores, cam = explain(w, cfg, batch, answers, tf32, block)
    St = batch["input_ids"].shape[1]
    keeps = keep_masks(cam[:, St:], batch["visual_mask"], steps)
    N, n, Nb = keeps.shape
    big = {k: t.repeat_interleave(n, dim=0) for k, t in batch.items()}
    big["visual_mask"] = keeps.reshape(N * n, Nb).to(torch.int32)
    fwd = forward(w, cfg, big, tf32, block * n)
    acc = torch.gather(soft, 1, fwd.reshape(N, n, -1).argmax(-1))
    return acc, {"scores": scores, "cam": cam, "masks": big["visual_mask"],
                 "fwd": fwd}
