"""LXMERT (9 language / 5 visual / 5 cross-modal layers) with capture, in
PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/lxmert.py``:
embeddings, the visual feature encoder ``(LN(W_f f) + LN(W_p p))/2``,
BERT-style single-modality stacks, cross-modal layers (cross → self → FFN
on both streams), the pooler on the language CLS and the VQA answer head
``Linear → GELU → LN → Linear``.

The reference's quirk is kept: both cross-attention directions use the
SAME weights (its ``visual_attention_copy`` only holds separate hook
state), and both are computed from the pre-update streams.

``capture`` returns the six stacked attention families of ``LxmertTaps``
and their gradients from one forward and one backward, the way
``models/vit.capture`` does: zero taps that require grad are added to every
attention's probabilities, and ``torch.autograd.grad`` of the explained
answer's score with respect to the taps gives every ∇A.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from transformer_mm_explainability_tpu_torch.models import bert
from transformer_mm_explainability_tpu_torch.ops.attention import (
    CrossAttentionParams,
    gelu,
    layer_norm,
    multi_head_cross_attention,
)


@dataclasses.dataclass(frozen=True)
class LxmertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    l_layers: int = 9
    x_layers: int = 5
    r_layers: int = 5
    visual_feat_dim: int = 2048
    visual_pos_dim: int = 4
    num_qa_labels: int = 3129
    layer_norm_eps: float = 1e-12

    @property
    def bert(self) -> bert.BertConfig:
        return bert.BertConfig(
            vocab_size=self.vocab_size,
            hidden_size=self.hidden_size,
            num_hidden_layers=self.l_layers,
            num_attention_heads=self.num_attention_heads,
            intermediate_size=self.intermediate_size,
            max_position_embeddings=self.max_position_embeddings,
            type_vocab_size=self.type_vocab_size,
            layer_norm_eps=self.layer_norm_eps,
        )


LXMERT_VQA = LxmertConfig()


class LxmertTaps(NamedTuple):
    """Taps / captures of the six attention families.

    lang:   [Ll, B, H, St, St]   language self-attention stack
    visn:   [Lr, B, H, Sv, Sv]   visual (relational) self-attention stack
    x_lang_cross: [Lx, B, H, St, Sv]  txt←img cross (``visual_attention``)
    x_visn_cross: [Lx, B, H, Sv, St]  img←txt cross (``..._copy``)
    x_lang_self:  [Lx, B, H, St, St]
    x_visn_self:  [Lx, B, H, Sv, Sv]
    """

    lang: torch.Tensor
    visn: torch.Tensor
    x_lang_cross: torch.Tensor
    x_visn_cross: torch.Tensor
    x_lang_self: torch.Tensor
    x_visn_self: torch.Tensor


def zero_taps(cfg: LxmertConfig, B: int, St: int, Sv: int, device="cpu",
              dtype: torch.dtype = torch.float32,
              requires_grad: bool = False) -> LxmertTaps:
    H = cfg.num_attention_heads
    z = lambda L, Sq, Sk: torch.zeros((L, B, H, Sq, Sk), dtype=dtype,
                                      device=device,
                                      requires_grad=requires_grad)
    return LxmertTaps(
        lang=z(cfg.l_layers, St, St),
        visn=z(cfg.r_layers, Sv, Sv),
        x_lang_cross=z(cfg.x_layers, St, Sv),
        x_visn_cross=z(cfg.x_layers, Sv, St),
        x_lang_self=z(cfg.x_layers, St, St),
        x_visn_self=z(cfg.x_layers, Sv, Sv),
    )


def _stack(trees):
    """Stack identical trees (dicts / NamedTuples of tensors) along a new
    leading layer axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if hasattr(first, "_fields"):
        return type(first)(*(_stack(list(xs)) for xs in zip(*trees)))
    return torch.stack(trees)


def init_params(seed: Union[int, torch.Generator] = 0,
                cfg: LxmertConfig = LXMERT_VQA,
                device="cuda") -> Dict[str, Any]:
    """Random weights in the JAX tree's structure (normal, std 0.02; zero
    biases; LN at identity), drawn on the CPU from ``seed``."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    D, Dm = cfg.hidden_size, cfg.intermediate_size
    nrm = lambda *shape: (torch.randn(shape, generator=gen) * 0.02).to(device)
    zeros = lambda *shape: torch.zeros(shape, device=device)
    ln = lambda n: {"scale": torch.ones(n, device=device), "bias": zeros(n)}

    def cross_attn():
        return CrossAttentionParams(
            w_q=nrm(D, D), b_q=zeros(D), w_k=nrm(D, D), b_k=zeros(D),
            w_v=nrm(D, D), b_v=zeros(D), w_out=nrm(D, D), b_out=zeros(D))

    def ffn():
        return {"w1": nrm(D, Dm), "b1": zeros(Dm), "w2": nrm(Dm, D),
                "b2": zeros(D), "ln": ln(D)}

    def x_layer():
        return {"cross": cross_attn(), "cross_ln_lang": ln(D),
                "cross_ln_visn": ln(D), "lang_self": cross_attn(),
                "lang_self_ln": ln(D), "visn_self": cross_attn(),
                "visn_self_ln": ln(D), "lang_ffn": ffn(), "visn_ffn": ffn()}

    rcfg = dataclasses.replace(cfg.bert, num_hidden_layers=cfg.r_layers)
    return {
        "embeddings": bert.init_embedding_params(gen, cfg.bert, device),
        "visn_fc": {
            "feat": {"w": nrm(cfg.visual_feat_dim, D), "b": zeros(D)},
            "feat_ln": ln(D),
            "pos": {"w": nrm(cfg.visual_pos_dim, D), "b": zeros(D)},
            "pos_ln": ln(D),
        },
        "lang_layers": bert.init_encoder_params(gen, cfg.bert, device),
        "visn_layers": bert.init_encoder_params(gen, rcfg, device),
        "x_layers": _stack([x_layer() for _ in range(cfg.x_layers)]),
        "pooler": {"w": nrm(D, D), "b": zeros(D)},
        "answer_head": {"w1": nrm(D, 2 * D), "b1": zeros(2 * D),
                        "ln": ln(2 * D), "w2": nrm(2 * D, cfg.num_qa_labels),
                        "b2": zeros(cfg.num_qa_labels)},
    }


def params_to(tree, device):
    """The same tree with every tensor on ``device`` (no copy where it is
    there already)."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(params_to(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to(v, device) for v in tree)
    return tree.to(device)


def _attn_block(p_attn, p_ln, x_q, x_kv, H, mask, tap, eps):
    """attention + residual + LN (LxmertSelfAttentionLayer /
    LxmertCrossAttentionLayer + LxmertAttentionOutput)."""
    out, probs = multi_head_cross_attention(p_attn, x_q, x_kv, H, mask=mask,
                                            tap=tap)
    return layer_norm(x_q + out, p_ln["scale"], p_ln["bias"], eps), probs


def _ffn_block(p, x, eps):
    h = gelu(x @ p["w1"] + p["b1"])
    h = h @ p["w2"] + p["b2"]
    return layer_norm(x + h, p["ln"]["scale"], p["ln"]["bias"], eps)


def forward(params: Dict[str, Any], input_ids: torch.Tensor,
            attention_mask: torch.Tensor, visual_feats: torch.Tensor,
            visual_pos: torch.Tensor,
            token_type_ids: Optional[torch.Tensor] = None,
            visual_mask: Optional[torch.Tensor] = None,
            cfg: LxmertConfig = LXMERT_VQA,
            taps: Optional[LxmertTaps] = None,
            return_tape: bool = False) -> Dict[str, Any]:
    """Returns {"qa_scores": [B, A], "attn": LxmertTaps of probs,
    "lang_output", "visn_output", "pooled"} (+ "tape" with the per-layer
    inputs and masks when ``return_tape``)."""
    H = cfg.num_attention_heads
    eps = cfg.layer_norm_eps
    tap = (lambda fam, i: None) if taps is None else \
        (lambda fam, i: getattr(taps, fam)[i])

    # --- embeddings -------------------------------------------------------
    emb = bert.text_embeddings(params["embeddings"], input_ids,
                               token_type_ids)
    ln = params["embeddings"]["ln"]
    lang = layer_norm(emb, ln["scale"], ln["bias"], eps)

    vf = params["visn_fc"]
    fx = visual_feats @ vf["feat"]["w"] + vf["feat"]["b"]
    fx = layer_norm(fx, vf["feat_ln"]["scale"], vf["feat_ln"]["bias"], eps)
    px = visual_pos @ vf["pos"]["w"] + vf["pos"]["b"]
    px = layer_norm(px, vf["pos_ln"]["scale"], vf["pos_ln"]["bias"], eps)
    visn = (fx + px) / 2.0

    lang_mask = bert.extended_attention_mask(attention_mask, lang.dtype)
    visn_mask = (None if visual_mask is None
                 else bert.extended_attention_mask(visual_mask, lang.dtype))

    # --- language + relational single-modality stacks ---------------------
    lang, lang_attn, lang_tape = bert.encoder(
        params["lang_layers"], lang, cfg.bert, lang_mask,
        None if taps is None else taps.lang, return_tape=True)
    visn, visn_attn, visn_tape = bert.encoder(
        params["visn_layers"], visn,
        dataclasses.replace(cfg.bert, num_hidden_layers=cfg.r_layers),
        visn_mask, None if taps is None else taps.visn, return_tape=True)

    # --- cross-modality layers --------------------------------------------
    caps = {name: [] for name in ("lc", "vc", "ls", "vs")}
    x_tape = ([], [])
    for i in range(cfg.x_layers):
        p = bert.unstack(params["x_layers"], i)
        x_tape[0].append(lang)
        x_tape[1].append(visn)
        # cross attention, both directions from the PRE-update streams,
        # shared weights
        lang1, probs_lc = _attn_block(p["cross"], p["cross_ln_lang"], lang,
                                      visn, H, visn_mask,
                                      tap("x_lang_cross", i), eps)
        visn1, probs_vc = _attn_block(p["cross"], p["cross_ln_visn"], visn,
                                      lang, H, lang_mask,
                                      tap("x_visn_cross", i), eps)
        lang2, probs_ls = _attn_block(p["lang_self"], p["lang_self_ln"],
                                      lang1, lang1, H, lang_mask,
                                      tap("x_lang_self", i), eps)
        visn2, probs_vs = _attn_block(p["visn_self"], p["visn_self_ln"],
                                      visn1, visn1, H, visn_mask,
                                      tap("x_visn_self", i), eps)
        lang = _ffn_block(p["lang_ffn"], lang2, eps)
        visn = _ffn_block(p["visn_ffn"], visn2, eps)
        for name, pr in zip(caps, (probs_lc, probs_vc, probs_ls, probs_vs)):
            caps[name].append(pr)

    pooled = torch.tanh(lang[:, 0] @ params["pooler"]["w"]
                        + params["pooler"]["b"])
    ah = params["answer_head"]
    h = gelu(pooled @ ah["w1"] + ah["b1"])
    h = layer_norm(h, ah["ln"]["scale"], ah["ln"]["bias"], eps)
    qa_scores = h @ ah["w2"] + ah["b2"]

    attn = LxmertTaps(lang=lang_attn, visn=visn_attn,
                      x_lang_cross=torch.stack(caps["lc"]),
                      x_visn_cross=torch.stack(caps["vc"]),
                      x_lang_self=torch.stack(caps["ls"]),
                      x_visn_self=torch.stack(caps["vs"]))
    out = {"qa_scores": qa_scores, "attn": attn, "lang_output": lang,
           "visn_output": visn, "pooled": pooled}
    if return_tape:
        out["tape"] = {"lang": lang_tape, "visn": visn_tape,
                       "x": (torch.stack(x_tape[0]), torch.stack(x_tape[1])),
                       "lang_final": lang, "visn_final": visn,
                       "lang_mask": lang_mask, "visn_mask": visn_mask}
    return out


def capture(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            targets: Optional[torch.Tensor], cfg: LxmertConfig = LXMERT_VQA
            ) -> Tuple[torch.Tensor, LxmertTaps, LxmertTaps]:
    """One forward and one backward: ``(qa_scores, attn probs, attn
    gradients)``. ``targets=None`` explains the PREDICTED answer (the
    reference default, ``index=None → argmax(output)``), the argmax taken
    from the same forward, outside the graph."""
    B, St = batch["input_ids"].shape
    Sv = batch["visual_feats"].shape[1]
    taps = zero_taps(cfg, B, St, Sv, device=batch["visual_feats"].device,
                     requires_grad=True)
    with torch.enable_grad():
        out = forward(params, batch["input_ids"], batch["attention_mask"],
                      batch["visual_feats"], batch["visual_pos"],
                      batch.get("token_type_ids"), batch.get("visual_mask"),
                      cfg, taps)
        scores = out["qa_scores"]
        t = scores.detach().argmax(-1) if targets is None else targets
        s = scores.gather(1, t[:, None].long()).sum()
        # a family that cannot reach the score (the visual side of a single
        # x-layer) has a zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(s, list(taps), allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(taps, grads)]
    attn = LxmertTaps(*(a.detach() for a in out["attn"]))
    return scores.detach(), attn, LxmertTaps(*grads)
