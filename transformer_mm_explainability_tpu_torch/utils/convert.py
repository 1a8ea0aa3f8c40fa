"""Checkpoint converters into the port's models.

Counterpart of ``transformer_mm_explainability_tpu/utils/convert.py`` for
the models the port has: timm ViT, the detectron2-layout Faster R-CNN
(``unc-nlp/frcnn-vg-finetuned``) and HF LXMERT with its BERT encoders.
Linear weights are stored input-major (``x @ w + b``, the transpose of
torch's ``[out, in]``); the ViT patchify conv becomes a ``[P*P*C, D]``
matmul weight in ``models/vit.patchify``'s (row, col, channel) order; qkv
stays fused (q | k | v along the columns); per-layer weights of the BERT
and LXMERT stacks are stacked along a leading layer axis; conv weights are
OIHW in channels_last memory format (the JAX package keeps them HWIO).

The ``*_from_jax_numpy`` functions carry a JAX params pytree whose leaves
are numpy arrays into the port, so that both packages run on the same
weights; the state-dict converters build that tree's layout and go through
them.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from transformer_mm_explainability_tpu_torch.models.vit import ViT, ViTConfig
from transformer_mm_explainability_tpu_torch.ops.attention import (
    AttentionParams,
    CrossAttentionParams,
)


def _np(t) -> np.ndarray:
    """torch tensor (or array) → float32 numpy."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _lin(sd: Mapping[str, Any], prefix: str):
    """torch Linear → (w [in, out], b [out]) numpy."""
    return _np(sd[f"{prefix}.weight"]).T, _np(sd[f"{prefix}.bias"])


def _ln(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def patch_conv_to_matmul(w) -> np.ndarray:
    """Conv [D, C, P, P] (stride-P patchify) → matmul weight [P*P*C, D]."""
    w = _np(w)
    return w.transpose(2, 3, 1, 0).reshape(-1, w.shape[0])


def _stack(trees):
    """Stack identical nested dicts (and NamedTuples) of arrays along a new
    leading axis."""
    if isinstance(trees[0], Mapping):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if hasattr(trees[0], "_fields"):
        return type(trees[0])(*(_stack(list(xs)) for xs in zip(*trees)))
    return np.stack(trees)


def vit_from_jax_numpy(tree: Mapping[str, Any], cfg: ViTConfig,
                       device="cuda") -> ViT:
    """Build the port's ViT from the JAX package's ViT params pytree with
    every leaf already a numpy array (``blocks`` stacked along a leading
    layer axis; ``blocks["attn"]`` an ``AttentionParams`` NamedTuple or a
    dict with the same four names)."""
    model = ViT(cfg, device)
    blocks = tree["blocks"]
    attn = blocks["attn"]
    if not isinstance(attn, Mapping):
        attn = attn._asdict()
    pairs = [
        (model.patch_w, tree["patch_embed"]["w"]),
        (model.patch_b, tree["patch_embed"]["b"]),
        (model.cls_token, tree["cls_token"]),
        (model.pos_embed, tree["pos_embed"]),
        (model.norm_scale, tree["norm"]["scale"]),
        (model.norm_bias, tree["norm"]["bias"]),
        (model.head_w, tree["head"]["w"]),
        (model.head_b, tree["head"]["b"]),
    ]
    for i, blk in enumerate(model.blocks):
        pairs += [
            (blk.ln1_scale, blocks["ln1"]["scale"][i]),
            (blk.ln1_bias, blocks["ln1"]["bias"][i]),
            (blk.w_qkv, attn["w_qkv"][i]), (blk.b_qkv, attn["b_qkv"][i]),
            (blk.w_out, attn["w_out"][i]), (blk.b_out, attn["b_out"][i]),
            (blk.ln2_scale, blocks["ln2"]["scale"][i]),
            (blk.ln2_bias, blocks["ln2"]["bias"][i]),
            (blk.w1, blocks["mlp"]["w1"][i]), (blk.b1, blocks["mlp"]["b1"][i]),
            (blk.w2, blocks["mlp"]["w2"][i]), (blk.b2, blocks["mlp"]["b2"][i]),
        ]
    with torch.no_grad():
        for param, value in pairs:
            value = _np(value)
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"shape {value.shape} does not fit "
                                 f"parameter {tuple(param.shape)}")
            param.copy_(torch.tensor(value))
    return model


def vit_from_state_dict(sd: Mapping[str, Any], device="cuda"):
    """Convert a timm ``vit_base_patch16_224``-layout state dict
    (patch_embed.proj / blocks.N.{norm1,attn.qkv,attn.proj,norm2,mlp} /
    norm / head) to (ViT, ViTConfig)."""
    D = _np(sd["cls_token"]).shape[-1]
    depth = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    patch = _np(sd["patch_embed.proj.weight"]).shape[-1]
    S = _np(sd["pos_embed"]).shape[-2]
    grid = int(round((S - 1) ** 0.5))
    cfg = ViTConfig(image_size=grid * patch, patch_size=patch, width=D,
                    depth=depth, num_heads=D // 64,
                    num_classes=_np(sd["head.weight"]).shape[0])
    blocks = []
    for i in range(depth):
        p = f"blocks.{i}"
        w_qkv, b_qkv = _lin(sd, f"{p}.attn.qkv")
        w_out, b_out = _lin(sd, f"{p}.attn.proj")
        w1, b1 = _lin(sd, f"{p}.mlp.fc1")
        w2, b2 = _lin(sd, f"{p}.mlp.fc2")
        blocks.append({
            "ln1": _ln(sd, f"{p}.norm1"),
            "attn": {"w_qkv": w_qkv, "b_qkv": b_qkv,
                     "w_out": w_out, "b_out": b_out},
            "ln2": _ln(sd, f"{p}.norm2"),
            "mlp": {"w1": w1, "b1": b1, "w2": w2, "b2": b2},
        })
    head_w, head_b = _lin(sd, "head")
    tree = {
        "patch_embed": {
            "w": patch_conv_to_matmul(sd["patch_embed.proj.weight"]),
            "b": _np(sd["patch_embed.proj.bias"])},
        "cls_token": _np(sd["cls_token"]).reshape(1, D),
        "pos_embed": _np(sd["pos_embed"]).reshape(S, D),
        "blocks": _stack(blocks),
        "norm": _ln(sd, "norm"),
        "head": {"w": head_w, "b": head_b},
    }
    return vit_from_jax_numpy(tree, cfg, device), cfg


# ---------------------------------------------------------------------------
# trees of numpy arrays (the JAX package's layout) → the port's trees
# ---------------------------------------------------------------------------

_NAMED = {cls._fields: cls for cls in (AttentionParams, CrossAttentionParams)}


def _to_torch(tree, device, hwio: bool = False):
    """Map a tree of arrays (dicts, lists, the JAX package's or the port's
    attention NamedTuples) to the port's tree of float32 tensors on
    ``device``. With ``hwio``, every 4-D leaf is an HWIO conv weight and
    becomes OIHW, channels_last."""
    if isinstance(tree, Mapping):
        return {k: _to_torch(v, device, hwio) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        cls = _NAMED[tuple(tree._fields)]
        return cls(*(_to_torch(v, device, hwio) for v in tree))
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device, hwio) for v in tree]
    t = torch.from_numpy(np.array(_np(tree)))
    if hwio and t.dim() == 4:
        t = t.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return t.to(device)


# ---------------------------------------------------------------------------
# Faster R-CNN (unc-nlp/frcnn-vg-finetuned, detectron2-port layout:
# backbone.stem + backbone.res2-4, roi_heads.res5, proposal_generator.
# rpn_head.{conv,objectness_logits,anchor_deltas}, roi_heads.box_predictor.
# {cls_score,bbox_pred,cls_embedding,fc_attr,attr_score}; conv norms are
# FrozenBatchNorm at ``.norm.*``)
# ---------------------------------------------------------------------------

def frcnn_from_jax_numpy(tree: Mapping[str, Any], cfg,
                         device="cuda") -> Dict[str, Any]:
    """The JAX ``models/frcnn`` params pytree (numpy leaves, HWIO convs)
    → the port's tree (OIHW channels_last convs) on ``device``. ``cfg``
    (a ``models.frcnn.FrcnnConfig``) must have the tree's stage sizes."""
    got = tuple(len(blocks) for blocks in tree["backbone"]["layers"])
    if got != tuple(cfg.stages):
        raise ValueError(f"backbone stages {got} do not fit cfg.stages "
                         f"{tuple(cfg.stages)}")
    return _to_torch(tree, device, hwio=True)


def _conv_hwio(w) -> np.ndarray:
    """torch conv [out, in, kh, kw] → HWIO [kh, kw, in, out]."""
    return _np(w).transpose(2, 3, 1, 0)


def _d2_bn(sd, prefix) -> Dict[str, np.ndarray]:
    return {"weight": _np(sd[f"{prefix}.norm.weight"]),
            "bias": _np(sd[f"{prefix}.norm.bias"]),
            "mean": _np(sd[f"{prefix}.norm.running_mean"]),
            "var": _np(sd[f"{prefix}.norm.running_var"])}


def _d2_block(sd, p) -> Dict[str, Any]:
    blk = {
        "conv1": {"w": _conv_hwio(sd[f"{p}.conv1.weight"])},
        "bn1": _d2_bn(sd, f"{p}.conv1"),
        "conv2": {"w": _conv_hwio(sd[f"{p}.conv2.weight"])},
        "bn2": _d2_bn(sd, f"{p}.conv2"),
        "conv3": {"w": _conv_hwio(sd[f"{p}.conv3.weight"])},
        "bn3": _d2_bn(sd, f"{p}.conv3"),
    }
    if f"{p}.shortcut.weight" in sd:
        blk["downsample"] = {"w": _conv_hwio(sd[f"{p}.shortcut.weight"])}
        blk["downsample_bn"] = _d2_bn(sd, f"{p}.shortcut")
    return blk


def _conv_b(sd, p):
    return {"w": _conv_hwio(sd[f"{p}.weight"]), "b": _np(sd[f"{p}.bias"])}


def frcnn_from_state_dict(sd: Mapping[str, Any], cfg,
                          device="cuda") -> Dict[str, Any]:
    """unc-nlp/frcnn-vg-finetuned checkpoint → the port's ``models/frcnn``
    tree on ``device``. ``cfg`` (a ``FrcnnConfig``) gives the stage
    sizes."""
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):] if k.startswith("model.") else k: v
              for k, v in sd.items()}
    layers = [[_d2_block(sd, f"backbone.res{si + 2}.{bi}")
               for bi in range(n_blocks)]
              for si, n_blocks in enumerate(cfg.stages[:3])]
    layers.append([_d2_block(sd, f"roi_heads.res5.{bi}")
                   for bi in range(cfg.stages[3])])
    cls_w, cls_b = _lin(sd, "roi_heads.box_predictor.cls_score")
    bbox_w, bbox_b = _lin(sd, "roi_heads.box_predictor.bbox_pred")
    attr_fc_w, attr_fc_b = _lin(sd, "roi_heads.box_predictor.fc_attr")
    attr_w, attr_b = _lin(sd, "roi_heads.box_predictor.attr_score")
    rpn = "proposal_generator.rpn_head"
    tree = {
        "backbone": {
            "conv1": {"w": _conv_hwio(sd["backbone.stem.conv1.weight"])},
            "bn1": _d2_bn(sd, "backbone.stem.conv1"),
            "layers": layers,
        },
        "rpn": {"conv": _conv_b(sd, f"{rpn}.conv"),
                "objectness": _conv_b(sd, f"{rpn}.objectness_logits"),
                "deltas": _conv_b(sd, f"{rpn}.anchor_deltas")},
        "cls_score": {"w": cls_w, "b": cls_b},
        "bbox_pred": {"w": bbox_w, "b": bbox_b},
        "attr_cls_emb": _np(sd["roi_heads.box_predictor.cls_embedding.weight"]),
        "attr_fc": {"w": attr_fc_w, "b": attr_fc_b},
        "attr_score": {"w": attr_w, "b": attr_b},
    }
    return frcnn_from_jax_numpy(tree, cfg, device)


# ---------------------------------------------------------------------------
# HF BERT encoder / embeddings and LXMERT (HF lxmert layout, including the
# reference's lxmert_lrp naming)
# ---------------------------------------------------------------------------

def _bert_encoder_np(sd: Mapping[str, Any], num_layers: int, prefix: str):
    layers = []
    for i in range(num_layers):
        p = f"{prefix}.{i}"
        wq, bq = _lin(sd, f"{p}.attention.self.query")
        wk, bk = _lin(sd, f"{p}.attention.self.key")
        wv, bv = _lin(sd, f"{p}.attention.self.value")
        wo, bo = _lin(sd, f"{p}.attention.output.dense")
        w1, b1 = _lin(sd, f"{p}.intermediate.dense")
        w2, b2 = _lin(sd, f"{p}.output.dense")
        layers.append({
            "attn": AttentionParams(
                w_qkv=np.concatenate([wq, wk, wv], axis=1),
                b_qkv=np.concatenate([bq, bk, bv]), w_out=wo, b_out=bo),
            "attn_ln": _ln(sd, f"{p}.attention.output.LayerNorm"),
            "mlp": {"w1": w1, "b1": b1, "w2": w2, "b2": b2},
            "mlp_ln": _ln(sd, f"{p}.output.LayerNorm"),
        })
    return _stack(layers)


def _bert_embeddings_np(sd: Mapping[str, Any], prefix: str):
    return {
        "word": _np(sd[f"{prefix}.word_embeddings.weight"]),
        "position": _np(sd[f"{prefix}.position_embeddings.weight"]),
        "token_type": _np(sd[f"{prefix}.token_type_embeddings.weight"]),
        "ln": _ln(sd, f"{prefix}.LayerNorm"),
    }


def bert_encoder_from_state_dict(sd: Mapping[str, Any], num_layers: int,
                                 prefix: str = "layer", device="cuda"):
    """An HF-layout BertEncoder state dict
    (``layer.N.attention.self.{query,key,value}`` /
    ``layer.N.attention.output`` / ``layer.N.{intermediate,output}``) →
    the stacked encoder tree of ``models/bert`` (fused qkv) on
    ``device``."""
    return _to_torch(_bert_encoder_np(sd, num_layers, prefix), device)


def bert_embeddings_from_state_dict(sd: Mapping[str, Any],
                                    prefix: str = "embeddings",
                                    device="cuda"):
    """word / position / token-type embeddings + LN → ``models/bert``
    layout on ``device``."""
    return _to_torch(_bert_embeddings_np(sd, prefix), device)


def _cross_attn(sd: Mapping[str, Any], att_prefix: str, out_prefix: str):
    """LxmertAttention (query/key/value) + LxmertAttentionOutput →
    (CrossAttentionParams, LN dict)."""
    wq, bq = _lin(sd, f"{att_prefix}.query")
    wk, bk = _lin(sd, f"{att_prefix}.key")
    wv, bv = _lin(sd, f"{att_prefix}.value")
    wo, bo = _lin(sd, f"{out_prefix}.dense")
    return (CrossAttentionParams(w_q=wq, b_q=bq, w_k=wk, b_k=bk, w_v=wv,
                                 b_v=bv, w_out=wo, b_out=bo),
            _ln(sd, f"{out_prefix}.LayerNorm"))


def _ffn(sd: Mapping[str, Any], inter_prefix: str, out_prefix: str):
    w1, b1 = _lin(sd, f"{inter_prefix}.dense")
    w2, b2 = _lin(sd, f"{out_prefix}.dense")
    return {"w1": w1, "b1": b1, "w2": w2, "b2": b2,
            "ln": _ln(sd, f"{out_prefix}.LayerNorm")}


def lxmert_from_jax_numpy(tree: Mapping[str, Any], cfg,
                          device="cuda") -> Dict[str, Any]:
    """The JAX ``models/lxmert`` params pytree (numpy leaves) → the port's
    tree on ``device``. ``cfg`` (a ``models.lxmert.LxmertConfig``) must
    have the tree's layer counts."""
    got = (len(tree["lang_layers"]["attn"][0]),
           len(tree["visn_layers"]["attn"][0]),
           len(tree["x_layers"]["lang_ffn"]["w1"]))
    want = (cfg.l_layers, cfg.r_layers, cfg.x_layers)
    if got != want:
        raise ValueError(f"layer counts (l, r, x) {got} do not fit the "
                         f"config's {want}")
    return _to_torch(tree, device)


def lxmert_from_state_dict(sd: Mapping[str, Any], cfg,
                           device="cuda") -> Dict[str, Any]:
    """An HF/reference LXMERT state dict (``lxmert.`` prefix stripped or
    present) → the port's ``models/lxmert`` tree on ``device``. ``cfg``
    gives the layer counts. Both cross-attention directions share the
    ``visual_attention`` weights and its output LN, as in the reference."""
    if any(k.startswith("lxmert.") for k in sd):
        sd = {(k[len("lxmert."):] if k.startswith("lxmert.") else k): v
              for k, v in sd.items()}
    x_layers = []
    for i in range(cfg.x_layers):
        p = f"encoder.x_layers.{i}"
        cross, cross_ln = _cross_attn(sd, f"{p}.visual_attention.att",
                                      f"{p}.visual_attention.output")
        lang_self, lang_self_ln = _cross_attn(
            sd, f"{p}.lang_self_att.self", f"{p}.lang_self_att.output")
        visn_self, visn_self_ln = _cross_attn(
            sd, f"{p}.visn_self_att.self", f"{p}.visn_self_att.output")
        x_layers.append({
            "cross": cross, "cross_ln_lang": cross_ln,
            "cross_ln_visn": cross_ln,
            "lang_self": lang_self, "lang_self_ln": lang_self_ln,
            "visn_self": visn_self, "visn_self_ln": visn_self_ln,
            "lang_ffn": _ffn(sd, f"{p}.lang_inter", f"{p}.lang_output"),
            "visn_ffn": _ffn(sd, f"{p}.visn_inter", f"{p}.visn_output"),
        })
    fw, fb = _lin(sd, "encoder.visn_fc.visn_fc")
    pw, pb = _lin(sd, "encoder.visn_fc.box_fc")
    pool_w, pool_b = _lin(sd, "pooler.dense")
    a0w, a0b = _lin(sd, "answer_head.logit_fc.0")
    a3w, a3b = _lin(sd, "answer_head.logit_fc.3")
    tree = {
        "embeddings": _bert_embeddings_np(sd, "embeddings"),
        "visn_fc": {
            "feat": {"w": fw, "b": fb},
            "feat_ln": _ln(sd, "encoder.visn_fc.visn_layer_norm"),
            "pos": {"w": pw, "b": pb},
            "pos_ln": _ln(sd, "encoder.visn_fc.box_layer_norm"),
        },
        "lang_layers": _bert_encoder_np(sd, cfg.l_layers, "encoder.layer"),
        "visn_layers": _bert_encoder_np(sd, cfg.r_layers, "encoder.r_layers"),
        "x_layers": _stack(x_layers),
        "pooler": {"w": pool_w, "b": pool_b},
        "answer_head": {"w1": a0w, "b1": a0b,
                        "ln": _ln(sd, "answer_head.logit_fc.2"),
                        "w2": a3w, "b2": a3b},
    }
    return lxmert_from_jax_numpy(tree, cfg, device)
