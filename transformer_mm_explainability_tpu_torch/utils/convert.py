"""Checkpoint converters into the port's models.

Counterpart of ``transformer_mm_explainability_tpu/utils/convert.py`` for
the models the port has: timm ViT, the detectron2-layout Faster R-CNN
(``unc-nlp/frcnn-vg-finetuned``), HF LXMERT with its BERT encoders,
VisualBERT (its MMF state dict is read by ``utils/mmf_loader``), OpenAI
CLIP with a ViT or a ModifiedResNet vision tower, and the facebook DETR
release (a torchvision ResNet, torch-MHA attention with a fused
``in_proj``).
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
    if tree is None:            # an absent layer (a DETR segm adapter)
        return None
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


def _heads_from_jax_numpy(tree: Mapping[str, Any], want: Dict[str, tuple],
                          device) -> Dict[str, Any]:
    for key, shape in want.items():
        got = tuple(np.shape(tree[key]["w"] if isinstance(tree[key], Mapping)
                             else tree[key]))
        if got != shape:
            raise ValueError(f"{key}: shape {got}, the config wants {shape}")
    return _to_torch(tree, device)


def lxmert_pretrain_heads_from_jax_numpy(tree: Mapping[str, Any], cfg,
                                         device="cuda") -> Dict[str, Any]:
    """The JAX ``models/lxmert_pretrain.init_head_params`` tree (numpy
    leaves) → the port's heads on ``device``; ``cfg`` (a
    ``models.lxmert.LxmertConfig``) must fit the LM bias and the feature
    decoder."""
    D = cfg.hidden_size
    return _heads_from_jax_numpy(
        tree, {"lm_transform": (D, D), "lm_bias": (cfg.vocab_size,),
               "feat_decoder": (D, cfg.visual_feat_dim),
               "matching": (D, 2)}, device)


def nlvr2_head_from_jax_numpy(tree: Mapping[str, Any], hidden: int,
                              device="cuda") -> Dict[str, Any]:
    """The JAX ``train/lxmert_tasks.init_nlvr2_head`` tree (numpy leaves)
    → the port's NLVR2 head on ``device`` for an encoder of width
    ``hidden``."""
    return _heads_from_jax_numpy(
        tree, {"fc1": (2 * hidden, 2 * hidden), "fc2": (2 * hidden, 2)},
        device)


# ---------------------------------------------------------------------------
# VisualBERT (the MMF state dict is read by utils/mmf_loader)
# ---------------------------------------------------------------------------

def visual_bert_from_jax_numpy(tree: Mapping[str, Any], cfg,
                               device="cuda") -> Dict[str, Any]:
    """The JAX ``models/visual_bert`` params pytree (numpy leaves) → the
    port's tree on ``device``. ``cfg`` (a
    ``models.visual_bert.VisualBERTConfig``) must have the tree's depth and
    widths."""
    got = (len(tree["encoder"]["attn"][0]),
           tuple(np.shape(tree["visual"]["projection"]["w"])),
           np.shape(tree["head"]["classifier"]["w"])[-1])
    want = (cfg.bert.num_hidden_layers,
            (cfg.visual_embedding_dim, cfg.bert.hidden_size), cfg.num_labels)
    if got != want:
        raise ValueError(f"(layers, projection, labels) {got} do not fit "
                         f"the config's {want}")
    return _to_torch(tree, device)


def visual_bert_pretrain_head_from_jax_numpy(tree: Mapping[str, Any], cfg,
                                            device="cuda") -> Dict[str, Any]:
    """The JAX ``models/visual_bert.init_pretrain_params`` tree (numpy
    leaves) → the port's pretraining head on ``device``; ``cfg`` (a
    ``models.visual_bert.VisualBERTConfig``) must fit the transform, the
    LM bias and ``seq_relationship``."""
    D = cfg.bert.hidden_size
    return _heads_from_jax_numpy(
        tree, {"transform": (D, D), "decoder_bias": (cfg.bert.vocab_size,),
               "seq_relationship": (D, 2)}, device)


def visual_bert_nlvr2_head_from_jax_numpy(tree: Mapping[str, Any], cfg,
                                          device="cuda") -> Dict[str, Any]:
    """The JAX ``models/visual_bert.init_nlvr2_head`` tree (numpy leaves)
    → the port's NLVR2 head on ``device`` (sized 2·hidden, as ``cfg``
    says)."""
    D2 = 2 * cfg.bert.hidden_size
    labels = np.shape(tree["classifier"]["w"])[-1]
    return _heads_from_jax_numpy(
        tree, {"transform": (D2, D2), "classifier": (D2, labels)}, device)


def visual_bert_bypass_layer_from_jax_numpy(tree: Mapping[str, Any], cfg,
                                            device="cuda") -> Dict[str, Any]:
    """The JAX ``models/visual_bert.init_bypass_layer`` tree (a one-layer
    stacked BERT encoder, numpy leaves) → the port's on ``device``."""
    got = (len(tree["attn"][0]), tuple(np.shape(tree["mlp"]["w1"])[1:]))
    want = (1, (cfg.bert.hidden_size, cfg.bert.intermediate_size))
    if got != want:
        raise ValueError(f"(layers, mlp w1) {got} do not fit the config's "
                         f"{want}")
    return _to_torch(tree, device)


# ---------------------------------------------------------------------------
# CLIP (the OpenAI CLIP state dict; hyperparameters sniffed from shapes as
# the reference's build_model does)
# ---------------------------------------------------------------------------

def clip_from_jax_numpy(tree: Mapping[str, Any], cfg,
                        device="cuda") -> Dict[str, Any]:
    """The JAX ``models/clip`` params pytree (numpy leaves; HWIO convs in a
    ResNet tower) → the port's tree on ``device``. ``cfg`` (a
    ``models.clip.CLIPConfig``) must have the tree's depths."""
    got = len(tree["text"]["blocks"]["ln1"]["scale"])
    if cfg.is_resnet:
        got = (got, tuple(len(b) for b in tree["visual"]["layers"]))
        want = (cfg.transformer_layers, tuple(cfg.vision_layers))
    else:
        got = (got, len(tree["visual"]["blocks"]["ln1"]["scale"]))
        want = (cfg.transformer_layers, cfg.vision_layers)
    if got != want:
        raise ValueError(f"(text, vision) depths {got} do not fit the "
                         f"config's {want}")
    return _to_torch(tree, device, hwio=cfg.is_resnet)


def _clip_tower_np(sd: Mapping[str, Any], prefix: str, layers: int):
    blocks = []
    for i in range(layers):
        p = f"{prefix}.resblocks.{i}"
        w_out, b_out = _lin(sd, f"{p}.attn.out_proj")
        w1, b1 = _lin(sd, f"{p}.mlp.c_fc")
        w2, b2 = _lin(sd, f"{p}.mlp.c_proj")
        blocks.append({
            "ln1": _ln(sd, f"{p}.ln_1"),
            "attn": AttentionParams(
                w_qkv=_np(sd[f"{p}.attn.in_proj_weight"]).T,
                b_qkv=_np(sd[f"{p}.attn.in_proj_bias"]),
                w_out=w_out, b_out=b_out),
            "ln2": _ln(sd, f"{p}.ln_2"),
            "mlp": {"w1": w1, "b1": b1, "w2": w2, "b2": b2},
        })
    return _stack(blocks)


def _count(sd: Mapping[str, Any], prefix: str, part: int) -> int:
    return len({k.split(".")[part] for k in sd if k.startswith(prefix)})


def clip_from_state_dict(sd: Mapping[str, Any], device="cuda",
                         **config_overrides):
    """An OpenAI CLIP state dict (ViT or ModifiedResNet vision tower) →
    ``(params on device, CLIPConfig)``. Head counts are not in the shapes
    (OpenAI CLIP uses width/64): pass ``transformer_heads=...`` for other
    models."""
    import dataclasses

    from transformer_mm_explainability_tpu_torch.models import clip_resnet
    from transformer_mm_explainability_tpu_torch.models.clip import (
        CLIPConfig)

    width = _np(sd["ln_final.weight"]).shape[0]
    text_cfg = dict(
        context_length=_np(sd["positional_embedding"]).shape[0],
        vocab_size=_np(sd["token_embedding.weight"]).shape[0],
        transformer_width=width, transformer_heads=width // 64,
        transformer_layers=_count(sd, "transformer.resblocks.", 2))
    if "visual.proj" in sd:
        conv1 = _np(sd["visual.conv1.weight"])
        patch = conv1.shape[-1]
        grid = int(round(
            (_np(sd["visual.positional_embedding"]).shape[0] - 1) ** 0.5))
        cfg = CLIPConfig(
            embed_dim=_np(sd["text_projection"]).shape[1],
            image_resolution=grid * patch,
            vision_layers=_count(sd, "visual.transformer.resblocks.", 3),
            vision_width=conv1.shape[0], vision_patch_size=patch, **text_cfg)
    else:
        counts = []
        while f"visual.layer{len(counts) + 1}.0.conv1.weight" in sd:
            si, bi = len(counts) + 1, 0
            while f"visual.layer{si}.{bi}.conv1.weight" in sd:
                bi += 1
            counts.append(bi)
        spacial = int(round((_np(
            sd["visual.attnpool.positional_embedding"]).shape[0] - 1) ** 0.5))
        cfg = CLIPConfig(
            embed_dim=_np(sd["visual.attnpool.c_proj.weight"]).shape[0],
            image_resolution=spacial * 32, vision_layers=tuple(counts),
            vision_width=_np(sd["visual.layer1.0.conv1.weight"]).shape[1],
            vision_patch_size=32, **text_cfg)
    if config_overrides:
        cfg = dataclasses.replace(cfg, **config_overrides)
    text = {
        "token_embedding": _np(sd["token_embedding.weight"]),
        "positional_embedding": _np(sd["positional_embedding"]),
        "blocks": _clip_tower_np(sd, "transformer", cfg.transformer_layers),
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": _np(sd["text_projection"]),
    }
    if cfg.is_resnet:
        visual = clip_resnet.tree_np(sd)
    else:
        visual = {
            "conv1": patch_conv_to_matmul(sd["visual.conv1.weight"]),
            "class_embedding": _np(sd["visual.class_embedding"]),
            "positional_embedding": _np(sd["visual.positional_embedding"]),
            "ln_pre": _ln(sd, "visual.ln_pre"),
            "blocks": _clip_tower_np(sd, "visual.transformer",
                                     cfg.vision_layers),
            "ln_post": _ln(sd, "visual.ln_post"),
            "proj": _np(sd["visual.proj"]),
        }
    tree = {"visual": visual, "text": text,
            "logit_scale": _np(sd["logit_scale"])}
    return clip_from_jax_numpy(tree, cfg, device), cfg


# ---------------------------------------------------------------------------
# DETR (facebook detr-r50 release layout: torchvision ResNet under
# backbone.0.body.*, torch-MHA fused in_proj in the transformer)
# ---------------------------------------------------------------------------

def _tv_bn(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"weight": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"]),
            "mean": _np(sd[f"{prefix}.running_mean"]),
            "var": _np(sd[f"{prefix}.running_var"])}


def _resnet_np(sd: Mapping[str, Any], prefix: str, stages):
    """torchvision ResNet (frozen BN) → the JAX ``models/resnet`` tree with
    numpy leaves (HWIO convs)."""
    layers = []
    for si, n_blocks in enumerate(stages):
        blocks = []
        for bi in range(n_blocks):
            p = f"{prefix}layer{si + 1}.{bi}"
            blk = {
                "conv1": {"w": _conv_hwio(sd[f"{p}.conv1.weight"])},
                "bn1": _tv_bn(sd, f"{p}.bn1"),
                "conv2": {"w": _conv_hwio(sd[f"{p}.conv2.weight"])},
                "bn2": _tv_bn(sd, f"{p}.bn2"),
                "conv3": {"w": _conv_hwio(sd[f"{p}.conv3.weight"])},
                "bn3": _tv_bn(sd, f"{p}.bn3"),
            }
            if f"{p}.downsample.0.weight" in sd:
                blk["downsample"] = {
                    "w": _conv_hwio(sd[f"{p}.downsample.0.weight"])}
                blk["downsample_bn"] = _tv_bn(sd, f"{p}.downsample.1")
            blocks.append(blk)
        layers.append(blocks)
    return {"conv1": {"w": _conv_hwio(sd[f"{prefix}conv1.weight"])},
            "bn1": _tv_bn(sd, f"{prefix}bn1"), "layers": layers}


def resnet_from_state_dict(sd: Mapping[str, Any], prefix: str = "",
                           stages=(3, 4, 6, 3),
                           device="cuda") -> Dict[str, Any]:
    """torchvision ResNet (frozen BN) keys under ``prefix`` → the port's
    ``models/resnet`` tree on ``device``; ``stages``: blocks per stage."""
    return _to_torch(_resnet_np(sd, prefix, stages), device, hwio=True)


def _mha_from_in_proj(sd: Mapping[str, Any],
                      prefix: str) -> CrossAttentionParams:
    """torch MultiheadAttention's fused in_proj (rows q; k; v) →
    ``CrossAttentionParams`` with numpy leaves (the split the reference
    performs at load, DETR/modules/layers.py:711-726)."""
    w = _np(sd[f"{prefix}.in_proj_weight"])
    b = _np(sd[f"{prefix}.in_proj_bias"])
    D = w.shape[1]
    wo, bo = _lin(sd, f"{prefix}.out_proj")
    return CrossAttentionParams(
        w_q=w[:D].T, b_q=b[:D], w_k=w[D:2 * D].T, b_k=b[D:2 * D],
        w_v=w[2 * D:].T, b_v=b[2 * D:], w_out=wo, b_out=bo)


def detr_from_jax_numpy(tree: Mapping[str, Any], cfg,
                        device="cuda") -> Dict[str, Any]:
    """The JAX ``models/detr`` params pytree (numpy leaves, HWIO backbone
    convs, layers stacked on a leading axis) → the port's tree on
    ``device``. ``cfg`` (a ``models.detr.DETRConfig``) must have the
    tree's depths."""
    got = (len(tree["encoder"]["norm1"]["scale"]),
           len(tree["decoder"]["norm1"]["scale"]),
           tuple(len(b) for b in tree["backbone"]["layers"]))
    want = (cfg.num_encoder_layers, cfg.num_decoder_layers,
            tuple(cfg.backbone_stages))
    if got != want:
        raise ValueError(f"(encoder, decoder, backbone) depths {got} do not "
                         f"fit the config's {want}")
    return _to_torch(tree, device, hwio=True)


def detr_from_state_dict(sd: Mapping[str, Any], cfg,
                         device="cuda") -> Dict[str, Any]:
    """facebook/detr release checkpoint (``detr-r50-e632da11.pth``'s
    ``model``) → the port's ``models/detr`` tree on ``device``."""
    def ffn(p):
        w1, b1 = _lin(sd, f"{p}.linear1")
        w2, b2 = _lin(sd, f"{p}.linear2")
        return {"w1": w1, "b1": b1, "w2": w2, "b2": b2}

    enc = []
    for i in range(cfg.num_encoder_layers):
        p = f"transformer.encoder.layers.{i}"
        enc.append({
            "self_attn": _mha_from_in_proj(sd, f"{p}.self_attn"),
            "norm1": _ln(sd, f"{p}.norm1"), "norm2": _ln(sd, f"{p}.norm2"),
            "ffn": ffn(p),
        })
    dec = []
    for i in range(cfg.num_decoder_layers):
        p = f"transformer.decoder.layers.{i}"
        dec.append({
            "self_attn": _mha_from_in_proj(sd, f"{p}.self_attn"),
            "cross_attn": _mha_from_in_proj(sd, f"{p}.multihead_attn"),
            "norm1": _ln(sd, f"{p}.norm1"), "norm2": _ln(sd, f"{p}.norm2"),
            "norm3": _ln(sd, f"{p}.norm3"), "ffn": ffn(p),
        })
    cw, cb = _lin(sd, "class_embed")
    bbox = []
    for i in range(3):
        w, b = _lin(sd, f"bbox_embed.layers.{i}")
        bbox.append({"w": w, "b": b})
    ip_w = _np(sd["input_proj.weight"])[:, :, 0, 0]  # [D, C, 1, 1]
    tree = {
        "backbone": _resnet_np(sd, "backbone.0.body.", cfg.backbone_stages),
        "input_proj": {"w": ip_w.T, "b": _np(sd["input_proj.bias"])},
        "query_embed": _np(sd["query_embed.weight"]),
        "encoder": _stack(enc),
        "decoder": _stack(dec),
        "decoder_norm": _ln(sd, "transformer.decoder.norm"),
        "class_embed": {"w": cw, "b": cb},
        "bbox_embed": bbox,
    }
    return detr_from_jax_numpy(tree, cfg, device)


def detr_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``models/detr`` tree → the facebook release layout that
    ``detr_from_state_dict`` reads (``{"model": ...}`` of a ``.pth``), as
    contiguous CPU tensors: the inverse of that converter."""
    sd: Dict[str, torch.Tensor] = {}
    t = lambda x: x.detach().cpu().contiguous()

    def bn(prefix, p):
        for ours, theirs in (("weight", "weight"), ("bias", "bias"),
                             ("mean", "running_mean"), ("var", "running_var")):
            sd[f"{prefix}.{theirs}"] = t(p[ours])

    bb, pre = params["backbone"], "backbone.0.body."
    sd[f"{pre}conv1.weight"] = t(bb["conv1"]["w"])        # OIHW already
    bn(f"{pre}bn1", bb["bn1"])
    for si, blocks in enumerate(bb["layers"]):
        for bi, blk in enumerate(blocks):
            p = f"{pre}layer{si + 1}.{bi}"
            for c in ("1", "2", "3"):
                sd[f"{p}.conv{c}.weight"] = t(blk[f"conv{c}"]["w"])
                bn(f"{p}.bn{c}", blk[f"bn{c}"])
            if "downsample" in blk:
                sd[f"{p}.downsample.0.weight"] = t(blk["downsample"]["w"])
                bn(f"{p}.downsample.1", blk["downsample_bn"])
    sd["input_proj.weight"] = t(params["input_proj"]["w"].T[:, :, None, None])
    sd["input_proj.bias"] = t(params["input_proj"]["b"])
    sd["query_embed.weight"] = t(params["query_embed"])

    def mha(prefix, a, i):
        sd[f"{prefix}.in_proj_weight"] = t(torch.cat(
            [a.w_q[i].T, a.w_k[i].T, a.w_v[i].T]))
        sd[f"{prefix}.in_proj_bias"] = t(torch.cat(
            [a.b_q[i], a.b_k[i], a.b_v[i]]))
        sd[f"{prefix}.out_proj.weight"] = t(a.w_out[i].T)
        sd[f"{prefix}.out_proj.bias"] = t(a.b_out[i])

    def common(prefix, layers, i, norms):
        for n in ("1", "2"):
            sd[f"{prefix}.linear{n}.weight"] = t(layers["ffn"][f"w{n}"][i].T)
            sd[f"{prefix}.linear{n}.bias"] = t(layers["ffn"][f"b{n}"][i])
        for n in norms:
            sd[f"{prefix}.{n}.weight"] = t(layers[n]["scale"][i])
            sd[f"{prefix}.{n}.bias"] = t(layers[n]["bias"][i])

    enc, dec = params["encoder"], params["decoder"]
    for i in range(len(enc["norm1"]["scale"])):
        p = f"transformer.encoder.layers.{i}"
        mha(f"{p}.self_attn", enc["self_attn"], i)
        common(p, enc, i, ("norm1", "norm2"))
    for i in range(len(dec["norm1"]["scale"])):
        p = f"transformer.decoder.layers.{i}"
        mha(f"{p}.self_attn", dec["self_attn"], i)
        mha(f"{p}.multihead_attn", dec["cross_attn"], i)
        common(p, dec, i, ("norm1", "norm2", "norm3"))
    sd["transformer.decoder.norm.weight"] = t(params["decoder_norm"]["scale"])
    sd["transformer.decoder.norm.bias"] = t(params["decoder_norm"]["bias"])
    sd["class_embed.weight"] = t(params["class_embed"]["w"].T)
    sd["class_embed.bias"] = t(params["class_embed"]["b"])
    for i, lp in enumerate(params["bbox_embed"]):
        sd[f"bbox_embed.layers.{i}.weight"] = t(lp["w"].T)
        sd[f"bbox_embed.layers.{i}.bias"] = t(lp["b"])
    return sd
