"""MMF VisualBERT checkpoint loader.

Counterpart of ``transformer_mm_explainability_tpu/utils/mmf_loader.py``.
The MMF tarballs (``visual_bert.finetuned.vqa2.from_coco_train``) hold a
torch ``model.ckpt`` whose keys are prefixed ``model.bert...`` /
``model.classifier...``, with the visio-linguistic embedding extras
(``projection``, ``token_type_embeddings_visual``,
``position_embeddings_visual``) and the VQA head as ``classifier.0``
(dense + LayerNorm) and ``classifier.1`` (the answer Linear). The loader
builds the JAX package's tree layout in numpy and carries it onto the
port's ``models/visual_bert`` tree on a given device.
"""

from __future__ import annotations

import tarfile
from typing import Any, Dict, Mapping

import torch

from transformer_mm_explainability_tpu_torch.utils import convert


def _strip_prefixes(sd: Mapping[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in sd.items():
        for pre in ("model.", "module."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


def visual_bert_from_state_dict(sd: Mapping[str, Any], cfg,
                                device="cuda") -> Dict[str, Any]:
    """MMF visual_bert state dict → the port's ``models/visual_bert``
    params on ``device``."""
    sd = _strip_prefixes(sd)
    emb = "bert.embeddings"
    pw, pb = convert._lin(sd, f"{emb}.projection")
    pool_w, pool_b = convert._lin(sd, "bert.pooler.dense")
    tw, tb = convert._lin(sd, "classifier.0.dense")
    cw, cb = convert._lin(sd, "classifier.1")
    tree = {
        "embeddings": convert._bert_embeddings_np(sd, emb),
        "visual": {
            "projection": {"w": pw, "b": pb},
            "token_type": convert._np(
                sd[f"{emb}.token_type_embeddings_visual.weight"]),
            "position": convert._np(
                sd[f"{emb}.position_embeddings_visual.weight"]),
        },
        "encoder": convert._bert_encoder_np(
            sd, cfg.bert.num_hidden_layers, "bert.encoder.layer"),
        "pooler": {"w": pool_w, "b": pool_b},
        "head": {
            "transform": {"w": tw, "b": tb,
                          "ln": convert._ln(sd, "classifier.0.LayerNorm")},
            "classifier": {"w": cw, "b": cb},
        },
    }
    return convert.visual_bert_from_jax_numpy(tree, cfg, device)


def load_visual_bert(path: str, cfg=None, device="cuda"):
    """Load an MMF visual_bert checkpoint (.ckpt / .pth, or a tarball
    holding one) → ``(params on device, VisualBERTConfig)``."""
    from transformer_mm_explainability_tpu_torch.models.visual_bert import (
        VISUAL_BERT_VQA2)

    cfg = cfg or VISUAL_BERT_VQA2
    if path.endswith((".tar.gz", ".tgz", ".tar")):
        with tarfile.open(path) as tf:
            member = next(m for m in tf.getmembers()
                          if m.name.endswith((".ckpt", ".pth", ".pt")))
            sd = torch.load(tf.extractfile(member), map_location="cpu")
    else:
        sd = torch.load(path, map_location="cpu")
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return visual_bert_from_state_dict(sd, cfg, device), cfg
