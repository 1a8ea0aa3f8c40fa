"""Parity against the original PyTorch reference's own maps
(``cli verify-parity``), on the PyTorch port.

Counterpart of ``transformer_mm_explainability_tpu/tools/verify_parity.py``,
with the same modes and names:

  * ``verify-parity --family clip``             (fixture mode)
      Regenerates the deterministic manifest-shaped random state dict
      stored in ``data/assets/parity/<family>.npz`` (its manifest, seed and
      scale; a seeded ``torch.Generator``), converts it with the port's
      published-checkpoint converters, runs the family's golden inputs
      through the port's generators and compares with the maps the
      reference computed in its own process. Needs no reference checkout.

  * ``verify-parity --family clip --generate``  (fixture generation)
      Also runs the REFERENCE generator in-process from ``--reference``
      with the same weights and writes the fixture.

  * ``verify-parity --family clip --weights model.pt``
      Converts a real checkpoint, runs the golden inputs through the port
      and, when ``--reference`` is a checkout, through the reference, and
      reports max|Δ|; without one it prints digests.

The tool's rule (``_map_delta``) is the JAX tool's: max|Δ| over
max(1, max|ref|) below ``TOL``, and strictly absolute for ``scores``. For
a map whose max|ref| is below ``TOL`` that rule says nothing (an all-zero
map passes it), so every line also gives max|ref|, the relative distance
max|Δ| / max|ref| and the word ``uninformative`` there. ``report["ok"]``
and the exit code keep the JAX rule; callers that gate on the relative
distance read it from the report (``REL_TOL`` is the bar the port's tests
and smoke run hold it to).

Model scales are the published-checkpoint manifests (ViT-B/16, CLIP
ViT-B/32, 12-layer VisualBERT, 9/5/5 LXMERT, the DETR-R50 transformer).
The ``_<family>_reference`` functions are the JAX tool's, unchanged: torch
code that loads the reference's modules from ``--reference``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from transformer_mm_explainability_tpu_torch._device import (
    params_to,
    resolve_device,
)

FAMILIES = ("vit", "clip", "visual_bert", "lxmert", "detr")
TOL = 1e-4
REL_TOL = 1e-3
FIXTURE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data", "assets", "parity")
DEFAULT_REFERENCE = "reference"


def _map_delta(our, ref, name=""):
    """(max|Δ|, scaled max|Δ|, ok): the JAX tool's rule. Un-normalised
    maps like VisualBERT's rollout grow to O(2^L), where fp32 round-off
    alone exceeds an absolute 1e-4, so the distance is scaled by
    max(1, max|ref|): absolute for O(1) maps, relative beyond. ``scores``
    (model logits) stay strictly absolute."""
    our = np.asarray(our)
    ref = np.asarray(ref)
    d = float(np.abs(our - ref).max())
    if name == "scores":
        return d, d, d < TOL
    scaled = d / max(1.0, float(np.abs(ref).max()))
    return d, scaled, scaled < TOL


def map_report(our, ref, name="") -> Dict:
    """``_map_delta`` plus what it hides: ``max_ref``, the relative
    distance ``rel`` = max|Δ| / max|ref| (0 where both are 0, inf where
    only the reference is) and ``uninformative`` (max|ref| < TOL)."""
    d, scaled, good = _map_delta(our, ref, name)
    top = float(np.abs(np.asarray(ref)).max())
    rel = d / top if top > 0 else (0.0 if d == 0 else float("inf"))
    return {"max_abs": d, "scaled": scaled, "ok": bool(good),
            "max_ref": top, "rel": rel, "uninformative": top < TOL}


def _line(family: str, name: str, r: Dict, against: str) -> str:
    return (f"[{family}] {name}: max|Δ| vs {against} = {r['max_abs']:.2e} "
            f"(scaled {r['scaled']:.2e})  [{'OK' if r['ok'] else 'FAIL'}]  "
            f"max|ref| {r['max_ref']:.2e}, max|Δ|/max|ref| {r['rel']:.2e}"
            + ("  uninformative (max|ref| < TOL)" if r["uninformative"]
               else ""))


# ---------------------------------------------------------------------------
# deterministic manifest-shaped random weights
# ---------------------------------------------------------------------------

def random_state_dict(manifest: Dict[str, Tuple[int, ...]], seed: int = 0,
                      scale: float = 0.02):
    """{key: shape} → {key: CPU tensor}, deterministic in (seed, key
    order). Key order is the manifest's insertion order, stored in the
    fixture so that regeneration is exact."""
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(tuple(shape), generator=g) * scale
            for k, shape in manifest.items()}


def _manifest_json(manifest) -> str:
    return json.dumps([[k, list(map(int, v))] for k, v in manifest.items()])


def _manifest_from_json(s: str) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(v) for k, v in json.loads(s)}


def _on(x, device, dtype=None):
    """A numpy input on ``device``; floating arrays in ``dtype``."""
    t = torch.as_tensor(np.asarray(x), device=device)
    if t.is_floating_point() and dtype is not None:
        t = t.to(dtype)
    return t


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# per family: manifest, golden inputs, the port's pipeline, the reference's
# ---------------------------------------------------------------------------
# Each family provides:
#   manifest(reference) -> {key: shape}        (full published-model scale)
#   ours(state_dict, device, dtype) -> {name: np map}
#   reference(state_dict, reference_path) -> {name: np map}


def _vit_manifest(_reference=None):
    """timm vit_base_patch16_224 state-dict naming."""
    D, F, L = 768, 3072, 12
    m = {
        "cls_token": (1, 1, D),
        "pos_embed": (1, 197, D),
        "patch_embed.proj.weight": (D, 3, 16, 16),
        "patch_embed.proj.bias": (D,),
    }
    for i in range(L):
        p = f"blocks.{i}."
        m[p + "norm1.weight"] = (D,)
        m[p + "norm1.bias"] = (D,)
        m[p + "attn.qkv.weight"] = (3 * D, D)
        m[p + "attn.qkv.bias"] = (3 * D,)
        m[p + "attn.proj.weight"] = (D, D)
        m[p + "attn.proj.bias"] = (D,)
        m[p + "norm2.weight"] = (D,)
        m[p + "norm2.bias"] = (D,)
        m[p + "mlp.fc1.weight"] = (F, D)
        m[p + "mlp.fc1.bias"] = (F,)
        m[p + "mlp.fc2.weight"] = (D, F)
        m[p + "mlp.fc2.bias"] = (D,)
    m["norm.weight"] = (D,)
    m["norm.bias"] = (D,)
    m["head.weight"] = (1000, D)
    m["head.bias"] = (1000,)
    return m


def _vit_inputs():
    rng = np.random.RandomState(100)
    return rng.randn(1, 224, 224, 3).astype(np.float32), np.asarray([285])


def vit_model(sd, device="cuda", dtype=torch.float32):
    """The converted ViT of ``sd`` on ``device`` in ``dtype`` and the golden
    inputs there: ``(model, images, targets)``."""
    from transformer_mm_explainability_tpu_torch.utils import convert

    model, _ = convert.vit_from_state_dict(sd, device)
    images, targets = _vit_inputs()
    return (model.to(dtype), _on(images, device, dtype),
            _on(targets, device).long())


def _vit_ours(sd, device="cuda", dtype=torch.float32):
    from transformer_mm_explainability_tpu_torch.models import vit

    model, images, targets = vit_model(sd, device, dtype)
    return {"relevancy": _host(vit.relevancy(model, images, targets))}


def _vit_reference(sd, _reference):
    """Hook-based torch ViT twin (the sibling-repo ViT_new architecture:
    timm ViT-B/16, pre-LN, per-block attention capture via
    register_hook — generate_relevance, ViT notebook cell 7)."""
    t = {k: v.detach().clone() for k, v in sd.items()}
    D, H, L = 768, 12, 12
    x = torch.tensor(_vit_inputs()[0]).permute(0, 3, 1, 2)
    target = int(_vit_inputs()[1][0])

    patches = torch.nn.functional.conv2d(
        x, t["patch_embed.proj.weight"], t["patch_embed.proj.bias"],
        stride=16)
    tokens = patches.flatten(2).transpose(1, 2)           # [1, 196, D]
    tokens = torch.cat([t["cls_token"], tokens], dim=1) + t["pos_embed"]
    tokens.requires_grad_(True)

    def ln(v, w, b):
        return torch.nn.functional.layer_norm(v, (D,), w, b, eps=1e-6)

    attns = []
    h = tokens
    for i in range(L):
        p = f"blocks.{i}."
        y = ln(h, t[p + "norm1.weight"], t[p + "norm1.bias"])
        qkv = y @ t[p + "attn.qkv.weight"].T + t[p + "attn.qkv.bias"]
        q, k, v = qkv.chunk(3, dim=-1)
        sh = lambda z: z.view(1, -1, H, D // H).transpose(1, 2)
        a = (sh(q) @ sh(k).transpose(-2, -1)) / (D // H) ** 0.5
        a = a.softmax(-1)
        a.retain_grad()
        attns.append(a)
        o = (a @ sh(v)).transpose(1, 2).reshape(1, -1, D)
        h = h + o @ t[p + "attn.proj.weight"].T + t[p + "attn.proj.bias"]
        y = ln(h, t[p + "norm2.weight"], t[p + "norm2.bias"])
        y = torch.nn.functional.gelu(
            y @ t[p + "mlp.fc1.weight"].T + t[p + "mlp.fc1.bias"])
        h = h + y @ t[p + "mlp.fc2.weight"].T + t[p + "mlp.fc2.bias"]
    h = ln(h, t["norm.weight"], t["norm.bias"])
    logits = h[:, 0] @ t["head.weight"].T + t["head.bias"]
    logits[0, target].backward()

    R = torch.eye(197)
    for a in attns:
        e = (a.grad[0] * a[0]).clamp(min=0).mean(0)
        R = R + e @ R
    return {"relevancy": R[0, 1:].detach().numpy()[None]}


def _clip_manifest(_reference=None):
    """CLIP ViT-B/32 state-dict shapes (model.py build_model sniffing
    works off exactly these keys)."""
    ref = _load_ref_clip(_reference) if _reference else None
    if ref is not None:
        torch.manual_seed(0)
        model = ref.CLIP(512, 224, 12, 768, 32, 77, 49408, 512, 8, 12)
        return {k: tuple(v.shape) for k, v in model.state_dict().items()}
    raise RuntimeError("CLIP manifest needs the reference checkout once "
                       "(stored in the fixture afterwards)")


def _clip_inputs():
    rng = np.random.RandomState(101)
    image = rng.randn(224, 224, 3).astype(np.float32)
    texts = rng.randint(1000, 40000, size=(3, 77))
    texts[:, 0] = 49406          # SOT
    lengths = [7, 12, 20]
    for i, n in enumerate(lengths):
        texts[i, n - 1] = 49407  # EOT
        texts[i, n:] = 0
    return image, texts.astype(np.int32)


def _clip_ours(sd, device="cuda", dtype=torch.float32):
    from transformer_mm_explainability_tpu_torch.explain import clip as eclip
    from transformer_mm_explainability_tpu_torch.utils import convert

    params, cfg = convert.clip_from_state_dict(sd, device)
    params = params_to(params, dtype)
    image, texts = _clip_inputs()
    R_text, R_image, _ = eclip.interpret(params, _on(image, device, dtype),
                                         _on(texts, device).long(), cfg)
    return {"image_relevance": _host(R_image),
            "text_relevance": _host(R_text)}


def _load_ref_clip(reference):
    import importlib.util
    import types

    base = os.path.join(reference, "CLIP", "clip")
    pkg = types.ModuleType("refclip")
    pkg.__path__ = [base]
    sys.modules.setdefault("refclip", pkg)
    for name in ("auxilary", "model"):
        spec = importlib.util.spec_from_file_location(
            f"refclip.{name}", os.path.join(base, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[f"refclip.{name}"] = mod
        spec.loader.exec_module(mod)
    return sys.modules["refclip.model"]


def _clip_reference(sd, reference):
    """The notebook's interpret() over the reference CLIP
    (CLIP_explainability.ipynb cell 5-6 / CLIP/example.py:8-48):
    last-layer-only image chain, per-block autograd.grad."""
    ref = _load_ref_clip(reference)
    torch.manual_seed(0)
    model = ref.CLIP(512, 224, 12, 768, 32, 77, 49408, 512, 8, 12)
    model.load_state_dict({k: v for k, v in sd.items()}, strict=True)
    model = model.eval().float()
    image, texts = _clip_inputs()
    img = torch.tensor(image).permute(2, 0, 1)[None].repeat(3, 1, 1, 1)
    txt = torch.tensor(np.asarray(texts, np.int64))

    logits_per_image, _ = model(img, txt)
    batch = logits_per_image.shape[0]
    one_hot = logits_per_image.diagonal().sum()
    model.zero_grad()

    image_blocks = model.visual.transformer.resblocks
    text_blocks = model.transformer.resblocks

    one_hot.backward(retain_graph=True)
    S = image_blocks[0].attn_probs.shape[-1]
    R = torch.eye(S)[None].repeat(batch, 1, 1)
    for blk in image_blocks[-1:]:                  # start_layer = -1
        grad = blk.attn_grad.view(batch, -1, S, S)
        cam = blk.attn_probs.view(batch, -1, S, S)
        e = (grad * cam).clamp(min=0).mean(1)
        R = R + torch.bmm(e, R)
    image_rel = R[:, 0, 1:]

    St = text_blocks[0].attn_probs.shape[-1]
    Rt = torch.eye(St)[None].repeat(batch, 1, 1)
    for blk in text_blocks[-1:]:
        grad = blk.attn_grad.view(batch, -1, St, St)
        cam = blk.attn_probs.view(batch, -1, St, St)
        e = (grad * cam).clamp(min=0).mean(1)
        Rt = Rt + torch.bmm(e, Rt)
    return {"image_relevance": image_rel.detach().numpy(),
            "text_relevance": Rt.detach().numpy()}


def _visual_bert_manifest(_reference=None):
    """The MMF visual_bert tarball naming at BERT-base scale."""
    L, D, I, vocab, vdim = 12, 768, 3072, 30522, 2048
    m = {
        "model.bert.embeddings.word_embeddings.weight": (vocab, D),
        "model.bert.embeddings.position_embeddings.weight": (512, D),
        "model.bert.embeddings.token_type_embeddings.weight": (2, D),
        "model.bert.embeddings.LayerNorm.weight": (D,),
        "model.bert.embeddings.LayerNorm.bias": (D,),
        "model.bert.embeddings.projection.weight": (D, vdim),
        "model.bert.embeddings.projection.bias": (D,),
        "model.bert.embeddings.token_type_embeddings_visual.weight": (2, D),
        "model.bert.embeddings.position_embeddings_visual.weight": (512, D),
    }
    for i in range(L):
        p = f"model.bert.encoder.layer.{i}."
        for qkv in ("query", "key", "value"):
            m[p + f"attention.self.{qkv}.weight"] = (D, D)
            m[p + f"attention.self.{qkv}.bias"] = (D,)
        m[p + "attention.output.dense.weight"] = (D, D)
        m[p + "attention.output.dense.bias"] = (D,)
        m[p + "attention.output.LayerNorm.weight"] = (D,)
        m[p + "attention.output.LayerNorm.bias"] = (D,)
        m[p + "intermediate.dense.weight"] = (I, D)
        m[p + "intermediate.dense.bias"] = (I,)
        m[p + "output.dense.weight"] = (D, I)
        m[p + "output.dense.bias"] = (D,)
        m[p + "output.LayerNorm.weight"] = (D,)
        m[p + "output.LayerNorm.bias"] = (D,)
    m["model.bert.pooler.dense.weight"] = (D, D)
    m["model.bert.pooler.dense.bias"] = (D,)
    # classifier = Sequential(BertPredictionHeadTransform, Linear)
    # (visual_bert.py:323-326)
    m["model.classifier.0.dense.weight"] = (D, D)
    m["model.classifier.0.dense.bias"] = (D,)
    m["model.classifier.0.LayerNorm.weight"] = (D,)
    m["model.classifier.0.LayerNorm.bias"] = (D,)
    m["model.classifier.1.weight"] = (3129, D)
    m["model.classifier.1.bias"] = (3129,)
    return m


def _visual_bert_inputs(seed: int = 102):
    rng = np.random.RandomState(seed)
    text_len = 20
    ids = np.zeros((1, 128), np.int32)
    ids[0, :text_len] = rng.randint(1, 30000, text_len)
    mask = (np.arange(128)[None] < text_len).astype(np.int32)
    feats = rng.randn(1, 100, 2048).astype(np.float32)
    return ids, mask, feats


def _visual_bert_ours(sd, device="cuda", dtype=torch.float32, inputs=None):
    """``inputs``: ``(ids, mask, feats)`` with a batch axis (the golden
    example by default); every map keeps that axis."""
    from transformer_mm_explainability_tpu_torch.explain import (
        visual_bert as evb)
    from transformer_mm_explainability_tpu_torch.models import (
        visual_bert as vb)
    from transformer_mm_explainability_tpu_torch.utils import mmf_loader

    cfg = vb.VISUAL_BERT_VQA2
    params = params_to(mmf_loader.visual_bert_from_state_dict(sd, cfg,
                                                              device), dtype)
    ids, mask, feats = inputs or _visual_bert_inputs()
    batch = {"input_ids": _on(ids, device).long(),
             "input_mask": _on(mask, device),
             "visual_embeddings": _on(feats, device, dtype)}
    scores, attn, grads, tape = vb.capture(params, batch, None, cfg,
                                           return_tape=True)
    cls_index = vb.cls_index(batch["input_mask"])
    # the LRP cams of the predicted answers (harness/pert_runner's
    # extraction for the relprop-based baselines)
    one_hot = torch.nn.functional.one_hot(scores.argmax(-1), cfg.num_labels)
    with torch.no_grad():
        _, cams = vb.relprop(params, tape, one_hot, cfg)
    maps = {
        "cls_per_token_score": evb.generate_ours(attn, grads, cls_index),
        "transformer_att": evb.generate_transformer_att(cams, grads,
                                                        cls_index),
        "partial_lrp": evb.generate_partial_lrp(cams, cls_index),
        "raw_attn": evb.generate_raw_attn(attn, cls_index),
        "rollout": evb.generate_rollout(attn, cls_index),
        "attn_gradcam": evb.generate_attn_gradcam(attn, grads, cls_index),
        "scores": scores,
    }
    return {k: _host(v) for k, v in maps.items()}


def _visual_bert_reference(sd, reference):
    """The mmf pipeline re-assembled from the reference's own modules:
    BERT_ours.BertModel (visual_bert.py VisualBERTBase semantics:
    text+visual embeddings → instrumented encoder → '?' pooling at
    input_mask.sum-2) + SelfAttentionGenerator.generate_ours
    (backends/ExplanationGenerator.py:68-107)."""
    import importlib.util
    import types

    base = os.path.join(reference,
                        "VisualBERT/mmf/models/transformers/backends")
    pkg = types.ModuleType("ref_vb_backends")
    pkg.__path__ = [base]
    sys.modules.setdefault("ref_vb_backends", pkg)
    for name in ("layers_ours", "BERT_ours"):
        spec = importlib.util.spec_from_file_location(
            f"ref_vb_backends.{name}", os.path.join(base, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[f"ref_vb_backends.{name}"] = mod
        spec.loader.exec_module(mod)
    BERT_ours = sys.modules["ref_vb_backends.BERT_ours"]

    class Cfg:
        vocab_size = 30522
        hidden_size = 768
        num_hidden_layers = 12
        num_attention_heads = 12
        intermediate_size = 3072
        hidden_act = "gelu"
        hidden_dropout_prob = 0.0
        attention_probs_dropout_prob = 0.0
        max_position_embeddings = 512
        type_vocab_size = 2
        initializer_range = 0.02
        layer_norm_eps = 1e-12
        pad_token_id = 0
        output_attentions = False
        output_hidden_states = False
        is_decoder = False
        add_cross_attention = False
        chunk_size_feed_forward = 0

    enc = BERT_ours.BertEncoder(Cfg())
    emb_sd = {k[len("model.bert.encoder."):]: v for k, v in sd.items()
              if k.startswith("model.bert.encoder.")}
    enc.load_state_dict(emb_sd, strict=True)
    enc = enc.eval()

    ids, mask, feats = _visual_bert_inputs()
    t = lambda x: torch.tensor(np.asarray(x))
    w = sd["model.bert.embeddings.word_embeddings.weight"]
    pos = sd["model.bert.embeddings.position_embeddings.weight"]
    tok = sd["model.bert.embeddings.token_type_embeddings.weight"]
    ln_w = sd["model.bert.embeddings.LayerNorm.weight"]
    ln_b = sd["model.bert.embeddings.LayerNorm.bias"]
    proj_w = sd["model.bert.embeddings.projection.weight"]
    proj_b = sd["model.bert.embeddings.projection.bias"]
    tok_v = sd["model.bert.embeddings.token_type_embeddings_visual.weight"]
    pos_v = sd["model.bert.embeddings.position_embeddings_visual.weight"]

    St = ids.shape[1]
    Nv = feats.shape[1]
    text_emb = (w[t(ids).long()] + pos[:St][None] + tok[0][None, None])
    vis_proj = t(feats) @ proj_w.T + proj_b
    # visual position embeddings: mmf visual_bert sums the FIRST
    # visual position row (no image_text_alignment), embeddings.py
    vis_emb = vis_proj + tok_v[1][None, None] + pos_v[:Nv][None]
    emb = torch.cat([text_emb, vis_emb], dim=1)
    emb = torch.nn.functional.layer_norm(emb, (768,), ln_w, ln_b,
                                         eps=1e-12)

    full_mask = torch.cat(
        [t(mask).float(), torch.ones(1, Nv)], dim=1)
    ext = (1.0 - full_mask[:, None, None, :]) * -10000.0
    out = enc(emb, attention_mask=ext)
    seq = out[0] if isinstance(out, (tuple, list)) else out.last_hidden_state

    cls_index = int(mask.sum()) - 2
    # head assembled from the reference's OWN relprop-instrumented
    # modules (visual_bert.py:323-326 classifier = Sequential(
    # BertPredictionHeadTransform, Linear); :393 vqa_pooler=IndexSelect)
    # so the relprop chain (:398-406) runs verbatim
    lo = sys.modules["ref_vb_backends.layers_ours"]
    pooler = lo.IndexSelect()
    transform = BERT_ours.BertPredictionHeadTransform(Cfg())
    final = lo.Linear(768, 3129)
    with torch.no_grad():
        transform.dense.weight.copy_(sd["model.classifier.0.dense.weight"])
        transform.dense.bias.copy_(sd["model.classifier.0.dense.bias"])
        transform.LayerNorm.weight.copy_(
            sd["model.classifier.0.LayerNorm.weight"])
        transform.LayerNorm.bias.copy_(sd["model.classifier.0.LayerNorm.bias"])
        final.weight.copy_(sd["model.classifier.1.weight"])
        final.bias.copy_(sd["model.classifier.1.bias"])
    pooled = pooler(seq, 1, torch.tensor([cls_index]))   # [1, 1, D]
    scores = final(transform(pooled)).view(-1, 3129)

    one_hot = torch.zeros_like(scores)
    one_hot[0, scores.argmax()] = 1
    (one_hot * scores).sum().backward(retain_graph=True)

    def taps(layer):
        cam = layer.attention.self.get_attn()[0]
        grad = layer.attention.self.get_attn_gradients()[0]
        return cam, grad

    def cls_row(M):
        row = M[cls_index].clone()
        row[cls_index] = 0
        return row.detach().numpy()[None]

    S = St + Nv
    eye = torch.eye(S)

    # SelfAttentionGenerator.generate_ours (:68-107)
    R = torch.eye(S)
    for layer in enc.layer:
        cam, grad = taps(layer)
        e = (grad * cam).clamp(min=0).mean(0)
        R = R + e @ R

    # generate_raw_attn (:155-166): last layer head-mean
    raw = enc.layer[-1].attention.self.get_attn()[0].mean(0)

    # generate_rollout (:168-184): VB's compute_rollout_attention has
    # the row normalisation COMMENTED OUT (ExplanationGenerator.py:11-13)
    # — identity-add + plain bmm chain, start_layer=0
    roll = enc.layer[0].attention.self.get_attn()[0].mean(0) + eye
    for layer in enc.layer[1:]:
        roll = (layer.attention.self.get_attn()[0].mean(0) + eye) @ roll

    # generate_attn_gradcam (:186-214): per-head scalar grad weight,
    # clamp, head-mean, min-max
    cam_g, grad_g = taps(enc.layer[-1])
    gc = (cam_g * grad_g.mean(dim=[1, 2], keepdim=True)).mean(0).clamp(min=0)
    gc = (gc - gc.min()) / (gc.max() - gc.min())

    # relprop for the LRP-based baselines: classifier (reversed) →
    # vqa_pooler → bert encoder (visual_bert.py:398-406, alpha=1)
    kwargs = {"alpha": 1}
    cam_r = final.relprop(one_hot, **kwargs)
    cam_r = transform.relprop(cam_r, **kwargs)
    cam_r = pooler.relprop(cam_r, **kwargs)
    enc.relprop(cam_r, **kwargs)

    # generate_transformer_att (:24-66): rollout (identity-add, no row
    # norm) over clamp(grad ⊙ attn_cam)+ head-means, start_layer=0
    ta = None
    for layer in enc.layer:
        grad = layer.attention.self.get_attn_gradients()[0]
        camL = layer.attention.self.get_attn_cam()[0]
        e = (grad * camL).clamp(min=0).mean(0) + eye
        ta = e if ta is None else e @ ta

    # generate_partial_lrp (:109-131): last-layer attn_cam head-mean
    # (NO clamp), min-max normalised
    pl = enc.layer[-1].attention.self.get_attn_cam()[0].mean(0)
    pl = (pl - pl.min()) / (pl.max() - pl.min())

    return {"cls_per_token_score": cls_row(R),
            "transformer_att": cls_row(ta),
            "partial_lrp": cls_row(pl),
            "raw_attn": cls_row(raw),
            "rollout": cls_row(roll),
            "attn_gradcam": cls_row(gc),
            "scores": scores.detach().numpy()}


def _lxmert_manifest(_reference=None):
    from transformers.models.lxmert.configuration_lxmert import (
        LxmertConfig)
    from transformers.models.lxmert.modeling_lxmert import (
        LxmertForQuestionAnswering)

    cfg = LxmertConfig(num_qa_labels=3129)
    torch.manual_seed(0)
    model = LxmertForQuestionAnswering(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _lxmert_inputs(seed: int = 103):
    # UNPADDED text, like the reference protocol: perturbation.py
    # tokenizes one question with no fixed-length padding, so every
    # text row carries gradient. Padded rows would make Ê rows exactly
    # zero and the reference's handle_residual normalisation 0/0-NaN
    # on random weights (ExplanationGenerator.py:49-53).
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 30000, (1, 20)).astype(np.int32)
    mask = np.ones((1, 20), np.int32)
    feats = rng.randn(1, 36, 2048).astype(np.float32)
    pos = rng.rand(1, 36, 4).astype(np.float32)
    return ids, mask, feats, pos


def _lxmert_ours(sd, device="cuda", dtype=torch.float32, inputs=None):
    """``inputs``: ``(ids, mask, feats, pos)`` with a batch axis (the
    golden example by default); every map keeps that axis."""
    from transformer_mm_explainability_tpu_torch.explain import lxmert as elx
    from transformer_mm_explainability_tpu_torch.models import lxmert as lx
    from transformer_mm_explainability_tpu_torch.models import lxmert_lrp
    from transformer_mm_explainability_tpu_torch.utils import convert

    cfg = lx.LXMERT_VQA
    params = params_to(convert.lxmert_from_state_dict(sd, cfg, device),
                       dtype)
    ids, mask, feats, pos = inputs or _lxmert_inputs()
    batch = {"input_ids": _on(ids, device).long(),
             "attention_mask": _on(mask, device),
             "visual_feats": _on(feats, device, dtype),
             "visual_pos": _on(pos, device, dtype)}
    scores, attn, grads, tape = lx.capture(params, batch, None, cfg,
                                           return_tape=True)
    tt, ti = elx.generate_ours(attn, grads,
                               text_valid=batch["attention_mask"])
    # relprop cams for the LRP-based baselines (harness/pert_runner's
    # extraction)
    one_hot = torch.nn.functional.one_hot(scores.argmax(-1),
                                          cfg.num_qa_labels)
    with torch.no_grad():
        _, _, cams = lxmert_lrp.relprop(params, tape, one_hot,
                                        tape["lang_mask"],
                                        tape["visn_mask"], cfg)
    pairs = {
        "": (tt, ti),
        "transformer_att": elx.generate_transformer_att(cams, grads),
        "partial_lrp": elx.generate_partial_lrp(cams),
        "raw_attn": elx.generate_raw_attn(attn),
        "rollout": elx.generate_rollout(attn),
        "attn_gradcam": elx.generate_attn_gradcam(attn, grads),
    }
    maps = {"scores": _host(scores)}
    for name, (a, b) in pairs.items():
        p = name + "_" if name else ""
        maps[f"{p}R_t_t"] = _host(a)
        maps[f"{p}R_t_i"] = _host(b)
    return maps


def _load_ref_lxmert(reference):
    import importlib
    import importlib.machinery
    import types

    import transformers
    import transformers.file_utils as fu

    if "transformers.configuration_lxmert" not in sys.modules:
        shim = types.ModuleType("transformers.configuration_lxmert")
        shim.LxmertConfig = (
            transformers.models.lxmert.configuration_lxmert.LxmertConfig)
        shim.__spec__ = importlib.machinery.ModuleSpec(
            "transformers.configuration_lxmert", loader=None)
        sys.modules["transformers.configuration_lxmert"] = shim

    def _noop(*a, **k):
        def wrap(fn):
            return fn
        return wrap

    fu.add_code_sample_docstrings = _noop
    fu.add_start_docstrings = _noop
    fu.add_start_docstrings_to_model_forward = _noop
    fu.replace_return_docstrings = _noop
    if reference not in sys.path:
        sys.path.insert(0, reference)
    return importlib.import_module("lxmert.lxmert.src.lxmert_lrp")


def _lxmert_reference(sd, reference):
    """The reference's OWN GeneratorOurs.generate_ours (use_lrp=False)
    over its instrumented lxmert_lrp.LxmertForQuestionAnswering
    (lxmert ExplanationGenerator.py:131-213), driven through a minimal
    model_usage adapter (perturbation.py ModelPert's interface)."""
    import importlib

    from transformers.models.lxmert.configuration_lxmert import (
        LxmertConfig)

    mod = _load_ref_lxmert(reference)
    gen_mod = importlib.import_module(
        "lxmert.lxmert.src.ExplanationGenerator")
    cfg = LxmertConfig(num_qa_labels=3129, hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    model = mod.LxmertForQuestionAnswering(cfg)
    model.load_state_dict(sd, strict=False)
    model = model.eval()  # .device is the parameters' (cpu) already

    ids, mask, feats, pos = _lxmert_inputs()
    St, Sv = ids.shape[1], feats.shape[1]

    class Usage:
        text_len = St
        image_boxes_len = Sv

        @staticmethod
        def forward(item):
            return model(
                input_ids=torch.tensor(np.asarray(ids, np.int64)),
                visual_feats=torch.tensor(feats),
                visual_pos=torch.tensor(pos),
                attention_mask=torch.tensor(np.asarray(mask, np.int64)))

    Usage.model = model
    if not torch.cuda.is_available():
        torch.Tensor.cuda = lambda self, *a, **k: self  # type: ignore
    gen = gen_mod.GeneratorOurs(Usage)
    # no torch.no_grad(): the instrumented layers register grad hooks
    # on attention_probs inside forward (lxmert_lrp.py save_attn_
    # gradients), which requires grad-enabled tensors
    scores = Usage.forward(None).question_answering_score.detach()
    R_t_t, R_t_i = gen.generate_ours(None, index=None, use_lrp=False)
    maps = {"R_t_t": R_t_t, "R_t_i": R_t_i}
    # the reference's OWN GeneratorBaselines surface
    # (ExplanationGenerator.py:368-667) — each method re-runs forward
    # (and relprop where LRP-based) through the same Usage adapter
    base = gen_mod.GeneratorBaselines(Usage)
    maps["transformer_att_R_t_t"], maps["transformer_att_R_t_i"] = (
        base.generate_transformer_attr(None, index=None))
    maps["partial_lrp_R_t_t"], maps["partial_lrp_R_t_i"] = (
        base.generate_partial_lrp(None, index=None))
    maps["raw_attn_R_t_t"], maps["raw_attn_R_t_i"] = (
        base.generate_raw_attn(None))
    maps["attn_gradcam_R_t_t"], maps["attn_gradcam_R_t_i"] = (
        base.generate_attn_gradcam(None, index=None))
    maps["rollout_R_t_t"], maps["rollout_R_t_i"] = (
        base.generate_rollout(None))
    out = {k: v.detach().numpy()[None] for k, v in maps.items()}
    out["scores"] = scores.detach().numpy()
    return out


def _detr_manifest(_reference=None):
    """The published detr-r50 checkpoint schema: fused-in_proj torch
    MultiheadAttention (the reference's instrumented copy splits q/k/v
    only at state-dict load, DETR/modules/layers.py:711-726) + frozen-BN
    R50 backbone + heads. The parity run drives the relprop-instrumented
    transformer core (golden src/pos); the backbone is converted but has
    its own parity tests."""
    D, F = 256, 2048
    m = {}

    def mha(p):
        m[f"{p}.in_proj_weight"] = (3 * D, D)
        m[f"{p}.in_proj_bias"] = (3 * D,)
        m[f"{p}.out_proj.weight"] = (D, D)
        m[f"{p}.out_proj.bias"] = (D,)

    def lnorm(p):
        m[f"{p}.weight"] = (D,)
        m[f"{p}.bias"] = (D,)

    for i in range(6):
        p = f"transformer.encoder.layers.{i}"
        mha(f"{p}.self_attn")
        m[f"{p}.linear1.weight"] = (F, D)
        m[f"{p}.linear1.bias"] = (F,)
        m[f"{p}.linear2.weight"] = (D, F)
        m[f"{p}.linear2.bias"] = (D,)
        lnorm(f"{p}.norm1")
        lnorm(f"{p}.norm2")
    for i in range(6):
        p = f"transformer.decoder.layers.{i}"
        mha(f"{p}.self_attn")
        mha(f"{p}.multihead_attn")
        m[f"{p}.linear1.weight"] = (F, D)
        m[f"{p}.linear1.bias"] = (F,)
        m[f"{p}.linear2.weight"] = (D, F)
        m[f"{p}.linear2.bias"] = (D,)
        lnorm(f"{p}.norm1")
        lnorm(f"{p}.norm2")
        lnorm(f"{p}.norm3")
    lnorm("transformer.decoder.norm")
    m["query_embed.weight"] = (100, D)
    m["class_embed.weight"] = (92, D)
    m["class_embed.bias"] = (92,)
    m["input_proj.weight"] = (D, 2048, 1, 1)
    m["input_proj.bias"] = (D,)
    # frozen-BN R50 backbone (torchvision naming under backbone.0.body.)
    m["backbone.0.body.conv1.weight"] = (64, 3, 7, 7)
    for s in ("weight", "bias", "running_mean", "running_var"):
        m[f"backbone.0.body.bn1.{s}"] = (64,)
    in_ch = 64
    for si, n in enumerate((3, 4, 6, 3)):
        mid = 64 * 2 ** si
        out = mid * 4
        for bi in range(n):
            p = f"backbone.0.body.layer{si + 1}.{bi}"
            m[f"{p}.conv1.weight"] = (mid, in_ch, 1, 1)
            m[f"{p}.conv2.weight"] = (mid, mid, 3, 3)
            m[f"{p}.conv3.weight"] = (out, mid, 1, 1)
            for ci, ch in (("1", mid), ("2", mid), ("3", out)):
                for s in ("weight", "bias", "running_mean",
                          "running_var"):
                    m[f"{p}.bn{ci}.{s}"] = (ch,)
            if bi == 0:
                m[f"{p}.downsample.0.weight"] = (out, in_ch, 1, 1)
                for s in ("weight", "bias", "running_mean",
                          "running_var"):
                    m[f"{p}.downsample.1.{s}"] = (out,)
            in_ch = out
    for i, (din, dout) in enumerate(((256, 256), (256, 256), (256, 4))):
        m[f"bbox_embed.layers.{i}.weight"] = (dout, din)
        m[f"bbox_embed.layers.{i}.bias"] = (dout,)
    return m


def _detr_inputs():
    rng = np.random.RandomState(104)
    S = 850  # 25 x 34 encoder tokens (the 800px protocol scale)
    src = rng.randn(1, S, 256).astype(np.float32) * 0.5
    pos = rng.randn(1, S, 256).astype(np.float32) * 0.5
    return src, pos


def _detr_ours(sd, device="cuda", dtype=torch.float32):
    from transformer_mm_explainability_tpu_torch.explain import detr as edetr
    from transformer_mm_explainability_tpu_torch.models import detr
    from transformer_mm_explainability_tpu_torch.models import detr_lrp
    from transformer_mm_explainability_tpu_torch.utils import convert

    cfg = detr.DETR_R50
    params = params_to(convert.detr_from_state_dict(sd, cfg, device), dtype)
    src, pos = (_on(x, device, dtype) for x in _detr_inputs())
    S = src.shape[1]
    oh = torch.zeros((100, 92), dtype=dtype, device=device)
    oh[17, 5] = 1.0

    taps = detr.zero_taps(cfg, 1, S, dtype=dtype, device=device,
                          requires_grad=True)
    flat_taps = [t for family in taps for t in family]
    with torch.enable_grad():
        hs, _, attn, tape = detr.transformer_forward(
            params, src, pos, None, cfg, taps, return_tape=True)
        ce = params["class_embed"]
        logits = hs @ ce["w"] + ce["b"]
        flat = torch.autograd.grad((logits[0] * oh).sum(), flat_taps)
    n_enc, n_dec = cfg.num_encoder_layers, cfg.num_decoder_layers
    grads = detr.DETRTaps(torch.stack(flat[:n_enc]),
                          torch.stack(flat[n_enc:n_enc + n_dec]),
                          torch.stack(flat[n_enc + n_dec:]))
    attn = detr.DETRTaps(*(a.detach() for a in attn))
    per = lambda t: detr.DETRTaps(*(x[:, 0] for x in t))
    R_qi = edetr.relevancy_from_capture(per(attn), per(grads))

    # relprop cams for the LRP-based baselines, from the tape of the SAME
    # forward the gradients came from (models/detr_lrp.relprop, alpha=1:
    # the reference chain DETR/models/detr.py:79-91, class_embed → decoder)
    tape = {k: v.detach() for k, v in tape.items()}
    with torch.no_grad():
        _, cams = detr_lrp.relprop(params, tape, hs.detach(), oh[None], cfg)
    tq = torch.tensor([17], device=device)
    maps = {
        "R_q_i": R_qi[None],
        "transformer_att": edetr.generate_transformer_att(cams, grads, tq),
        "partial_lrp": edetr.generate_partial_lrp(cams, tq),
        "raw_attn": edetr.generate_raw_attn(attn, tq),
        "rollout": edetr.generate_rollout(attn, tq),
        "attn_gradcam": edetr.generate_attn_gradcam(attn, grads, tq),
    }
    return {k: _host(v) for k, v in maps.items()}


def _detr_reference(sd, reference):
    """Reference DETR transformer (relprop modules) + the generate_ours
    propagation (DETR/modules/ExplanationGenerator.py:110-195,
    use_lrp=False) at protocol S."""
    import importlib

    tests_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "tests")
    if tests_dir not in sys.path:
        sys.path.insert(0, tests_dir)
    from _shims import torchvision_shim

    if reference not in sys.path:
        sys.path.insert(0, reference)
    with torchvision_shim():
        mod = importlib.import_module("DETR.models.transformer")

    model = mod.Transformer(d_model=256, nhead=8, num_encoder_layers=6,
                            num_decoder_layers=6, dim_feedforward=2048,
                            dropout=0.0, return_intermediate_dec=True)
    tsd = {k[len("transformer."):]: v for k, v in sd.items()
           if k.startswith("transformer.")}
    # The reference MHA's _pre_load_state_dict hook splits in_proj_*
    # into q/k/v but leaves the original keys in place
    # (DETR/modules/layers.py:711-727), so strict=True always reports
    # them "unexpected"; assert only that nothing is MISSING.
    res = model.load_state_dict(tsd, strict=False)
    assert not res.missing_keys, res.missing_keys
    assert all("in_proj" in k for k in res.unexpected_keys), (
        res.unexpected_keys)
    model = model.eval()

    src, pos = _detr_inputs()
    S = src.shape[1]
    Hf, Wf = 25, 34
    src_t = torch.tensor(src).reshape(1, Hf, Wf, 256).permute(0, 3, 1, 2)
    pos_t = torch.tensor(pos).reshape(1, Hf, Wf, 256).permute(0, 3, 1, 2)
    mask = torch.zeros(1, Hf, Wf, dtype=torch.bool)
    query = torch.tensor(np.asarray(sd["query_embed.weight"]))
    # head assembled from the reference's OWN relprop-instrumented
    # modules so the relprop chain (DETR/models/detr.py:79-91:
    # index_select → class_embed → transformer) runs verbatim
    lmod = importlib.import_module("DETR.modules.layers")
    class_embed = lmod.Linear(256, 92)
    index_select = lmod.IndexSelect()
    with torch.no_grad():
        class_embed.weight.copy_(torch.tensor(
            np.asarray(sd["class_embed.weight"])))
        class_embed.bias.copy_(torch.tensor(
            np.asarray(sd["class_embed.bias"])))
    hs, memory = model(src_t, mask, query, pos_t)
    outputs_class = class_embed(hs)
    logits = index_select(outputs_class, 0,
                          torch.tensor([hs.shape[0] - 1])).squeeze(0)
    one_hot = torch.zeros_like(logits)
    one_hot[0, 17, 5] = 1
    model.zero_grad()
    (one_hot * logits).sum().backward(retain_graph=True)

    # relprop for the LRP-based baselines (detr.py:79-91, alpha=1)
    cam = torch.zeros_like(index_select.Y)
    cam[0, 0, 17, 5] = 1
    cam = index_select.relprop(cam, 1)
    cam = class_embed.relprop(cam, 1)
    model.relprop([cam, torch.zeros_like(memory)], 1)

    # the reference's OWN rule kernels
    # (DETR/modules/ExplanationGenerator.py:5-53)
    with torchvision_shim():
        gen_mod = importlib.import_module(
            "DETR.modules.ExplanationGenerator")

    R_i_i = torch.eye(S)
    for layer in model.encoder.layers:
        e = gen_mod.avg_heads(layer.self_attn.get_attn().detach(),
                              layer.self_attn.get_attn_gradients()
                              .detach())
        R_i_i = R_i_i + e @ R_i_i

    Q = 100
    R_q_q = torch.eye(Q)
    R_q_i = torch.zeros(Q, S)
    for layer in model.decoder.layers:
        e = gen_mod.avg_heads(layer.self_attn.get_attn().detach(),
                              layer.self_attn.get_attn_gradients()
                              .detach())
        add_qq, add_qi = gen_mod.apply_self_attention_rules(
            R_q_q, R_q_i, e)
        R_q_q, R_q_i = R_q_q + add_qq, R_q_i + add_qi
        cam = gen_mod.avg_heads(
            layer.multihead_attn.get_attn().detach(),
            layer.multihead_attn.get_attn_gradients().detach())
        add = gen_mod.apply_mm_attention_rules(R_q_q, R_i_i, cam)
        R_q_i = R_q_i + add

    dec_last = model.decoder.layers[-1]
    cross_attn = dec_last.multihead_attn.get_attn().detach()
    cross_grad = dec_last.multihead_attn.get_attn_gradients().detach()
    cross_cam = dec_last.multihead_attn.get_attn_cam().detach()

    # generate_transformer_att (:64-108): avg_heads of last decoder
    # cross (LRP cam ⊙ grad), row at target query
    ta = gen_mod.avg_heads(cross_cam, cross_grad)[17]

    # generate_partial_lrp (:197-224): head-mean of last cross cam,
    # min-max over the full [Q, S] map, then the target row
    pl = cross_cam.reshape(-1, *cross_cam.shape[-2:]).mean(0)
    pl = (pl - pl.min()) / (pl.max() - pl.min())
    pl = pl[17]

    # generate_raw_attn (:226-238): head-mean of last cross attn
    raw = cross_attn.reshape(-1, *cross_attn.shape[-2:]).mean(0)[17]

    # generate_rollout (:240-270): normalised rollouts over encoder and
    # decoder self-attention bridged by the last cross head-mean
    enc_cams = [l.self_attn.get_attn().detach().mean(0)
                for l in model.encoder.layers]
    dec_cams = [l.self_attn.get_attn().detach().mean(0)
                for l in model.decoder.layers]
    R_ii = gen_mod.compute_rollout_attention(
        [c.unsqueeze(0) for c in enc_cams])[0]
    R_qq = gen_mod.compute_rollout_attention(
        [c.unsqueeze(0) for c in dec_cams])[0]
    cross_mean = cross_attn.reshape(-1, *cross_attn.shape[-2:]).mean(0)
    roll = (R_qq.t() @ (cross_mean @ R_ii))[17]

    # generate_attn_gradcam (:277-305): scalar grad weight per head,
    # clamp, head-mean
    g = cross_grad.reshape(-1, *cross_grad.shape[-2:])
    c = cross_attn.reshape(-1, *cross_attn.shape[-2:])
    gc = (c * g.mean(dim=[1, 2], keepdim=True)).mean(0).clamp(min=0)[17]

    row = lambda t: t.detach().numpy()[None]
    return {"R_q_i": R_q_i.detach().numpy()[None],
            "transformer_att": row(ta),
            "partial_lrp": row(pl),
            "raw_attn": row(raw),
            "rollout": row(roll),
            "attn_gradcam": row(gc)}


FAMILY_IMPL = {
    "vit": (_vit_manifest, _vit_ours, _vit_reference),
    "clip": (_clip_manifest, _clip_ours, _clip_reference),
    "visual_bert": (_visual_bert_manifest, _visual_bert_ours,
                    _visual_bert_reference),
    "lxmert": (_lxmert_manifest, _lxmert_ours, _lxmert_reference),
    "detr": (_detr_manifest, _detr_ours, _detr_reference),
}

# per-family random-weight scale for --generate. lxmert needs 0.05: at
# 0.02 the 5 cross-modal layers smear attention almost uniform, the last
# x-layer cam's (max-min) collapses to ~4e-5, and partial_lrp's min-max
# normalisation amplifies fp32 round-off by 1/range (~25000x) past TOL: a
# degenerate fixture, not a parity failure. verify reads the scale back
# from the npz.
FAMILY_SCALE = {"lxmert": 0.05}


# ---------------------------------------------------------------------------
# fixture IO + verification
# ---------------------------------------------------------------------------

def fixture_path(family: str) -> str:
    return os.path.join(FIXTURE_DIR, f"{family}.npz")


def fixture_state_dict(family: str):
    """``(state dict regenerated from the fixture's manifest, seed and
    scale, the fixture's maps {name: array})``."""
    path = fixture_path(family)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no parity fixture for {family!r} at {path}; generate one "
            "with --generate (needs the reference checkout)")
    z = np.load(path)
    manifest = _manifest_from_json(bytes(z["manifest_json"]).decode())
    sd = random_state_dict(manifest, seed=int(z["seed"]),
                           scale=float(z["scale"]) if "scale" in z
                           else 0.02)
    maps = {k[4:]: z[k] for k in z.files if k.startswith("map_")}
    return sd, maps


def generate_fixture(family: str, reference: str, seed: int = 0,
                     scale: Optional[float] = None, printer=print,
                     device="cuda") -> Dict:
    resolve_device(device)
    if scale is None:
        scale = FAMILY_SCALE.get(family, 0.02)
    manifest_fn, ours_fn, ref_fn = FAMILY_IMPL[family]
    manifest = manifest_fn(reference)
    sd = random_state_dict(manifest, seed=seed, scale=scale)
    printer(f"[{family}] running reference generator "
            f"({len(manifest)} weights)...")
    ref_maps = ref_fn(sd, reference)
    printer(f"[{family}] running our generator...")
    our_maps = ours_fn(sd, device)
    report = {}
    for k, v in ref_maps.items():
        report[k] = map_report(our_maps[k], v, name=k)
        printer(_line(family, k, report[k], "in-process reference"))
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    payload = {f"map_{k}": np.asarray(v) for k, v in ref_maps.items()}
    payload["manifest_json"] = np.frombuffer(
        _manifest_json(manifest).encode(), dtype=np.uint8)
    payload["seed"] = np.asarray(seed)
    payload["scale"] = np.asarray(scale)
    payload["torch_version"] = np.frombuffer(
        torch.__version__.encode(), dtype=np.uint8)
    np.savez_compressed(fixture_path(family), **payload)
    printer(f"[{family}] fixture written: {fixture_path(family)}")
    return report


def verify_fixture(family: str, printer=print, device="cuda",
                   dtype=torch.float32) -> Dict:
    """Regenerate the weights from the fixture's manifest and seed,
    convert, run the port on ``device`` in ``dtype``, and compare with the
    stored reference maps: ``{map name: map_report(...), "ok": the JAX
    rule over every map}``."""
    device = resolve_device(device)
    sd, ref_maps = fixture_state_dict(family)
    _, ours_fn, _ = FAMILY_IMPL[family]
    our_maps = ours_fn(sd, device, dtype)
    report = {}
    ok = True
    for name, ref in ref_maps.items():
        report[name] = map_report(our_maps[name], ref, name=name)
        ok &= report[name]["ok"]
        printer(_line(family, name, report[name], "reference fixture"))
    report["ok"] = bool(ok)
    return report


def verify_weights(family: str, weights: str, reference: Optional[str],
                   printer=print, device="cuda") -> Dict:
    """Convert a real checkpoint file and compare ours vs the reference
    generator (when the reference checkout is available)."""
    device = resolve_device(device)
    printer(f"[{family}] loading {weights}...")
    obj = torch.load(weights, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model" in obj and isinstance(
            obj["model"], dict):
        sd = obj["model"]
    elif isinstance(obj, dict):
        sd = obj
    else:  # torchscript archives (CLIP .pt)
        sd = obj.state_dict()
    sd = {k: v for k, v in sd.items()}
    _, ours_fn, ref_fn = FAMILY_IMPL[family]
    our_maps = ours_fn(sd, device)
    report = {}
    if reference and os.path.isdir(reference):
        ref_maps = ref_fn(sd, reference)
        ok = True
        for k, v in ref_maps.items():
            report[k] = map_report(our_maps[k], v, name=k)
            ok &= report[k]["ok"]
            printer(_line(family, k, report[k], "in-process reference"))
        report["ok"] = bool(ok)
    else:
        for k, v in our_maps.items():
            report[k] = {"shape": list(np.asarray(v).shape),
                         "abs_sum": float(np.abs(v).sum())}
            printer(f"[{family}] {k}: shape {np.asarray(v).shape}, "
                    f"Σ|map| = {report[k]['abs_sum']:.4e} "
                    "(no reference checkout — digests only)")
        report["ok"] = None
    return report


def build_parser(p: Optional[argparse.ArgumentParser] = None
                 ) -> argparse.ArgumentParser:
    p = p or argparse.ArgumentParser(
        description="Parity of the port against the reference's own maps")
    p.add_argument("--family", required=True, choices=FAMILIES + ("all",))
    p.add_argument("--weights", default=None,
                   help="real checkpoint file (torch format)")
    p.add_argument("--generate", action="store_true",
                   help="(re)generate the fixture from the reference")
    p.add_argument("--reference", default=DEFAULT_REFERENCE,
                   help="reference checkout for --generate / --weights")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out", default=None,
                   help="write the per-family reports here as JSON")
    return p


def run(args) -> int:
    """The exit code of the JAX tool's ``main``: 1 when a family fails the
    tool's rule, 0 otherwise; 2 when ``--generate`` has no checkout."""
    if args.generate and not os.path.isdir(args.reference):
        print(f"verify-parity --generate: no reference checkout at "
              f"{args.reference!r}; pass --reference DIR", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    fams = FAMILIES if args.family == "all" else (args.family,)
    rc = 0
    reports = {}
    for fam in fams:
        if args.weights:
            rep = verify_weights(fam, args.weights, args.reference,
                                 device=device)
            if rep.get("ok") is False:
                rc = 1
        elif args.generate:
            rep = generate_fixture(fam, args.reference, device=device)
            if any(r["scaled"] >= TOL for r in rep.values()):
                rc = 1
        else:
            rep = verify_fixture(fam, device=device)
            if not rep["ok"]:
                rc = 1
        reports[fam] = rep
    if args.out:
        with open(args.out, "w") as f:
            json.dump(reports, f, indent=1)
            f.write("\n")
    return rc


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
