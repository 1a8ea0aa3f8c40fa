"""Published-checkpoint loaders onto the port's models.

Counterpart of ``transformer_mm_explainability_tpu/utils/clip_loader.py``:
``load_clip`` takes the OpenAI CLIP release files that ``clip.load``
takes (TorchScript archives or plain state dicts), ``load_timm_vit`` timm
``vit_base_patch16_224`` checkpoints and ``load_lxmert_hf`` HF
``unc-nlp/lxmert-vqa-uncased`` state dicts and ``load_detr`` the facebook
DETR release (``detr-r50-e632da11.pth``). Each returns the port's params
on ``device`` and the config.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from transformer_mm_explainability_tpu_torch._device import resolve_device
from transformer_mm_explainability_tpu_torch.utils import convert


def _to_state_dict(obj) -> Dict[str, Any]:
    if hasattr(obj, "state_dict"):
        return obj.state_dict()
    if isinstance(obj, dict):
        for key in ("state_dict", "model"):
            if isinstance(obj.get(key), dict):
                return obj[key]
        return obj
    raise TypeError(f"cannot extract a state dict from {type(obj)}")


def load_clip(path: str, device="cuda"):
    """OpenAI CLIP .pt (TorchScript archive or state dict) →
    ``(params, CLIPConfig)``."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except Exception:
        sd = _to_state_dict(torch.load(path, map_location="cpu"))
    return convert.clip_from_state_dict(sd, device)


def load_timm_vit(path: str, device="cuda"):
    """timm vit_base_patch16_224 checkpoint → ``(ViT, ViTConfig)``."""
    sd = _to_state_dict(torch.load(path, map_location="cpu"))
    return convert.vit_from_state_dict(sd, device)


def load_lxmert_hf(path: str, cfg=None, device="cuda"):
    """HF lxmert (e.g. unc-nlp/lxmert-vqa-uncased pytorch_model.bin) →
    ``(params, cfg)`` for ``models/lxmert``; ``cfg`` defaults to
    ``LXMERT_VQA``."""
    from transformer_mm_explainability_tpu_torch.models.lxmert import (
        LXMERT_VQA)

    cfg = cfg or LXMERT_VQA
    sd = _to_state_dict(torch.load(path, map_location="cpu"))
    return convert.lxmert_from_state_dict(sd, cfg, device), cfg


def load_detr(path: str, cfg=None, device="cuda"):
    """DETR release checkpoint (detr-r50-e632da11.pth style) →
    ``(params, cfg)`` for ``models/detr`` (backbone, transformer, heads);
    ``cfg`` defaults to ``DETR_R50``."""
    from transformer_mm_explainability_tpu_torch.models.detr import DETR_R50

    cfg = cfg or DETR_R50
    device = resolve_device(device)
    sd = _to_state_dict(torch.load(path, map_location="cpu"))
    return convert.detr_from_state_dict(sd, cfg, device), cfg
