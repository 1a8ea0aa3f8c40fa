"""Named DETR constructors (the torch.hub surface), on the PyTorch port.

Counterpart of ``transformer_mm_explainability_tpu/hub.py``, a re-design of
``DETR/hubconf.py``: detr_resnet50 (:26), detr_resnet50_dc5 (:42),
detr_resnet101 (:59), detr_resnet101_dc5 (:74), detr_resnet50_panoptic
(:91), detr_resnet50_dc5_panoptic (:117) and detr_resnet101_panoptic
(:143). Each returns ``(cfg, params)`` on ``device`` and, with
``return_postprocessor``, the matching post-processor third:
``models/matcher.post_process``, or ``harness/panoptic.post_process_panoptic``
bound to the variant's thing map and threshold.

``pretrained=<local .pth path>`` loads a release checkpoint through
``utils/convert.detr_from_state_dict``; ``pretrained=True`` (the hub's
download URL) raises, as the port downloads nothing.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from transformer_mm_explainability_tpu_torch._device import resolve_device
from transformer_mm_explainability_tpu_torch.models import detr
from transformer_mm_explainability_tpu_torch.models.matcher import (
    post_process,
)

R50 = (3, 4, 6, 3)
R101 = (3, 4, 23, 3)


def _make_detr(stages, dilation: bool, num_classes: int, pretrained,
               seed: int, device) -> Tuple[detr.DETRConfig, Dict[str, Any]]:
    cfg = detr.DETRConfig(num_classes=num_classes, dilation=dilation,
                          backbone_stages=tuple(stages))
    device = resolve_device(device)
    if pretrained:
        if pretrained is True:
            raise RuntimeError(
                "offline: pass pretrained=<local .pth path>; the "
                "dl.fbaipublicfiles.com hub URLs are not fetched")
        from transformer_mm_explainability_tpu_torch.utils.convert import (
            detr_from_state_dict)
        sd = torch.load(pretrained, map_location="cpu", weights_only=False)
        params = detr_from_state_dict(sd.get("model", sd), cfg, device)
    else:
        params = detr.init_params(seed, cfg, device)
    return cfg, params


def _entry(stages, dilation, default_classes):
    def build(pretrained=False, num_classes=None,
              return_postprocessor: bool = False, seed: int = 0,
              device="cuda"):
        cfg, params = _make_detr(stages, dilation,
                                 num_classes or default_classes, pretrained,
                                 seed, device)
        if return_postprocessor:
            return cfg, params, post_process
        return cfg, params

    return build


detr_resnet50 = _entry(R50, False, 91)
detr_resnet50_dc5 = _entry(R50, True, 91)
detr_resnet101 = _entry(R101, False, 91)
detr_resnet101_dc5 = _entry(R101, True, 91)


def _panoptic_entry(stages, dilation):
    def build(pretrained=False, num_classes: int = 250,
              threshold: float = 0.85, return_postprocessor: bool = False,
              seed: int = 0, device="cuda"):
        cfg, params = _make_detr(stages, dilation, num_classes, pretrained,
                                 seed, device)
        if return_postprocessor:
            from transformer_mm_explainability_tpu_torch.harness.panoptic import (
                post_process_panoptic)
            is_thing_map = {i: i <= 90 for i in range(num_classes)}
            pp = functools.partial(post_process_panoptic,
                                   is_thing_map=is_thing_map,
                                   threshold=threshold)
            return cfg, params, pp
        return cfg, params

    return build


detr_resnet50_panoptic = _panoptic_entry(R50, False)
detr_resnet50_dc5_panoptic = _panoptic_entry(R50, True)
detr_resnet101_panoptic = _panoptic_entry(R101, False)
