"""Pretrained-model interfaces, in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/interfaces.py``
(``mmf/models/interfaces/mmbt.py``): ``MMBTGridHMInterface.classify(image,
text)`` for MMBT-Grid on Hateful Memes, the processors, the ResNet-152
grid and the softmaxed verdict, on ``device`` (cuda unless the caller asks
for the CPU).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from transformer_mm_explainability_tpu_torch._device import (
    params_to,
    resolve_device,
)
from transformer_mm_explainability_tpu_torch.models import encoders as E
from transformer_mm_explainability_tpu_torch.models import mmbt as tmmbt


def _load_image(image: Union[str, np.ndarray]) -> np.ndarray:
    """A path or an array → float32 CHW in [0, 1]. A URL raises: the
    reference downloads it (interfaces/mmbt.py:61-66), the port works
    offline."""
    if isinstance(image, str):
        if image.startswith("http"):
            raise RuntimeError(
                "offline image: pass a local path or array, not a URL")
        from PIL import Image
        image = np.asarray(Image.open(image).convert("RGB"))
    image = np.asarray(image)
    if image.ndim == 3 and image.shape[-1] == 3:
        image = np.moveaxis(image, -1, 0)
    # ToTensor's rule: integer images are 0-255, float ones already scaled
    if np.issubdtype(image.dtype, np.integer):
        return image.astype(np.float32) / 255.0
    return image.astype(np.float32)


class MMBTGridHMInterface:
    """MMBTGridHMInterface (interfaces/mmbt.py:25-85). ``params`` holds
    ``{"mmbt": ..., "image_encoder": ...}`` in the port's layout;
    ``text_processor`` returns input_ids / input_mask / segment_ids;
    ``image_processor`` maps a CHW float image to the encoder's input."""

    def __init__(self, params: Dict[str, Any], cfg: tmmbt.MMBTConfig,
                 text_processor: Callable,
                 image_processor: Optional[Callable] = None,
                 image_encoder: Optional[E.ResNet152ImageEncoder] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        self.cfg = cfg
        self.text_processor = text_processor
        self.image_processor = image_processor
        self.image_encoder = (image_encoder or E.ResNet152ImageEncoder(
            {"num_output_features": -1}))

    @torch.no_grad()
    def probabilities(self, image: torch.Tensor, input_ids: torch.Tensor,
                      input_mask: torch.Tensor, segment_ids: torch.Tensor
                      ) -> torch.Tensor:
        """Class probabilities ``[B, 2]`` of NCHW images and their tokens.
        MMBTBase.forward (mmbt.py:375-381) wraps the modal stream in the
        text's [CLS] / [SEP] embeddings; with an end token the text drops
        its leading [CLS] (extract_modal_end_token, mmbt.py:338-363)."""
        cfg = self.cfg
        grid = self.image_encoder.apply(self.params["image_encoder"], image)
        modal_start = modal_end = None
        if cfg.use_modal_start_token:
            modal_start = input_ids[:, 0]
        if cfg.use_modal_end_token:
            gather = (input_mask.sum(dim=1) - 1).long()[:, None]
            modal_end = torch.gather(input_ids, 1, gather)[:, 0]
            input_ids = torch.cat([input_ids[:, 1:], input_ids[:, -1:]], 1)
            input_mask = torch.cat([input_mask[:, 1:],
                                    torch.zeros_like(input_mask[:, :1])], 1)
        scores = tmmbt.mmbt_for_classification(
            self.params["mmbt"], cfg, input_modal=grid, input_ids=input_ids,
            attention_mask=input_mask, token_type_ids=segment_ids,
            modal_start_token=modal_start, modal_end_token=modal_end)
        return torch.softmax(scores, dim=1)

    def classify(self, image: Union[str, np.ndarray], text: str
                 ) -> Dict[str, float]:
        """interfaces/mmbt.py:43-85 → ``{"label": 0 | 1, "confidence":
        p}``."""
        img = _load_image(image)
        if self.image_processor is not None:
            out = self.image_processor({"image": img})
            img = out["image"] if isinstance(out, dict) else out
        toks = self.text_processor({"text": text})
        as_t = lambda a: torch.as_tensor(np.asarray(a), device=self.device
                                         )[None]
        probs = self.probabilities(
            torch.as_tensor(np.asarray(img, np.float32),
                            device=self.device)[None],
            as_t(toks["input_ids"]).long(), as_t(toks["input_mask"]),
            as_t(toks["segment_ids"]).long())
        label = int(probs[0].argmax())
        return {"label": label, "confidence": float(probs[0, label])}
