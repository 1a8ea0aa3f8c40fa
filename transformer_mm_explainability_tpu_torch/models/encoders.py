"""MMF's image and text encoder zoo, in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/encoders.py``
(``mmf/modules/encoders.py``): the registered encoders (identity,
finetune_faster_rcnn_fpn_fc7, resnet152, transformer, text_embedding),
ProjectionEmbedding and the three factories. Each encoder is a small
config object with ``init(seed, device) -> params`` and ``apply(params,
x)``. Images are NCHW at the boundary, as in the reference.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from transformer_mm_explainability_tpu_torch.core.registry import registry
from transformer_mm_explainability_tpu_torch.models import bert as tbert
from transformer_mm_explainability_tpu_torch.models import mmf_layers as L
from transformer_mm_explainability_tpu_torch.models import resnet as tresnet
from transformer_mm_explainability_tpu_torch.models.fusions import (
    bert_pooled,
)

RESNET152_STAGES = (3, 8, 36, 3)


@registry.register_encoder("identity")
class IdentityEncoder:
    """IdentityEncoder (encoders.py:134-148)."""

    def __init__(self, config: Dict[str, Any]):
        self.in_dim = self.out_dim = config["in_dim"]

    def init(self, seed: L.Seed = 0, device="cuda") -> Dict:
        return {}

    def apply(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        return x


class ProjectionEncoder:
    """ProjectionEmbedding (embeddings.py:194-215), the 'linear' module."""

    def __init__(self, config: Dict[str, Any]):
        if config.get("module", "linear") != "linear":
            raise TypeError(
                "Unknown module type for 'ProjectionEmbedding',"
                "use either 'linear' or 'conv'")
        self.in_dim = config["in_dim"]
        self.out_dim = config["out_dim"]

    def init(self, seed: L.Seed = 0, device="cuda") -> Dict:
        return L.init_linear(seed, self.in_dim, self.out_dim, device)

    def apply(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        return L.linear_fwd(params, x)


@registry.register_encoder("finetune_faster_rcnn_fpn_fc7")
class FinetuneFasterRcnnFpnFc7:
    """FinetuneFasterRcnnFpnFc7 (encoders.py:93-131): the detectron fc7
    linear + ReLU over pooled FRCNN features, with weights from the
    published fc7_w / fc7_b pickles (``weights_file`` / ``bias_file``) or
    explicit arrays (``weights`` / ``bias``), else random."""

    def __init__(self, config: Dict[str, Any]):
        self.in_dim = config["in_dim"]
        self.weights: Optional[np.ndarray] = None
        self.bias: Optional[np.ndarray] = None
        if "weights" in config:
            self.weights = np.asarray(config["weights"], np.float32)
            self.bias = np.asarray(config["bias"], np.float32)
        elif "weights_file" in config:
            with open(config["weights_file"], "rb") as w:
                self.weights = np.asarray(pickle.load(w), np.float32)
            with open(config["bias_file"], "rb") as b:
                self.bias = np.asarray(pickle.load(b), np.float32)
        self.out_dim = (self.bias.shape[0] if self.bias is not None
                        else config.get("out_dim", self.in_dim))

    def init(self, seed: L.Seed = 0, device="cuda") -> Dict:
        if self.weights is not None:
            return {"w": torch.as_tensor(self.weights, device=device),
                    "b": torch.as_tensor(self.bias, device=device)}
        return L.init_linear(seed, self.in_dim, self.out_dim, device)

    def apply(self, params: Dict, image: torch.Tensor) -> torch.Tensor:
        return torch.relu(L.linear_fwd(params, image))


def adaptive_pool_2d(x: torch.Tensor, out_hw, mode: str = "avg"
                     ) -> torch.Tensor:
    """torch's AdaptiveAvg/MaxPool2d on NHWC ``[B, H, W, C]`` →
    ``[B, oh, ow, C]``: cell i spans [⌊i·S/O⌋, ⌈(i+1)·S/O⌉), the bounds
    the JAX package computes by hand."""
    pool = F.adaptive_avg_pool2d if mode == "avg" else F.adaptive_max_pool2d
    return pool(x.permute(0, 3, 1, 2), tuple(out_hw)).permute(0, 2, 3, 1)


@registry.register_encoder("resnet152")
class ResNet152ImageEncoder:
    """ResNet152ImageEncoder (encoders.py:188-230): the torchvision
    resnet152 trunk through layer4, an adaptive pool to the grid of
    ``num_output_features`` (``GRIDS``, encoders.py:210-221; −1 keeps every
    cell) and a row-major flatten to ``[B, N, 2048]``. Input is NCHW."""

    GRIDS = {1: (1, 1), 2: (2, 1), 3: (3, 1), 4: (2, 2), 5: (5, 1),
             6: (3, 2), 7: (7, 1), 8: (4, 2), 9: (3, 3)}

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.pool_type = config.get("pool_type", "avg")
        self.num_output_features = config.get("num_output_features", 1)
        self.out_dim = 2048

    def init(self, seed: L.Seed = 0, device="cuda") -> Dict:
        return tresnet.init_params(seed, stages=RESNET152_STAGES,
                                   device=device)

    def apply(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        feat = tresnet.forward(params, x.permute(0, 2, 3, 1))
        B, H, W, C = feat.shape
        n = self.num_output_features
        if n == -1:
            return feat.reshape(B, H * W, C)
        mode = "avg" if self.pool_type == "avg" else "max"
        pooled = adaptive_pool_2d(feat, self.GRIDS[n], mode)
        return pooled.reshape(B, -1, self.out_dim)


@registry.register_encoder("transformer")
class TransformerEncoder:
    """TransformerEncoder (encoders.py:297-359): a BERT whose forward is
    the pooled output; with ``num_segments`` > 2 the token-type table grows
    (first two rows copied, middle rows their mean, the last row left at
    init: the reference's off-by-one at :346-349)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.num_segments = config.get("num_segments", 2)
        self.cfg = tbert.BertConfig(
            vocab_size=config.get("vocab_size", 30522),
            hidden_size=config.get("hidden_size", 768),
            num_hidden_layers=config.get("num_hidden_layers", 12),
            num_attention_heads=config.get("num_attention_heads", 12))
        self.out_dim = self.cfg.hidden_size

    def init(self, seed: L.Seed = 0, device="cuda") -> Dict:
        gen = L.generator(seed)
        D = self.cfg.hidden_size
        emb = tbert.init_embedding_params(gen, self.cfg, device)
        enc = tbert.init_encoder_params(gen, self.cfg, device)
        pooler = {"w": L.normal(gen, (D, D), 0.02, device),
                  "b": torch.zeros(D, device=device)}
        if self.num_segments and self.num_segments > 2:
            old = emb["token_type"]
            new = L.normal(gen, (self.num_segments, D), 0.02, device)
            new[:2] = old[:2]
            new[2:self.num_segments - 1] = old.mean(dim=0)
            emb["token_type"] = new
        return {"embeddings": emb, "encoder": enc, "pooler": pooler}

    def apply(self, params: Dict, input_ids: torch.Tensor,
              input_mask: Optional[torch.Tensor] = None,
              segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        return bert_pooled(params, self.cfg, input_ids, input_mask,
                           segment_ids)


@registry.register_encoder("text_embedding")
class TextEmbeddingEncoder:
    """TextEmbeddingEncoder (encoders.py:266-294): a TextEmbedding, then a
    sum / concat / mul over the sequence. The 'attention' embedding type
    (BiLSTM + attention, the VisDial / Pythia one) is the one wired."""

    def __init__(self, config: Dict[str, Any]):
        self.operator = config["operator"]
        ep = config["embedding_params"]
        if ep["type"] != "attention":
            raise NotImplementedError(
                f"TextEmbedding type {ep['type']} not wired")
        self.params_cfg = ep["params"]

    def init(self, seed: L.Seed = 0, device="cuda") -> Dict:
        p = self.params_cfg
        return L.init_attention_text_embedding(
            seed, p["hidden_dim"], p["embedding_dim"], p["conv1_out"],
            p["conv2_out"], p.get("bidirectional", False), device)

    def apply(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        y = L.attention_text_embedding_fwd(params, x)
        if self.operator == "sum":
            y = y.sum(dim=1)
        elif self.operator == "concat":
            y = y.reshape(y.shape[0], -1)
        elif self.operator == "mul":
            y = torch.prod(y, dim=1)
        return y.squeeze()


# ---------------------------------------------------------------------------
# the factories (encoders.py:56-90, 157-184, 239-263)
# ---------------------------------------------------------------------------

def build_image_feature_encoder(enc_type: str, params: Dict[str, Any]):
    """ImageFeatureEncoderFactory (encoders.py:62-90)."""
    assert "in_dim" in params, (
        "ImageFeatureEncoder require 'in_dim' param in config")
    if enc_type in ("default", "identity"):
        return IdentityEncoder(params)
    if enc_type == "projection":
        return ProjectionEncoder(params)
    if enc_type == "finetune_faster_rcnn_fpn_fc7":
        return FinetuneFasterRcnnFpnFc7(params)
    raise NotImplementedError(f"Unknown Image Encoder: {enc_type}")


def build_image_encoder(enc_type: str,
                        params: Optional[Dict[str, Any]] = None):
    """ImageEncoderFactory (encoders.py:162-184)."""
    if enc_type in ("default", "identity"):
        return IdentityEncoder(params or {"in_dim": None})
    if enc_type == "resnet152":
        return ResNet152ImageEncoder(params)
    raise NotImplementedError(f"Unknown Image Encoder: {enc_type}")


def build_text_encoder(enc_type: str,
                       params: Optional[Dict[str, Any]] = None):
    """TextEncoderFactory (encoders.py:246-263)."""
    if enc_type == "identity":
        return IdentityEncoder(params or {"in_dim": None})
    if enc_type == "transformer":
        return TransformerEncoder(params)
    if enc_type == "embedding":
        return TextEmbeddingEncoder(params)
    raise NotImplementedError(f"Unknown Text Encoder {enc_type}")
