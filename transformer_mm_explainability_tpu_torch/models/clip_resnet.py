"""CLIP's ModifiedResNet vision tower (RN50 / RN101 CLIP), in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/clip_resnet.py``
(CLIP/clip/model.py:10-150): the anti-aliased Bottleneck with the average
pool before the stride, the 3-conv stem + average pool, and the QKV
``AttentionPool2d`` head. BatchNorms run in eval mode (``frozen_bn``).

Built on ``models/resnet``'s ``conv`` and ``frozen_bn``: ``forward`` takes
images ``[B, H, W, 3]`` as the JAX function does and runs NCHW tensors in
channels_last memory format inside; weights are OIHW, channels_last.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from transformer_mm_explainability_tpu_torch.models import resnet


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """AvgPool2d(k) with stride k (NCHW)."""
    return F.avg_pool2d(x, k, k)


def bottleneck(x: torch.Tensor, p: Dict[str, Any], stride: int
               ) -> torch.Tensor:
    """CLIP Bottleneck: every conv stride 1; average pool(stride) after
    conv2; downsample = average pool + 1×1 conv."""
    out = torch.relu(resnet.frozen_bn(resnet.conv(x, p["conv1"]["w"]),
                                      p["bn1"]))
    out = torch.relu(resnet.frozen_bn(resnet.conv(out, p["conv2"]["w"]),
                                      p["bn2"]))
    if stride > 1:
        out = avg_pool(out, stride)
    out = resnet.frozen_bn(resnet.conv(out, p["conv3"]["w"]), p["bn3"])
    identity = x
    if "downsample" in p:
        identity = x if stride == 1 else avg_pool(x, stride)
        identity = resnet.frozen_bn(
            resnet.conv(identity, p["downsample"]["w"]), p["downsample_bn"])
    return torch.relu(out + identity)


def attention_pool(p: Dict[str, Any], x: torch.Tensor,
                   num_heads: int) -> torch.Tensor:
    """AttentionPool2d on NCHW ``x``: prepend the spatial mean, add the
    positional embedding, one attention step queried at the mean token."""
    B, C = x.shape[:2]
    tokens = x.flatten(2).transpose(1, 2)                       # [B, HW, C]
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
    tokens = tokens + p["positional_embedding"]
    dh = C // num_heads

    def proj(w, b, t):
        return (t @ w + b).reshape(B, -1, num_heads, dh).transpose(1, 2)

    q = proj(p["q_w"], p["q_b"], tokens[:, :1])
    k = proj(p["k_w"], p["k_b"], tokens)
    v = proj(p["v_w"], p["v_b"], tokens)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / dh ** 0.5
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, -1), v)
    return out.transpose(1, 2).reshape(B, C) @ p["c_w"] + p["c_b"]


def forward(params: Dict[str, Any], images: torch.Tensor,
            num_heads: int) -> torch.Tensor:
    """images ``[B, H, W, 3]`` → pooled embedding ``[B, output_dim]``."""
    x = resnet.to_nchw(images)
    for i in (1, 2, 3):
        x = torch.relu(resnet.frozen_bn(
            resnet.conv(x, params[f"stem_conv{i}"]["w"],
                        stride=2 if i == 1 else 1),
            params[f"stem_bn{i}"]))
    x = avg_pool(x, 2)
    for si, blocks in enumerate(params["layers"]):
        stride = 1 if si == 0 else 2
        for bi, bp in enumerate(blocks):
            x = bottleneck(x, bp, stride if bi == 0 else 1)
    return attention_pool(params["attnpool"], x, num_heads)


def _bn(sd, prefix) -> Dict[str, Any]:
    from transformer_mm_explainability_tpu_torch.utils import convert as cv

    return {"weight": cv._np(sd[f"{prefix}.weight"]),
            "bias": cv._np(sd[f"{prefix}.bias"]),
            "mean": cv._np(sd[f"{prefix}.running_mean"]),
            "var": cv._np(sd[f"{prefix}.running_var"])}


def from_state_dict(sd, prefix: str = "visual.", device="cuda"
                    ) -> Dict[str, Any]:
    """The CLIP RN state-dict subtree → this tower's params on
    ``device``."""
    from transformer_mm_explainability_tpu_torch.utils import convert as cv

    return cv._to_torch(tree_np(sd, prefix), device, hwio=True)


def tree_np(sd, prefix: str = "visual.") -> Dict[str, Any]:
    """The CLIP RN state-dict subtree → the JAX package's tree layout in
    numpy (HWIO convs)."""
    from transformer_mm_explainability_tpu_torch.utils import convert as cv

    conv = lambda k: {"w": cv._conv_hwio(sd[f"{prefix}{k}.weight"])}
    tree: Dict[str, Any] = {}
    for i in (1, 2, 3):
        tree[f"stem_conv{i}"] = conv(f"conv{i}")
        tree[f"stem_bn{i}"] = _bn(sd, f"{prefix}bn{i}")
    layers: List[List[Dict[str, Any]]] = []
    si = 1
    while f"{prefix}layer{si}.0.conv1.weight" in sd:
        blocks = []
        bi = 0
        while f"{prefix}layer{si}.{bi}.conv1.weight" in sd:
            pfx = f"layer{si}.{bi}"
            blk = {}
            for j in (1, 2, 3):
                blk[f"conv{j}"] = conv(f"{pfx}.conv{j}")
                blk[f"bn{j}"] = _bn(sd, f"{prefix}{pfx}.bn{j}")
            if f"{prefix}{pfx}.downsample.0.weight" in sd:
                blk["downsample"] = conv(f"{pfx}.downsample.0")
                blk["downsample_bn"] = _bn(sd, f"{prefix}{pfx}.downsample.1")
            blocks.append(blk)
            bi += 1
        layers.append(blocks)
        si += 1
    tree["layers"] = layers
    ap = f"{prefix}attnpool."
    tree["attnpool"] = {"positional_embedding": cv._np(
        sd[f"{ap}positional_embedding"])}
    for name in ("q", "k", "v", "c"):
        w, b = cv._lin(sd, f"{ap}{name}_proj")
        tree["attnpool"][f"{name}_w"], tree["attnpool"][f"{name}_b"] = w, b
    return tree


def init_params(seed, cfg, device="cuda") -> Dict[str, Any]:
    """Random tower for ``cfg`` (a ResNet ``models.clip.CLIPConfig``),
    drawn on the CPU from ``seed``: He-scaled convs, frozen BN at identity,
    the attention pool's weights at std ``width**-0.5``."""
    from transformer_mm_explainability_tpu_torch.models import bert

    gen = bert._generator(seed)
    CL = torch.channels_last

    def he(cout, cin, k):
        w = torch.randn((cout, cin, k, k), generator=gen) * (
            2.0 / (k * k * cin)) ** 0.5
        return {"w": w.to(device).contiguous(memory_format=CL)}

    def bn(n):
        return {"weight": torch.ones(n, device=device),
                "bias": torch.zeros(n, device=device),
                "mean": torch.zeros(n, device=device),
                "var": torch.ones(n, device=device)}

    w = cfg.vision_width
    params: Dict[str, Any] = {
        "stem_conv1": he(w // 2, 3, 3), "stem_bn1": bn(w // 2),
        "stem_conv2": he(w // 2, w // 2, 3), "stem_bn2": bn(w // 2),
        "stem_conv3": he(w, w // 2, 3), "stem_bn3": bn(w), "layers": []}
    inplanes = w
    for si, n_blocks in enumerate(cfg.vision_layers):
        planes = w * 2 ** si
        blocks = []
        for bi in range(n_blocks):
            blk = {"conv1": he(planes, inplanes, 1), "bn1": bn(planes),
                   "conv2": he(planes, planes, 3), "bn2": bn(planes),
                   "conv3": he(planes * 4, planes, 1), "bn3": bn(planes * 4)}
            if bi == 0:  # stride > 1 or inplanes != 4·planes
                blk["downsample"] = he(planes * 4, inplanes, 1)
                blk["downsample_bn"] = bn(planes * 4)
            blocks.append(blk)
            inplanes = planes * 4
        params["layers"].append(blocks)
    C = w * 32
    n_tok = (cfg.image_resolution // 32) ** 2 + 1
    nrm = lambda s, *shape: (torch.randn(shape, generator=gen) * s).to(device)
    params["attnpool"] = {"positional_embedding": nrm(C ** -0.5, n_tok, C)}
    for name, out in (("q", C), ("k", C), ("v", C), ("c", cfg.embed_dim)):
        params["attnpool"][f"{name}_w"] = nrm(C ** -0.5, C, out)
        params["attnpool"][f"{name}_b"] = torch.zeros(out, device=device)
    return params
