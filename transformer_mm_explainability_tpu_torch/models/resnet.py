"""ResNet backbone with frozen BatchNorm, in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/resnet.py``
(torchvision ResNet with FrozenBatchNorm2d; the caffe/detectron2 variant
through ``stride_in_1x1`` and the caffe stem pool). The convolutions are
``F.conv2d`` and the pools ``F.max_pool2d``: the JAX package leaves both
to XLA, so cuDNN runs them here.

Layouts: ``forward`` keeps the JAX boundary, images ``[B, H, W, 3]`` in
and features ``[B, h, w, C]`` out. Inside, activations are NCHW tensors in
``torch.channels_last`` memory format, so that the NHWC view of any of them
(``x.permute(0, 2, 3, 1)``) is contiguous without a copy; ``conv``,
``frozen_bn``, the pools and ``bottleneck`` take and return such NCHW
tensors. Weights are OIHW, also channels_last (``init_params`` and
``utils/convert`` make them so), and parameter trees are nested dicts of
tensors, in the JAX tree's structure.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import torch
import torch.nn.functional as F

RESNET50_STAGES = (3, 4, 6, 3)
CL = torch.channels_last


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, C]`` → the same values as a channels_last NCHW tensor
    (a view when ``x`` is contiguous)."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=CL)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW → contiguous ``[B, H, W, C]``: a view of a channels_last
    tensor (``contiguous`` is then a no-op), a copy of any other."""
    return x.permute(0, 2, 3, 1).contiguous()


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
         dilation: int = 1) -> torch.Tensor:
    """NCHW conv with OIHW weights and torch-style symmetric padding
    ``dilation·(k−1)//2``, as the JAX ``conv`` pads."""
    kh, kw = w.shape[2], w.shape[3]
    pad = (dilation * (kh - 1) // 2, dilation * (kw - 1) // 2)
    return F.conv2d(x, w, stride=stride, padding=pad, dilation=dilation)


def frozen_bn(x: torch.Tensor, p: Dict[str, torch.Tensor],
              eps: float = 1e-5) -> torch.Tensor:
    """y = (x − mean)·weight/√(var + eps) + bias, all fixed, per channel
    (axis 1), computed as the JAX ``frozen_bn`` computes it."""
    scale = p["weight"] * torch.rsqrt(p["var"] + eps)
    shift = p["bias"] - p["mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """Kernel 3, stride 2, padding 1 with −inf (torchvision's stem pool)."""
    return F.max_pool2d(x, 3, 2, padding=1)


def max_pool_3x3_s2_caffe(x: torch.Tensor) -> torch.Tensor:
    """Caffe-style stem pool: kernel 3, stride 2, no padding,
    ``ceil_mode=True``. The JAX version pads only the bottom and the right
    with −inf to ``ceil((H−3)/2)+1`` outputs; torch's ceil mode gives the
    same size (its last window always starts inside the input here) and
    the max of the partial window over its real pixels, the same values."""
    return F.max_pool2d(x, 3, 2, padding=0, ceil_mode=True)


def bottleneck(x: torch.Tensor, p: Dict[str, Any], stride: int,
               dilation: int = 1, stride_in_1x1: bool = False
               ) -> torch.Tensor:
    """``stride_in_1x1`` selects the caffe/detectron2 variant (stride on
    the first 1×1 conv) vs torchvision v1.5 (stride on the 3×3)."""
    s1, s2 = (stride, 1) if stride_in_1x1 else (1, stride)
    out = torch.relu(frozen_bn(conv(x, p["conv1"]["w"], stride=s1), p["bn1"]))
    out = torch.relu(frozen_bn(
        conv(out, p["conv2"]["w"], stride=s2, dilation=dilation), p["bn2"]))
    out = frozen_bn(conv(out, p["conv3"]["w"]), p["bn3"])
    if "downsample" in p:
        x = frozen_bn(conv(x, p["downsample"]["w"], stride=stride),
                      p["downsample_bn"])
    return torch.relu(out + x)


def stem(params: Dict[str, Any], x: torch.Tensor,
         caffe_pool: bool = False) -> torch.Tensor:
    """conv1 7×7/2 → frozen BN → relu → 3×3/2 max pool, NCHW."""
    x = torch.relu(frozen_bn(conv(x, params["conv1"]["w"], stride=2),
                             params["bn1"]))
    return max_pool_3x3_s2_caffe(x) if caffe_pool else max_pool_3x3_s2(x)


def forward(params: Dict[str, Any], images: torch.Tensor,
            dilation_last: bool = False) -> torch.Tensor:
    """images ``[B, H, W, 3]`` → C5 features ``[B, H/32, W/32, 2048]`` (or
    H/16 with ``dilation_last``, the DC5 variants), a contiguous NHWC
    view of a channels_last result."""
    x = stem(params, to_nchw(images))
    for si, blocks in enumerate(params["layers"]):
        stage_stride = 1 if si == 0 else 2
        dilation = 1
        if dilation_last and si == 3:
            stage_stride, dilation = 1, 2
        for bi, bp in enumerate(blocks):
            x = bottleneck(x, bp, stride=stage_stride if bi == 0 else 1,
                           dilation=dilation)
    return to_nhwc(x)


def init_params(seed: Union[int, torch.Generator] = 0,
                stages: Tuple[int, ...] = RESNET50_STAGES, width: int = 64,
                device="cuda") -> Dict[str, Any]:
    """He-init random backbone (real weights via ``utils/convert``), drawn
    on the CPU from ``seed`` so that every device gets the same numbers;
    frozen BN at identity."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))

    def he(cout, cin, k):
        w = torch.randn((cout, cin, k, k), generator=gen) * (
            2.0 / (k * k * cin)) ** 0.5
        return w.to(device).contiguous(memory_format=CL)

    def bn(n):
        return {"weight": torch.ones(n, device=device),
                "bias": torch.zeros(n, device=device),
                "mean": torch.zeros(n, device=device),
                "var": torch.ones(n, device=device)}

    params: Dict[str, Any] = {"conv1": {"w": he(width, 3, 7)},
                              "bn1": bn(width), "layers": []}
    in_ch = width
    for si, n_blocks in enumerate(stages):
        mid = width * (2 ** si)
        out_ch = mid * 4
        blocks: List[Dict[str, Any]] = []
        for bi in range(n_blocks):
            p = {"conv1": {"w": he(mid, in_ch, 1)}, "bn1": bn(mid),
                 "conv2": {"w": he(mid, mid, 3)}, "bn2": bn(mid),
                 "conv3": {"w": he(out_ch, mid, 1)}, "bn3": bn(out_ch)}
            if bi == 0:
                p["downsample"] = {"w": he(out_ch, in_ch, 1)}
                p["downsample_bn"] = bn(out_ch)
            blocks.append(p)
            in_ch = out_ch
        params["layers"].append(blocks)
    return params
