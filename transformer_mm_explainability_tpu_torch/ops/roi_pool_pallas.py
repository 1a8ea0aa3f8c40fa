"""torchvision-exact RoIPool as a CUDA kernel, with its plain version.

Counterpart of ``transformer_mm_explainability_tpu/ops/roi_pool_pallas.py``
(the name is kept so that the two are easy to pair). Semantics, shared by
the kernel and ``roi_pool_plain`` (and by ``models/frcnn.roi_pool``, which
calls the plain version): box coordinates are ``round()``-quantised after
scaling, the RoI width and height use the +1 convention with a minimum of
1, bin p spans ``[floor(p·roi/P), ceil((p+1)·roi/P))`` clipped to the map,
each bin is the max over its rows × columns, and an empty bin, or a
maximum that is not finite, gives 0. Features are float32 or bfloat16 and
the output keeps their dtype, as the JAX kernel's does (a maximum is one of
its inputs, so bf16 is exact); boxes are float32 on both devices. The JAX
``roi_bin_bounds`` rounds ``boxes * scale + 0.5`` in the boxes' dtype,
where bf16 boxes would tie the bins to XLA's excess-precision rewrites;
both detectors make float32 boxes, and bf16 boxes raise here.

``roi_bin_bounds`` computes the bins in integer torch arithmetic on the
boxes' device, and the plain version takes its bins from it; the kernel
computes the same bins itself from the boxes (multiply, then add, each
rounded to fp32, then the same integer arithmetic). A CPU tensor goes to
``roi_pool_plain``; a CUDA tensor goes to the kernel of
``csrc/roi_pool.cu`` (built by ``ops/_build.py`` at first use), or the
wrapper raises: there is no fallback. The TPU knobs of the JAX wrapper
(``c_tile``, ``interpret``) have no counterpart.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from transformer_mm_explainability_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "tmx_roi_pool": [_P] * 3 + [_I] * 5 + [ctypes.c_float, _I, _P],
}
# boxes per step of the plain version: its candidate-window gather holds
# H·P·K_cand·C floats per box (23 MB at [50, 76, 1024], P = 14), so 16 boxes
# keep its peak near 0.8 GB at the protocol shape
PLAIN_CHUNK = 16


def library() -> ctypes.CDLL:
    """The built and loaded ``csrc/roi_pool.cu`` (built on first call)."""
    return _build.load("roi_pool", _SIGNATURES)


def roi_bin_bounds(boxes: torch.Tensor, output_size: int,
                   spatial_scale: float, H: int, W: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """torchvision roi_pool bin boundaries, exact integer arithmetic (the
    JAX ``roi_bin_bounds``). Returns ``(hs, he, ws, we)``, int32 ``[K, P]``:
    bin p covers rows ``[hs, he)`` × columns ``[ws, we)`` of the map.

    ``boxes * spatial_scale + 0.5`` runs as two torch operations, a
    multiply and an add, each rounded, as XLA rounds them."""
    P = output_size
    q = torch.floor(boxes * spatial_scale + 0.5).to(torch.int32)
    x0, y0, x1, y1 = q.unbind(1)
    roi_w = torch.clamp(x1 - x0 + 1, min=1)[:, None]
    roi_h = torch.clamp(y1 - y0 + 1, min=1)[:, None]
    pi = torch.arange(P, dtype=torch.int32, device=boxes.device)[None, :]
    hs = torch.clamp(torch.div(pi * roi_h, P, rounding_mode="floor")
                     + y0[:, None], 0, H)
    he = torch.clamp(torch.div((pi + 1) * roi_h + P - 1, P,
                               rounding_mode="floor") + y0[:, None], 0, H)
    ws = torch.clamp(torch.div(pi * roi_w, P, rounding_mode="floor")
                     + x0[:, None], 0, W)
    we = torch.clamp(torch.div((pi + 1) * roi_w + P - 1, P,
                               rounding_mode="floor") + x0[:, None], 0, W)
    return tuple(t.to(torch.int32) for t in (hs, he, ws, we))


def _pool_chunk(features: torch.Tensor, hs, he, ws, we,
                K_cand: int) -> torch.Tensor:
    """The two masked-max passes of ``models/frcnn.roi_pool`` (x, then y)
    over a window of ``K_cand`` candidate pixels per bin, for a chunk of k
    boxes: ``[H, W, C]`` → ``[k, P, P, C]``."""
    H, W, C = features.shape
    k, P = hs.shape
    kk = torch.arange(K_cand, device=features.device)
    neg = torch.tensor(float("-inf"), dtype=features.dtype,
                       device=features.device)
    # pass 1: max along x per (row, x-bin)
    cand_x = ws[..., None].long() + kk                         # [k, P, Kc]
    ok_x = cand_x < we[..., None]
    g = features[:, cand_x.clamp(max=W - 1).reshape(-1)]      # [H, k·P·Kc, C]
    g = g.reshape(H, k, P, K_cand, C)
    t1 = torch.where(ok_x[None, ..., None], g, neg).amax(dim=3)  # [H, k, P, C]
    del g
    # pass 2: max along y per (y-bin, x-bin)
    cand_y = hs[..., None].long() + kk                         # [k, P, Kc]
    ok_y = cand_y < he[..., None]
    t1 = t1.permute(1, 0, 2, 3)                                # [k, H, P, C]
    rows = torch.arange(k, device=features.device)[:, None, None]
    g2 = t1[rows, cand_y.clamp(max=H - 1)]                     # [k, P, Kc, P, C]
    out = torch.where(ok_y[..., None, None], g2, neg).amax(dim=2)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def roi_pool_plain(features: torch.Tensor, boxes: torch.Tensor,
                   output_size: int, spatial_scale: float) -> torch.Tensor:
    """RoIPool in plain PyTorch: ``[H, W, C]`` features × ``[K, 4]`` xyxy
    boxes → ``[K, P, P, C]``; the function of ``models/frcnn.roi_pool`` in
    JAX, boxes in chunks of ``PLAIN_CHUNK``. The candidate window is the
    widest bin of this call's boxes (one host read), so a bin of any width
    is pooled whole."""
    H, W, C = features.shape
    P = output_size
    K = boxes.shape[0]
    if K == 0:
        return features.new_zeros((0, P, P, C))
    hs, he, ws, we = roi_bin_bounds(boxes, P, spatial_scale, H, W)
    K_cand = max(int(torch.max(torch.maximum(he - hs, we - ws))), 1)
    c = PLAIN_CHUNK
    return torch.cat([
        _pool_chunk(features, hs[i:i + c], he[i:i + c], ws[i:i + c],
                    we[i:i + c], K_cand)
        for i in range(0, K, c)])


def _check(features: torch.Tensor, boxes: torch.Tensor) -> None:
    if features.dim() != 3:
        raise RuntimeError(f"features has shape {tuple(features.shape)}, "
                           "expected [H, W, C]")
    if boxes.dim() != 2 or boxes.shape[1] != 4:
        raise RuntimeError(f"boxes has shape {tuple(boxes.shape)}, expected "
                           "[K, 4]")
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise RuntimeError(f"features is {features.dtype}; RoIPool takes "
                           "float32 or bfloat16 features")
    if boxes.dtype != torch.float32:
        raise RuntimeError(f"boxes is {boxes.dtype}; RoIPool takes float32 "
                           "boxes (its bins are computed from fp32 box "
                           "coordinates)")
    if boxes.device != features.device:
        raise RuntimeError(f"boxes is on {boxes.device}, expected "
                           f"{features.device}")
    if not features.is_contiguous():
        raise RuntimeError("features must be a contiguous [H, W, C] map "
                           f"(strides {features.stride()})")


def roi_pool_pallas(features: torch.Tensor, boxes: torch.Tensor,
                    output_size: int, spatial_scale: float) -> torch.Tensor:
    """RoIPool, ``[H, W, C]`` float32 or bfloat16 features × ``[K, 4]``
    float32 xyxy boxes (image scale) → ``[K, P, P, C]`` of the features'
    dtype.

    Replaces ``roi_pool_pallas.roi_pool_pallas`` (``_kernel``). Bound by
    bytes: the map read once and the output written once (see the source
    note in ``csrc/roi_pool.cu``): one block per (box, chunk of channels,
    group of bin rows), each thread walking its rows once across a band of
    column bins, the bins computed in the kernel, streaming stores. The
    inputs are checked before any launch, on either device."""
    _check(features, boxes)
    if _build.on_cpu(features):
        return roi_pool_plain(features, boxes, output_size, spatial_scale)
    H, W, C = features.shape
    P, K = output_size, boxes.shape[0]
    dev = features.device
    out = torch.empty((K, P, P, C), device=dev, dtype=features.dtype)
    if K == 0:          # nothing to pool: no launch, no count
        return out
    boxes = boxes.contiguous()
    lib = library()
    p = _build.ptr
    with _build.on_device(dev):
        _build.check(lib, "tmx_roi_pool", lib.tmx_roi_pool(
            p(features), p(boxes), p(out), K, H, W, C, P, spatial_scale,
            int(features.dtype == torch.bfloat16), _build.stream(dev)))
    roi_pool_pallas.launches += 1
    return out


KERNELS = (roi_pool_pallas,)
for _fn in KERNELS:
    _fn.launches = 0


def launch_counts() -> Dict[str, int]:
    """CUDA launches of each wrapper since the last reset."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
