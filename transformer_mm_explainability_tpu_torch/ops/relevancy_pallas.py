"""The rule-6 relevancy chain as CUDA kernels, with its plain version.

Counterpart of ``transformer_mm_explainability_tpu/ops/relevancy_pallas.py``
(the name is kept so that the two are easy to pair):

    R ← I;  for l in start..L-1:  Ê_l = mean_h relu(A_l ∘ ∇A_l);  R ← R + Ê_l·R

``self_attention_relevancy_pallas`` takes ``[B, L, H, S, S]`` fp32 captures
and returns ``[B, S, S]``. A CPU tensor goes to the plain version, the
port's batched ``ops/relevancy.self_attention_relevancy``; a CUDA tensor
goes to the kernels of ``csrc/relevancy_chain.cu`` (built by
``ops/_build.py`` at first use), or the wrapper raises: there is no
fallback. One kernel reduces the heads of every layer into Ê at once, then
per layer a batched GEMM writes ``Ê·R + R`` into the other of two buffers;
R never leaves the device between layers. The JAX kernel pads S to 128;
these kernels pad S to ``padded(S)``, the next multiple of 4, with zeros,
which add exact zeros to every product, so the result is the unpadded
chain.

The captures may be any strided view whose last two axes are a contiguous
``[S, S]`` plane, e.g. ``capture``'s ``[L, B, H, S, S]`` stacks with the
first two axes swapped, without a copy. ``self_attention_relevancy_auto``
is the JAX dispatcher's counterpart: the kernels on the card, the plain
chain on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from transformer_mm_explainability_tpu_torch.ops import _build
from transformer_mm_explainability_tpu_torch.ops import relevancy as rl

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "tmx_relevancy_chain": [_P] * 6 + [_I] * 6 + [_P],
}


def padded(S: int) -> int:
    """The kernels' row length: S rounded up to a multiple of 4, so that
    every row of Ê and R starts on a 16-byte boundary."""
    return -(-S // 4) * 4


def library() -> ctypes.CDLL:
    """The built and loaded ``csrc/relevancy_chain.cu`` (built on first
    call)."""
    return _build.load("relevancy_chain", _SIGNATURES)


# the plain version is the port's batched chain itself
self_attention_relevancy_pallas_plain = rl.self_attention_relevancy


def _check(cams: torch.Tensor, grads: torch.Tensor) -> None:
    if cams.dim() != 5 or cams.shape[-1] != cams.shape[-2]:
        raise RuntimeError(f"cams has shape {tuple(cams.shape)}, expected "
                           "[B, L, H, S, S]")
    S = cams.shape[-1]
    for name, t in (("cams", cams), ("grads", grads)):
        if t.dtype != torch.float32:
            raise RuntimeError(f"{name} is {t.dtype}; the chain kernels take "
                               "float32")
        if t.shape != cams.shape:
            raise RuntimeError(f"{name} has shape {tuple(t.shape)}, expected "
                               f"{tuple(cams.shape)}")
        if t.device != cams.device:
            raise RuntimeError(f"{name} is on {t.device}, expected "
                               f"{cams.device}")
        if t.stride()[-2:] != (S, 1):
            raise RuntimeError(f"{name} needs contiguous [S, S] planes "
                               f"(strides {t.stride()})")


def self_attention_relevancy_pallas(cams: torch.Tensor, grads: torch.Tensor,
                                    start_layer: int = 0) -> torch.Tensor:
    """Batched rule-6 chain, ``[B, L, H, S, S]`` ×2 → ``[B, S, S]``; the
    layers from ``start_layer`` on (a Python slice start, as in JAX).

    Replaces ``relevancy_pallas.self_attention_relevancy_pallas``
    (``_chain_kernel``). Bound by bytes: the captures are read once
    (2·B·L·H·S²·4 bytes) against 2·B·L·S³ chain FLOPs; one streaming head
    reduction into Ê for every layer, then per layer a batched tensor-core
    GEMM with a residual epilogue on rows padded to ``padded(S)`` (see the
    source note in the ``.cu`` file)."""
    if _build.on_cpu(cams):
        return self_attention_relevancy_pallas_plain(cams, grads, start_layer)
    _check(cams, grads)
    B, L, H, S, _ = cams.shape
    first = range(L)[start_layer:].start
    dev = cams.device
    if first == L:      # no layer to fold: R stays I, nothing is launched
        return torch.eye(S, device=dev, dtype=torch.float32).expand(
            B, S, S).contiguous()
    lib = library()
    Sp = padded(S)
    e = torch.empty((B, L - first, S, Sp), device=dev, dtype=torch.float32)
    r = torch.empty((2, B, Sp, Sp), device=dev,
                    dtype=torch.float32)            # set by the kernel
    strides = (ctypes.c_longlong * 6)(*cams.stride()[:3], *grads.stride()[:3])
    p = _build.ptr
    with _build.on_device(dev):
        _build.check(lib, "tmx_relevancy_chain", lib.tmx_relevancy_chain(
            p(cams), p(grads), p(e), p(r[0]), p(r[1]), strides, B, L, H, S,
            Sp, first, _build.stream(dev)))
    self_attention_relevancy_pallas.launches += 1
    return r[(L - first) % 2, :, :S, :S].contiguous()


def self_attention_relevancy_auto(cams_b: torch.Tensor, grads_b: torch.Tensor,
                                  start_layer: int = 0) -> torch.Tensor:
    """Dispatch, as the JAX ``self_attention_relevancy_auto`` does: CUDA
    tensors → the chain kernels; CPU tensors → the batched plain chain
    ``ops/relevancy.self_attention_relevancy``. Inputs batch-first
    ``[B, L, H, S, S]``."""
    return self_attention_relevancy_pallas(cams_b, grads_b, start_layer)


KERNELS = (self_attention_relevancy_pallas,)
for _fn in KERNELS:
    _fn.launches = 0


def launch_counts() -> Dict[str, int]:
    """CUDA launches of each wrapper since the last reset."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
