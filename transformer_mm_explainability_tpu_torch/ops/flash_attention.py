"""Fused attention for the relevancy pipeline: CUDA kernels, plain versions.

Counterpart of ``transformer_mm_explainability_tpu/ops/flash_attention.py``.
Four wrappers keep the JAX signatures, without ``interpret``:

  * ``flash_fwd(q, k, v)``: softmax(q·kᵀ/√dh)·v, q/k/v ``[B, H, S, dh]``;
  * ``flash_bwd_ehat(q, k, v, dout, r)`` → (dq, dk, dv, e_row), with the
    rule-6 fold ``e_row = r · mean_h relu(A ∘ dA)`` ``[B, S]``;
  * ``flash_fwd_qkv(qkv, nheads)``: the same in the merged layout,
    qkv ``[B, S, 3D]`` → ``[B, S, D]``;
  * ``flash_bwd_ehat_qkv(qkv, dout, r, nheads)`` → (dqkv ``[B, S, 3D]``,
    e_row).

Each takes ``fast_dots`` as the JAX wrappers do: with it, every operand of
every product is rounded to bf16 (to nearest even) and the products are
summed in fp32, while softmax, dsum and the fold stay fp32. The JAX
default is ``True``, on its chip only (``fast_dots and not interpret``);
the port's is ``False``, so that its default path holds the fp32 CPU run
at fp32 accuracy. Tensors are float32 or bfloat16, with or without
``fast_dots`` (bfloat16 with ``fast_dots`` is the JAX bench's throughput
mode): the kernels upcast them on load and write the outputs in their
dtype, e_row in float32. bfloat16 without ``fast_dots`` is bf16 storage
with fp32 products, as the JAX kernels compute it: the fp32 kernels read
and write bf16 themselves (no widened copy) and give, bit for bit, their
result on the widened tensors, rounded once.

A tensor on the CPU goes to the plain PyTorch version beside each wrapper
(``*_plain``, with the same ``fast_dots``). A CUDA tensor goes to the
attention kernels of ``csrc/attn_block.cu`` (fp32 products) or, with
``fast_dots``, of ``csrc/attn_block_bf16.cu`` (bf16 products), or the
wrapper raises: there is no fallback. This module launches those kernels
for every caller:
``attn_fwd_launch`` / ``attn_fwd_launch_qkv`` / ``attn_bwd_launch`` and
``ensure_attention`` below also serve the block wrappers of
``ops/attn_block``. The kernels take every operand as a base pointer plus
(batch, head, row) strides, so the per-head wrappers accept any
``[B, H, S, dh]`` view whose dh axis is contiguous (split-head views of a
merged qkv tensor included, without a copy), and the qkv wrappers pass
split-head views of their merged tensors. A is never stored. The fp32
kernels run both directions on the tensor cores as 3xTF32 ``mma.sync``
products (fp32 accuracy: split operands, no TF32 switch anywhere) over
tiles streamed by ``cp.async``; the bf16 kernels both directions as
``wgmma`` products over tiles that TMA copies. The fp32 forward keeps an
online softmax over key tiles. The bf16 forward rounds A after its
normalisation, as the JAX body does: where a row's scores fit the
accumulators (S ≤ 256) it computes them once and takes the row statistics
from registers, past that it takes the statistics in a first sweep over
the keys. The fp32 backward runs two passes that recompute A from q and
k: a q pass (online row statistics, then dq) and a kv pass (dk, dv and
the per-head fold). The bf16 backward (``_bwd16``) runs a statistics pass,
a key-major pass (dk, dv, the fold and each 64-key tile's partial dq) and
a pass that sums the partials in key order and the fold over heads. In
both bf16 directions, operands that TMA cannot read in place (float32,
rows off the 16-byte grid) are packed first (``tma_packs``). No direction
uses atomics, splits a sum across blocks in an order set by timing, or
depends on the layout: the same inputs give the same bits, whatever their
layout. All keep shared memory bounded by dh, so they take any S. Each
wrapper counts its CUDA
launches in ``launches`` (the fp32 kernels) and ``launches_bf16`` (the
bf16-product kernels); see ``launch_counts`` and ``bf16_launch_counts``.

Before launch a wrapper rejects any other dtype, a head dim above
``tmx_max_dh()`` (128), and a block that needs more shared memory than
one block may opt in to on the device.

The JAX module groups heads into 128-lane spans per program
(``_heads_per_program``), a TPU layout rule; it has no counterpart here:
each CUDA block takes one head of one image.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Tuple

import torch

from transformer_mm_explainability_tpu_torch.ops import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {  # the attention entry points of csrc/attn_block.cu
    "tmx_attn_fwd": [_P] * 5 + [_I, _I, _I, _I, _F, _I, _I, _P],
    "tmx_attn_bwd": [_P] * 12 + [_I, _I, _I, _I, _F, _I, _I, _P],
    "tmx_attn_smem": [_I, _I, _I],
    "tmx_smem_optin": [],
    "tmx_max_dh": [],
}
_SIGNATURES_BF16 = {  # ... and of csrc/attn_block_bf16.cu
    "tmx_attn_fwd_bf16": [_P] * 6 + [_I, _I, _I, _I, _F, _I, _P],
    "tmx_attn_bwd_bf16": [_P] * 14 + [_I, _I, _I, _I, _F, _I, _P],
    "tmx_attn_bwd_bf16_keys": [_I, _I, _I],
    "tmx_attn_bwd_bf16_force_keys": [_I],
    "tmx_attn_smem_bf16": [_I, _I, _I],
    "tmx_smem_optin": [],
    "tmx_max_dh": [],
}
_libs: Dict[bool, ctypes.CDLL] = {}


def library(fast_dots: bool = False) -> ctypes.CDLL:
    """The built and loaded ``csrc/attn_block.cu`` or, with ``fast_dots``,
    ``csrc/attn_block_bf16.cu`` (built on first call), with its attention
    entry points declared."""
    lib = _libs.get(fast_dots)
    if lib is None:
        lib = _libs[fast_dots] = (
            _build.load("attn_block_bf16", _SIGNATURES_BF16) if fast_dots
            else _build.load("attn_block", _SIGNATURES))
    return lib


def heads(x: torch.Tensor, nheads: int) -> torch.Tensor:
    """Merged [B, S, D] → a [B, H, S, D/H] view (``view`` raises rather
    than copy)."""
    B, S, D = x.shape
    return x.view(B, S, nheads, D // nheads).transpose(1, 2)


def qkv_heads(qkv: torch.Tensor, nheads: int):
    """[B, S, 3D] → (q, k, v), each a [B, H, S, dh] view."""
    B, S, D3 = qkv.shape
    return qkv.view(B, S, 3, nheads, D3 // (3 * nheads)).permute(
        2, 0, 3, 1, 4).unbind(0)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the arithmetic of the Pallas bodies)
# ---------------------------------------------------------------------------

def upcast(t: torch.Tensor) -> torch.Tensor:
    """A stored tensor as the kernels read it: bfloat16 upcast to float32,
    float32 (and the gates' float64) as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def operand(t: torch.Tensor, fast_dots: bool) -> torch.Tensor:
    """A product operand: under ``fast_dots`` rounded to bfloat16 (to
    nearest, ties to even, as XLA's ``astype`` and the kernels round) and
    back, so that the product of two operands is exact and only the sum is
    fp32; else as it is."""
    return t.to(torch.bfloat16).to(t.dtype) if fast_dots else t


def _probs(q, k, fast_dots: bool = False):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = operand(q, fast_dots) @ operand(k, fast_dots).transpose(-1, -2)
    return torch.softmax(s * scale, dim=-1)


def flash_fwd_plain(q, k, v, fast_dots: bool = False):
    dtype = q.dtype
    q, k, v = map(upcast, (q, k, v))
    out = operand(_probs(q, k, fast_dots), fast_dots) @ operand(v, fast_dots)
    return out.to(dtype)


def flash_bwd_ehat_plain(q, k, v, dout, r, fast_dots: bool = False):
    dtype = q.dtype
    q, k, v, dout, r = map(upcast, (q, k, v, dout, r))
    op = lambda t: operand(t, fast_dots)
    scale = 1.0 / math.sqrt(q.shape[-1])
    a = _probs(q, k, fast_dots)                         # [B, H, S, S]
    da = op(dout) @ op(v).transpose(-1, -2)             # ∇A
    p = a * da
    ds = a * (da - p.sum(dim=-1, keepdim=True)) * scale
    ead = torch.clamp(p, min=0.0).mean(dim=1)           # Ê = mean_h relu
    e_row = torch.einsum("bq,bqk->bk", r, ead)
    grads = (op(ds) @ op(k), op(ds).transpose(-1, -2) @ op(q),
             op(a).transpose(-1, -2) @ op(dout))
    return (*(g.to(dtype) for g in grads), e_row)


def flash_fwd_qkv_plain(qkv, nheads: int, fast_dots: bool = False):
    B, S, _ = qkv.shape
    out = flash_fwd_plain(*qkv_heads(qkv, nheads), fast_dots=fast_dots)
    return out.transpose(1, 2).reshape(B, S, -1)


def flash_bwd_ehat_qkv_plain(qkv, dout, r, nheads: int,
                             fast_dots: bool = False):
    B, S, _ = qkv.shape
    *grads, e_row = flash_bwd_ehat_plain(*qkv_heads(qkv, nheads),
                                         heads(dout, nheads), r,
                                         fast_dots=fast_dots)
    merged = [g.transpose(1, 2).reshape(B, S, -1) for g in grads]
    return torch.cat(merged, dim=-1), e_row


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------

def storage_dtype(t: torch.Tensor, fast_dots: bool) -> torch.dtype:
    """The storage dtype of a CUDA call: float32 or bfloat16, with either
    value of ``fast_dots`` (fp32 products of bf16 storage without it, the
    JAX kernels' upcast on load); raise on anything else."""
    if t.dtype in (torch.float32, torch.bfloat16):
        return t.dtype
    raise RuntimeError(f"the kernels take float32 or bfloat16 tensors, not "
                       f"{t.dtype}")


def _check(device, shape, dtype=torch.float32, **tensors) -> None:
    """Each keyword is a tensor the kernels read or write through strides:
    it must have ``shape``, lie on ``device``, be of ``dtype`` and have a
    contiguous last axis."""
    for name, t in tensors.items():
        if t.dtype != dtype:
            raise RuntimeError(f"{name} is {t.dtype}; this call of the "
                               f"attention kernels takes {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise RuntimeError(f"{name} has shape {tuple(t.shape)}, "
                               f"expected {tuple(shape)}")
        if t.device != device:
            raise RuntimeError(f"{name} is on {t.device}, expected {device}")
        if t.stride(-1) != 1:
            raise RuntimeError(f"{name} needs a contiguous last axis "
                               f"(strides {t.stride()})")


def _heads_shape(q) -> Tuple[int, ...]:
    if q.dim() != 4:
        raise RuntimeError(f"q has shape {tuple(q.shape)}, expected "
                           "[B, H, S, dh]")
    return tuple(q.shape)


def _check_r(device, r, B: int, S: int) -> None:
    _check(device, (B, S), r=r)
    if not r.is_contiguous():
        raise RuntimeError("r must be contiguous")


def check_attention(lib, S: int, dh: int, backward: bool,
                    fast_dots: bool = False) -> None:
    """Raise, before launch, on a head dim or sequence length the attention
    kernels cannot take: dh above ``tmx_max_dh``, or a block that needs
    more shared memory than one block may opt in to on this device (the
    library reports the need of each direction for S and dh)."""
    if dh > lib.tmx_max_dh():
        raise RuntimeError(f"head dim {dh} > {lib.tmx_max_dh()} is not "
                           "supported by the attention kernels")
    smem = lib.tmx_attn_smem_bf16 if fast_dots else lib.tmx_attn_smem
    need, limit = smem(S, dh, int(backward)), lib.tmx_smem_optin()
    if need > limit:
        raise RuntimeError(
            f"sequence length {S} at head dim {dh} needs {need} bytes of "
            f"shared memory per block for the attention "
            f"{'backward' if backward else 'forward'}; this device allows "
            f"{limit}")


_accepted = set()   # (S, dh, backward, fast_dots, device) that passed


def ensure_attention(S: int, dh: int, backward: bool, device,
                     fast_dots: bool = False) -> None:
    """``check_attention`` on the built library for ``device``, asked once
    per (S, dh, backward, fast_dots, device): its answer depends on nothing
    else."""
    key = (S, dh, backward, fast_dots, device)
    if key in _accepted:
        return
    with _build.on_device(device):
        check_attention(library(fast_dots), S, dh, backward, fast_dots)
    _accepted.add(key)
def _stride_array(flat) -> ctypes.Array:
    """(batch, head, row) element strides, operand after operand, for the
    kernels, which hold a row stride in 32 bits."""
    for row in flat[2::3]:
        if not 0 <= row < 2 ** 31:
            raise RuntimeError(f"row stride {row} does not fit the "
                               "attention kernels' 32-bit row offsets")
    return (ctypes.c_longlong * len(flat))(*flat)


def view_args(*views):
    """(pointers, strides) of [B, H, S, dh] views: each view's data
    pointer, and its (batch, head, row) element strides, view after view."""
    return ([t.data_ptr() for t in views],
            [s for t in views for s in t.stride()[:3]])


def copy_width(dh: int, pointers, strides, per: int = 4) -> int:
    """Width in bytes of the fp32-product kernels' copies for the operands
    they read (q, k, v and, backward, dout: their pointers and strides, as
    ``view_args`` gives them): 16 where dh is a multiple of ``per``, every
    pointer is 16-byte aligned and every stride a multiple of ``per``
    elements, so that every row starts on a 16-byte boundary; else 4 (a
    copy of one element). ``per``: the elements of a 16-byte copy, 4 fp32
    or 8 bf16 (``elements_per_copy``). The merged layouts of the model
    paths take 16."""
    if dh % per or any(p % 16 for p in pointers) or any(s % per
                                                         for s in strides):
        return 4
    return 16


def elements_per_copy(t: torch.Tensor) -> int:
    """Elements of ``t``'s dtype in one 16-byte copy: 4 float32, 8 bf16."""
    return 16 // t.element_size()


def qkv_args(qkv, out, nheads: int):
    """``view_args`` of the split-head views of a merged qkv [B, S, 3D] and
    output [B, S, D] (``qkv_heads`` and ``heads``), computed without making
    the views."""
    D = out.shape[-1]
    dh = D // nheads
    base, (bq, sq, _), (bo, so, _) = qkv.data_ptr(), qkv.stride(), out.stride()
    size = qkv.element_size()
    return ([base, base + D * size, base + 2 * D * size, out.data_ptr()],
            [bq, dh, sq] * 3 + [bo, dh, so])


def tma_packs(B: int, H: int, S: int, dh: int, bf16: bool, pointers,
              strides) -> Tuple[bool, ...]:
    """Which operands of a bf16 attention kernel (their pointers and
    (batch, head, row) element strides, as ``view_args`` gives them) TMA
    cannot read in place and the kernels pack (round to bf16 into an
    aligned [B, H, S, dh8] slot): an operand is read in place where it is
    bfloat16 and every row starts on a 16-byte boundary (dh a multiple of
    8, the pointer and the strides of dimensions longer than 1 aligned: the
    rule of the C side's ``attn16_in_place``), else it is packed."""
    packs = []
    for i, ptr in enumerate(pointers):
        sb, sh, ss = strides[3 * i:3 * i + 3]
        packs.append(not (
            bf16 and dh % 8 == 0 and ptr % 16 == 0
            and (B == 1 or sb % 8 == 0) and (H == 1 or sh % 8 == 0)
            and (S == 1 or ss % 8 == 0)))
    return tuple(packs)


class Fwd16Plan(NamedTuple):
    """What one call of the bf16 forward (``tmx_attn_fwd_bf16``) needs
    beside its tensors: which of q, k, v the kernels pack, and the packed
    slots' size in bfloat16 elements."""
    packs: Tuple[bool, bool, bool]
    packed: int     # one [B, H, S, dh8] slot per packed operand


def fwd16_plan(B: int, H: int, S: int, dh: int, bf16: bool, pointers,
               strides) -> Fwd16Plan:
    """The plan of ``tmx_attn_fwd_bf16`` for q, k, v (``tma_packs``; the
    size follows the C side's comment on ``tmx_attn_fwd_bf16``)."""
    packs = tma_packs(B, H, S, dh, bf16, pointers[:3], strides[:9])
    return Fwd16Plan(packs=packs,
                     packed=sum(packs) * B * H * S * (-(-dh // 8) * 8))


def _fwd(pointers, strides, B: int, S: int, H: int, dh: int, stream,
         fast_dots: bool, bf16: bool, device) -> None:
    lib = library(fast_dots)
    if not fast_dots:
        _build.check(lib, "tmx_attn_fwd", lib.tmx_attn_fwd(
            *pointers, _stride_array(strides), B, S, H, dh,
            1.0 / math.sqrt(dh), int(bf16),
            copy_width(dh, pointers[:3], strides[:9], 8 if bf16 else 4),
            stream))
        return
    plan = fwd16_plan(B, H, S, dh, bf16, pointers, strides)
    packed = None
    if plan.packed:
        scratch = torch.empty(plan.packed, device=device,
                              dtype=torch.bfloat16)
        packed = scratch.data_ptr()
        n = sum(plan.packs)
        if bf16:
            attn_fwd_launch.copies += n
        else:
            attn_fwd_launch.rounded += n
    _build.check(lib, "tmx_attn_fwd_bf16", lib.tmx_attn_fwd_bf16(
        *pointers, packed, _stride_array(strides), B, S, H, dh,
        1.0 / math.sqrt(dh), int(bf16), stream))


def attn_fwd_launch(q, k, v, out, stream, fast_dots: bool = False) -> None:
    """softmax(q·kᵀ/√dh)·v into ``out`` on ``stream``; all four are
    [B, H, S, dh] views of one dtype with unit stride along dh, and S and dh
    passed ``check_attention`` (both checked by the caller). The fp32
    kernel reads and writes float32 or bfloat16 storage and picks its copy
    width from q, k and v (``copy_width``); with
    ``fast_dots`` the bf16-product kernel runs on ``wgmma`` and TMA, on
    float32 or bfloat16 storage: operands TMA cannot read in place are
    packed first (``fwd16_plan``), counted in ``attn_fwd_launch.copies``
    (bfloat16 ones) and ``.rounded`` (float32 ones)."""
    B, H, S, dh = q.shape
    _fwd(*view_args(q, k, v, out), B, S, H, dh, stream, fast_dots,
         q.dtype == torch.bfloat16, q.device)


def attn_fwd_launch_qkv(qkv, out, nheads: int, stream,
                        fast_dots: bool = False) -> None:
    """``attn_fwd_launch`` on the split-head views of a merged qkv
    [B, S, 3D] and output [B, S, D] (``qkv_args``): the same launch,
    without making six views per call."""
    B, S, D = out.shape
    _fwd(*qkv_args(qkv, out, nheads), B, S, nheads, D // nheads, stream,
         fast_dots, qkv.dtype == torch.bfloat16, qkv.device)


class Bwd16Plan(NamedTuple):
    """What one call of the bf16 backward (``tmx_attn_bwd_bf16``) needs
    beside its tensors: which of q, k, v, dout TMA cannot read in place and
    the kernels pack (round to bf16 into an aligned slot), and the scratch,
    in float32 elements (``packed``: bfloat16 elements)."""
    packs: Tuple[bool, bool, bool, bool]
    s_pad: int      # S rounded up to the 64-row tiles
    n_sub: int      # 64-key sub-tiles: partial dq sums of one query
    dp: int         # dq partial row: dh padded to 64 or 128
    stats: int      # (m, 1/l, dsum, r) per query, [B, H, s_pad, 4]
    dq_part: int    # [n_sub, B, H, s_pad, dp]
    e_part: int     # [B, H, S], rounded up to 64 (alignment)
    packed: int     # one [B, H, S, dh8] slot per packed operand


def bwd16_plan(B: int, H: int, S: int, dh: int, bf16: bool, pointers,
               strides) -> Bwd16Plan:
    """The plan of ``tmx_attn_bwd_bf16`` for q, k, v, dout (their pointers
    and (batch, head, row) element strides, as ``view_args`` gives them):
    the packed operands by ``tma_packs``; the sizes follow the C side's
    comment on ``tmx_attn_bwd_bf16``."""
    packs = tma_packs(B, H, S, dh, bf16, pointers[:4], strides[:12])
    n_sub = -(-S // 64)
    s_pad, dp, dh8 = 64 * n_sub, 64 if dh <= 64 else 128, -(-dh // 8) * 8
    return Bwd16Plan(
        packs=packs, s_pad=s_pad, n_sub=n_sub, dp=dp,
        stats=B * H * s_pad * 4, dq_part=n_sub * B * H * s_pad * dp,
        e_part=-(-B * H * S // 64) * 64,
        packed=sum(packs) * B * H * S * dh8)


def _bwd16(lib, q, k, v, dout, r, dq, dk, dv, stream) -> torch.Tensor:
    """``tmx_attn_bwd_bf16`` with its scratch carved from one allocation;
    counts the packed operands (``copies``: bfloat16 ones moved to an
    aligned slot; ``rounded``: float32 ones) and the calls whose dq went
    through the partial sums (``dq_partial_sums``, every call: the one
    route) on ``attn_bwd_launch``."""
    B, H, S, dh = q.shape
    pointers, strides = view_args(q, k, v, dout, dq, dk, dv)
    bf16 = q.dtype == torch.bfloat16
    plan = bwd16_plan(B, H, S, dh, bf16, pointers[:4], strides[:12])
    work = torch.empty(plan.stats + plan.dq_part + plan.e_part
                       + -(-plan.packed // 2), device=q.device,
                       dtype=torch.float32)
    at = work.data_ptr()
    stats, dq_part = at, at + 4 * plan.stats
    e_part = dq_part + 4 * plan.dq_part
    packed = e_part + 4 * plan.e_part if plan.packed else None
    e_row = torch.empty((B, S), device=q.device, dtype=torch.float32)
    _build.check(lib, "tmx_attn_bwd_bf16", lib.tmx_attn_bwd_bf16(
        *pointers[:4], r.data_ptr(), *pointers[4:], stats, e_part, dq_part,
        packed, e_row.data_ptr(), _stride_array(strides), B, S, H, dh,
        1.0 / math.sqrt(dh), int(bf16), stream))
    n = sum(plan.packs)
    if bf16:
        attn_bwd_launch.copies += n
    else:
        attn_bwd_launch.rounded += n
    attn_bwd_launch.dq_partial_sums += 1
    return e_row


def attn_bwd_launch(q, k, v, dout, r, dq, dk, dv, stream,
                    fast_dots: bool = False) -> torch.Tensor:
    """Attention backward into (dq, dk, dv) and the fold
    e_row = r · mean_h relu(A∘dA), returned [B, S] float32; q … dv are
    [B, H, S, dh] views of one dtype with unit stride along dh, r is
    [B, S] float32 contiguous (checked by the caller, as for
    ``attn_fwd_launch``). The fp32 kernels read and write float32 or
    bfloat16 storage and pick their copy width from q, k, v and dout
    (``copy_width``); with ``fast_dots`` the bf16-product kernels run
    (``_bwd16``), on float32 or bfloat16 storage."""
    lib = library(fast_dots)
    if fast_dots:
        return _bwd16(lib, q, k, v, dout, r, dq, dk, dv, stream)
    B, H, S, dh = q.shape
    dev = q.device
    stats = torch.empty((3, B, H, S), device=dev, dtype=torch.float32)
    e_part = torch.empty((B, H, S), device=dev, dtype=torch.float32)
    e_row = torch.empty((B, S), device=dev, dtype=torch.float32)
    pointers, strides = view_args(q, k, v, dout, dq, dk, dv)
    p = _build.ptr
    _build.check(lib, "tmx_attn_bwd", lib.tmx_attn_bwd(
        *pointers[:4], p(r), *pointers[4:], p(stats), p(e_part), p(e_row),
        _stride_array(strides), B, S, H, dh, 1.0 / math.sqrt(dh),
        int(q.dtype == torch.bfloat16),
        copy_width(dh, pointers[:4], strides[:12], elements_per_copy(q)),
        stream))
    return e_row


def _count(fn, fast_dots: bool) -> None:
    if fast_dots:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              fast_dots: bool = False) -> torch.Tensor:
    """softmax(q·kᵀ/√dh)·v without storing A. q, k, v: [B, H, S, dh] (any
    strides with a contiguous dh axis), float32 or bfloat16. Returns a new
    contiguous [B, H, S, dh] of q's dtype.

    Replaces ``flash_attention.flash_fwd`` (``_fwd_kernel``). Bound by
    operations (4·B·H·S²·dh). fp32: both products run on the tensor cores
    as 3xTF32 ``mma.sync`` at fp32 accuracy; one block of 4 warps per
    (64-query tile, head, image) keeps Q in shared memory, streams K and V
    in 32-key ``cp.async`` tiles and keeps an online softmax per row, so any
    S fits. ``fast_dots``: bf16 ``wgmma`` products on tiles that TMA
    copies, A rounded to bf16 after its normalisation: up to S = 256 one
    sweep (q·kᵀ once, the row statistics from the accumulators, A·v with A
    from registers; a block per 64-query tile), past it two (the
    statistics, then q·kᵀ again and A·v: 6·B·H·S²·dh flops); see
    ``csrc/attn_block_bf16.cu``."""
    if _build.on_cpu(q):
        return flash_fwd_plain(q, k, v, fast_dots)
    dtype = storage_dtype(q, fast_dots)
    _check(q.device, _heads_shape(q), dtype, q=q, k=k, v=v)
    B, H, S, dh = q.shape
    out = torch.empty(q.shape, device=q.device, dtype=dtype)
    ensure_attention(S, dh, False, q.device, fast_dots)
    with _build.on_device(q.device):
        attn_fwd_launch(q, k, v, out, _build.stream(q.device), fast_dots)
    _count(flash_fwd, fast_dots)
    return out


def flash_bwd_ehat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   dout: torch.Tensor, r: torch.Tensor,
                   fast_dots: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Attention backward fused with the relevancy-row fold.

    q, k, v, dout: [B, H, S, dh] (any strides with a contiguous dh axis),
    float32 or bfloat16; r: [B, S] float32. Returns
    (dq, dk, dv [B, H, S, dh] contiguous, of q's dtype, e_row [B, S]
    float32) with ``e_row = r · mean_h relu(A ∘ dA)``.

    Replaces ``flash_attention.flash_bwd_ehat`` (``_bwd_kernel``). Bound by
    operations (10·B·H·S²·dh for the function's five products), all of
    them run on the tensor cores. fp32: 3xTF32 ``mma.sync`` in a q pass
    (the online row statistics, then dq), a kv pass (A recomputed from the
    saved row max and 1/sum, dk, dv, the per-head fold) and a fixed-order
    sum over heads. ``fast_dots``: bf16 ``wgmma`` on TMA-copied tiles in a
    statistics pass, a key-major pass (dk, dv, the fold, partial dq per
    64 keys) and a pass summing the partials and the heads in a fixed
    order (7·B·H·S²·dh products' worth, see ``csrc/attn_block_bf16.cu``).
    Shared memory is fixed by dh, so any S fits."""
    if _build.on_cpu(q):
        return flash_bwd_ehat_plain(q, k, v, dout, r, fast_dots)
    B, H, S, dh = _heads_shape(q)
    dtype = storage_dtype(q, fast_dots)
    _check(q.device, q.shape, dtype, q=q, k=k, v=v, dout=dout)
    _check_r(q.device, r, B, S)
    dq, dk, dv = (torch.empty(q.shape, device=q.device, dtype=dtype)
                  for _ in range(3))
    ensure_attention(S, dh, True, q.device, fast_dots)
    with _build.on_device(q.device):
        e_row = attn_bwd_launch(q, k, v, dout, r, dq, dk, dv,
                                _build.stream(q.device), fast_dots)
    _count(flash_bwd_ehat, fast_dots)
    return dq, dk, dv, e_row


def flash_fwd_qkv(qkv: torch.Tensor, nheads: int,
                  fast_dots: bool = False) -> torch.Tensor:
    """qkv [B, S, 3D] (the fused projection's output) → attention output
    [B, S, D] in the merged-head layout, with no transposes.

    Replaces ``flash_attention.flash_fwd_qkv`` (``_fwd_kernel2``): the
    tensor-core kernel of ``flash_fwd`` on split-head views of qkv and of
    the output (fp32: 16-byte copies where dh is a multiple of 4, the
    merged layout then aligning every head's rows); the same bits as
    ``flash_fwd`` on those views, with and without ``fast_dots``."""
    if _build.on_cpu(qkv):
        return flash_fwd_qkv_plain(qkv, nheads, fast_dots)
    B, S, D3 = qkv.shape
    if D3 % (3 * nheads):
        raise RuntimeError(f"qkv width {D3} is not 3 × {nheads} heads")
    D = D3 // 3
    dtype = storage_dtype(qkv, fast_dots)
    _check(qkv.device, (B, S, D3), dtype, qkv=qkv)
    out = torch.empty((B, S, D), device=qkv.device, dtype=dtype)
    ensure_attention(S, D // nheads, False, qkv.device, fast_dots)
    with _build.on_device(qkv.device):
        attn_fwd_launch_qkv(qkv, out, nheads, _build.stream(qkv.device),
                            fast_dots)
    _count(flash_fwd_qkv, fast_dots)
    return out


def flash_bwd_ehat_qkv(qkv: torch.Tensor, dout: torch.Tensor,
                       r: torch.Tensor, nheads: int, fast_dots: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of ``flash_fwd_qkv`` fused with the relevancy-row fold.
    qkv [B, S, 3D]; dout [B, S, D] (the cotangent in merged layout), both
    float32 or both bfloat16; r [B, S] float32. Returns
    (dqkv [B, S, 3D] of qkv's dtype, e_row [B, S] float32).

    Replaces ``flash_attention.flash_bwd_ehat_qkv`` (``_bwd_kernel2``): the
    kernels of ``flash_bwd_ehat`` on split-head views."""
    if _build.on_cpu(qkv):
        return flash_bwd_ehat_qkv_plain(qkv, dout, r, nheads, fast_dots)
    B, S, D3 = qkv.shape
    if D3 % (3 * nheads):
        raise RuntimeError(f"qkv width {D3} is not 3 × {nheads} heads")
    dtype = storage_dtype(qkv, fast_dots)
    _check(qkv.device, (B, S, D3), dtype, qkv=qkv)
    _check(qkv.device, (B, S, D3 // 3), dtype, dout=dout)
    _check_r(qkv.device, r, B, S)
    dqkv = torch.empty((B, S, D3), device=qkv.device, dtype=dtype)
    ensure_attention(S, D3 // (3 * nheads), True, qkv.device, fast_dots)
    with _build.on_device(qkv.device):
        e_row = attn_bwd_launch(*qkv_heads(qkv, nheads), heads(dout, nheads),
                                r, *qkv_heads(dqkv, nheads),
                                _build.stream(qkv.device), fast_dots)
    _count(flash_bwd_ehat_qkv, fast_dots)
    return dqkv, e_row


KERNELS = (flash_fwd, flash_bwd_ehat, flash_fwd_qkv, flash_bwd_ehat_qkv)
for _fn in KERNELS:
    _fn.launches = _fn.launches_bf16 = 0
attn_bwd_launch.copies = attn_bwd_launch.rounded = 0
attn_bwd_launch.dq_partial_sums = 0
attn_fwd_launch.copies = attn_fwd_launch.rounded = 0


def launch_counts() -> Dict[str, int]:
    """CUDA launches of each wrapper's fp32 kernels since the last reset."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def bf16_launch_counts() -> Dict[str, int]:
    """CUDA launches of each wrapper's bf16-product kernels (``fast_dots``)
    since the last reset, as ``<wrapper>_bf16``."""
    return {f"{fn.__name__}_bf16": fn.launches_bf16 for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = fn.launches_bf16 = 0
    attn_bwd_launch.copies = attn_bwd_launch.rounded = 0
    attn_bwd_launch.dq_partial_sums = 0
    attn_fwd_launch.copies = attn_fwd_launch.rounded = 0
