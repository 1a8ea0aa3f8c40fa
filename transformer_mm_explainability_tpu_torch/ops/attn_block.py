"""The ViT block's residual branches as CUDA kernels, with plain versions.

Counterpart of ``transformer_mm_explainability_tpu/ops/attn_block_pallas.py``.
Four wrappers keep the JAX signatures:

  * ``attn_block_fwd``:  x → x + proj(attn(LN1(x)))               (x_mid)
  * ``mlp_block_fwd``:   x_mid → x_mid + GELU(LN2(x_mid)·W1+b1)·W2+b2
  * ``mlp_block_bwd``:   (x_mid, cot_out) → cot_mid, a1 recomputed
  * ``attn_block_bwd``:  (x, cot_mid, r) → (cot_x, e_row), with the rule-6
    fold ``e_row = r · mean_h relu(A ∘ ∇A)``

A tensor on the CPU goes to the plain PyTorch version beside each wrapper
(``*_plain``). A CUDA tensor goes to the hand-written kernels of
``csrc/attn_block.cu`` (built by ``ops/_build.py`` at first use), or the
wrapper raises: there is no fallback. Each wrapper counts its CUDA
launches in ``launches`` (see ``launch_counts``).

The attention step of the two attention blocks goes through
``ops/flash_attention`` (``attn_fwd_launch_qkv`` / ``attn_bwd_launch`` on
split-head views of the qkv buffer), which launches the attention kernels
of the same library for every caller.

LN statistics, softmax, GELU, the residual adds and the relevancy fold
are fp32. The products are fp32 (3xTF32 on the tensor cores) or, with
``fast_dots`` as in the JAX wrappers, bf16 products summed in fp32: every
operand, weights and intermediates alike, rounded to bf16 to nearest even.
The JAX default is ``fast_dots=True`` on its chip only; the port's is
``False``. Tensors are float32, or all bfloat16 (x, the cotangent, the
weights, the biases and the LN parameters; r stays float32): the kernels
upcast them on load and write x_mid, x_out, cot_mid and cot_x in their
dtype, e_row in float32. bfloat16 with ``fast_dots`` is the JAX bench's
throughput mode; without it, bf16 storage with fp32 products, as the JAX
kernels compute it: the fp32 kernels of ``csrc/attn_block.cu`` read and
write bf16 themselves (no widened copy of any operand; their bf16
instances are compiled in ``csrc/attn_block_s16.cu``), keep every
intermediate (LN outputs, qkv, the merged output, a1, dqkv) in float32 and
give, bit for bit, their result on the widened tensors, rounded once.
With ``fast_dots`` the wrappers launch the kernels of
``csrc/attn_block_bf16.cu`` (its LayerNorm rows, the bf16-product GEMM of
``csrc/gemm_bf16.cuh`` on ``wgmma`` and TMA, and its attention), and count
them in ``launches_bf16`` (see ``bf16_launch_counts``); the intermediates
that are only ever product operands (LN outputs, qkv, the merged attention
output, the GELU output, dqkv) are stored rounded to bf16, which is what
the JAX bodies multiply. Weights are ``[in, out]`` as in the JAX package.
``chunks`` is validated as the JAX wrappers do (``I % chunks == 0``); the
CUDA MLP kernels do not chunk the hidden dim but hold the whole
``[B*S, I]`` activation in device memory (see the source note in the
``.cu`` file).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from transformer_mm_explainability_tpu_torch.ops import _build
from transformer_mm_explainability_tpu_torch.ops import flash_attention as fa
from transformer_mm_explainability_tpu_torch.ops.attention import (
    gelu, merge_heads, split_heads)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {  # the LN and GEMM entry points (attention: flash_attention)
    "tmx_layer_norm": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    "tmx_layer_norm_vjp": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "tmx_gemm": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _L, _L,
                 _L, _I, _P],
    "tmx_gemm_warps": [_I, _I, _I],
}
_SIGNATURES_BF16 = {  # ... and of csrc/attn_block_bf16.cu
    "tmx_layer_norm_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    "tmx_layer_norm_vjp_any": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "tmx_gemm_bf16": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I,
                      _L, _L, _L, _P],
    "tmx_gemm_bf16_tile": [_I, _I, _I],
    "tmx_gemm_bf16_force_tile": [_I],
    "tmx_round_bf16": [_P, _P, _L, _P],
}
_ACT_NONE, _ACT_GELU, _ACT_MUL_GELU_GRAD = 0, 1, 2
# the bits of tmx_gemm's and tmx_gemm_bf16's dtypes: which of their tensors
# are bfloat16
_BF16_BITS = {"a": 1, "b": 2, "out": 4, "bias": 8, "res": 16}
_ptr = _build.ptr


def library(fast_dots: bool = False) -> ctypes.CDLL:
    """The built and loaded ``csrc/attn_block.cu`` or, with ``fast_dots``,
    ``csrc/attn_block_bf16.cu`` (built on first call), with its LN and GEMM
    entry points declared."""
    if fast_dots:
        return _build.load("attn_block_bf16", _SIGNATURES_BF16)
    return _build.load("attn_block", _SIGNATURES)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the arithmetic of the Pallas bodies)
# ---------------------------------------------------------------------------

def _ln_fwd(x, scale, bias, eps):
    """LayerNorm keeping (x̂, 1/σ) for the VJP."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xh = (x - mu) * inv
    return xh * scale + bias, xh, inv


def _ln_vjp(dy, scale, xh, inv):
    """dx of y = x̂·γ + β."""
    g = dy * scale
    gm = g.mean(dim=-1, keepdim=True)
    gx = (g * xh).mean(dim=-1, keepdim=True)
    return inv * (g - gm - xh * gx)


def _gelu_grad(x):
    """d/dx of the exact GELU: Φ(x) + x·φ(x)."""
    cdf = 0.5 * (1.0 + torch.erf(x * 2.0 ** -0.5))
    return cdf + x * torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def attn_block_fwd_plain(x, w_qkv, b_qkv, w_out, b_out, ln_scale, ln_bias,
                         nheads: int, eps: float = 1e-6,
                         fast_dots: bool = False):
    dtype, D = x.dtype, x.shape[-1]
    x, w_qkv, b_qkv, w_out, b_out, ln_scale, ln_bias = map(
        fa.upcast, (x, w_qkv, b_qkv, w_out, b_out, ln_scale, ln_bias))
    op = lambda t: fa.operand(t, fast_dots)
    scale = 1.0 / math.sqrt(D // nheads)
    h1, _, _ = _ln_fwd(x, ln_scale, ln_bias, eps)
    q, k, v = (split_heads(t, nheads)
               for t in (op(h1) @ op(w_qkv) + b_qkv).split(D, dim=-1))
    a = torch.softmax((op(q) @ op(k).transpose(-1, -2)) * scale, dim=-1)
    merged = merge_heads(op(a) @ op(v))
    return (x + op(merged) @ op(w_out) + b_out).to(dtype)


def mlp_block_fwd_plain(x_mid, w1, b1, w2, b2, ln_scale, ln_bias,
                        eps: float = 1e-6, chunks: int = 8,
                        fast_dots: bool = False):
    _check_chunks(w1.shape[1], chunks)
    dtype = x_mid.dtype
    x_mid, w1, b1, w2, b2, ln_scale, ln_bias = map(
        fa.upcast, (x_mid, w1, b1, w2, b2, ln_scale, ln_bias))
    op = lambda t: fa.operand(t, fast_dots)
    h2, _, _ = _ln_fwd(x_mid, ln_scale, ln_bias, eps)
    g = gelu(op(h2) @ op(w1) + b1)
    return (x_mid + op(g) @ op(w2) + b2).to(dtype)


def mlp_block_bwd_plain(x_mid, cot_out, w1, b1, w2, ln_scale, ln_bias,
                        eps: float = 1e-6, chunks: int = 8,
                        fast_dots: bool = False):
    _check_chunks(w1.shape[1], chunks)
    dtype = x_mid.dtype
    x_mid, cot_out, w1, b1, w2, ln_scale, ln_bias = map(
        fa.upcast, (x_mid, cot_out, w1, b1, w2, ln_scale, ln_bias))
    op = lambda t: fa.operand(t, fast_dots)
    h2, xh, inv = _ln_fwd(x_mid, ln_scale, ln_bias, eps)
    da = _gelu_grad(op(h2) @ op(w1) + b1) * (op(cot_out) @ op(w2).T)
    return (cot_out + _ln_vjp(op(da) @ op(w1).T, ln_scale, xh, inv)).to(dtype)


def attn_block_bwd_plain(x, cot_mid, r, w_qkv, b_qkv, w_out, ln_scale,
                         ln_bias, nheads: int, eps: float = 1e-6,
                         fast_dots: bool = False):
    dtype, D = x.dtype, x.shape[-1]
    x, cot_mid, r, w_qkv, b_qkv, w_out, ln_scale, ln_bias = map(
        fa.upcast, (x, cot_mid, r, w_qkv, b_qkv, w_out, ln_scale, ln_bias))
    op = lambda t: fa.operand(t, fast_dots)
    scale = 1.0 / math.sqrt(D // nheads)
    h1, xh, inv = _ln_fwd(x, ln_scale, ln_bias, eps)
    q, k, v = (op(split_heads(t, nheads))
               for t in (op(h1) @ op(w_qkv) + b_qkv).split(D, dim=-1))
    do = op(split_heads(op(cot_mid) @ op(w_out).T, nheads))
    a = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)  # [B,H,S,S]
    da = do @ v.transpose(-1, -2)                                 # ∇A
    p = a * da
    ds = op(a * (da - p.sum(dim=-1, keepdim=True)) * scale)
    dqkv = torch.cat([merge_heads(ds @ k),
                      merge_heads(ds.transpose(-1, -2) @ q),
                      merge_heads(op(a).transpose(-1, -2) @ do)], dim=-1)
    cot_x = cot_mid + _ln_vjp(op(dqkv) @ op(w_qkv).T, ln_scale, xh, inv)
    ead = torch.clamp(p, min=0.0).sum(dim=1)              # Σ_h relu(A∘∇A)
    e_row = torch.einsum("bq,bqk->bk", r, ead) * (1.0 / nheads)
    return cot_x.to(dtype), e_row


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------

def _check_chunks(I: int, chunks: int) -> None:
    assert I % chunks == 0, (
        f"hidden dim {I} not divisible by chunks={chunks}: the chunk "
        "loop would silently drop the tail columns")


def _cuda_args(device, dtypes=(torch.float32,), **tensors) -> None:
    """Each keyword is ``(tensor, expected shape)``, of a dtype among
    ``dtypes``; raise on anything the kernels do not take."""
    for name, (t, shape) in tensors.items():
        if tuple(t.shape) != tuple(shape):
            raise RuntimeError(f"{name} has shape {tuple(t.shape)}, "
                               f"expected {tuple(shape)}")
        if t.device != device:
            raise RuntimeError(f"{name} is on {t.device}, expected {device}")
        if t.dtype not in dtypes:
            takes = " or ".join(map(str, dtypes))
            raise RuntimeError(f"{name} is {t.dtype}; this call of the "
                               f"kernels takes {takes}")
        if not t.is_contiguous():
            raise RuntimeError(f"{name} must be contiguous")


def _is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def _layer_norm(lib, x2, scale, bias, eps, stream):
    """LayerNorm rows of float32 or bfloat16 x2 (scale and bias alike):
    (y float32, mean, 1/sigma)."""
    M, D = x2.shape
    y = torch.empty((M, D), device=x2.device, dtype=torch.float32)
    mean = torch.empty(M, device=x2.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    _build.check(lib, "tmx_layer_norm", lib.tmx_layer_norm(
        _ptr(x2), _ptr(scale), _ptr(bias), _ptr(y), _ptr(mean), _ptr(rstd),
        M, D, eps, _is_bf16(x2), stream))
    return y, mean, rstd


def _ln_vjp_cuda(lib, dy, x2, mean, rstd, scale, cot, stream):
    """LN-VJP rows plus the skip: dy float32; x2, scale, cot and the output
    float32 or bfloat16."""
    M, D = x2.shape
    out = torch.empty_like(x2)
    _build.check(lib, "tmx_layer_norm_vjp", lib.tmx_layer_norm_vjp(
        _ptr(dy), _ptr(x2), _ptr(mean), _ptr(rstd), _ptr(scale), _ptr(cot),
        _ptr(out), M, D, _is_bf16(x2), stream))
    return out


def gemm_plain(a, b, trans_b=False, bias=None, res=None, aux=None,
               act=_ACT_NONE, fast_dots=False):
    """``_gemm``'s function in plain PyTorch (``_gemm_bf16``'s with
    ``fast_dots``: a and b rounded to bf16), in float32 for float32 and
    bfloat16 operands, in float64 for float64 ones (the GEMM's gates)."""
    a, b = (fa.operand(fa.upcast(t), fast_dots) for t in (a, b))
    bias, res, aux = (None if t is None else fa.upcast(t)
                      for t in (bias, res, aux))
    c = a @ (b.transpose(-1, -2) if trans_b else b)
    if bias is not None:
        c = c + bias
    if act == _ACT_GELU:
        c = gelu(c)
    elif act == _ACT_MUL_GELU_GRAD:
        c = c * _gelu_grad(aux)
    if res is not None:
        c = c + res
    return c


def gemm_copy_width(a, b) -> int:
    """Width in bytes of the GEMM's copies for ``_gemm``'s operands a and b
    (either layout of b, each float32 or bfloat16): 16 where every row of
    both starts on a 16-byte boundary (``fa.copy_width`` over each one's
    row length and batch stride, in elements of its dtype), else 4."""
    for t in (a, b):
        strides = [t.stride(0)] if t.dim() == 3 else []
        if fa.copy_width(t.shape[-1], (t.data_ptr(),), strides,
                         fa.elements_per_copy(t)) != 16:
            return 4
    return 16


def _gemm(lib, a, b, stream, trans_b=False, bias=None, res=None, aux=None,
          act=_ACT_NONE, out=None, out_dtype=torch.float32):
    """``epilogue(a @ b)`` (``a @ bᵀ`` with ``trans_b``) on the tensor
    cores: ``+ bias``, then GELU (``_ACT_GELU``) or ``× GELU'(aux)``
    (``_ACT_MUL_GELU_GRAD``), then ``+ res``. a is [M, K], or a batch
    [Bt, M, K]; b, res, aux and out alike, each product's rows contiguous,
    res and aux in out's layout (aux may be out). a, b, bias, res and out
    are each float32 or bfloat16 (bf16 storage, fp32 products: the kernel
    reads and writes them as they are, with the bits of ``_BF16_BITS``),
    aux float32; a new out is of ``out_dtype``. Every operand is
    contiguous and of its shape, or it is refused before the launch. The
    copy width follows the operands (``gemm_copy_width``); ``gemm_plain``
    is the same function in PyTorch."""
    if a.dim() not in (2, 3) or b.dim() != a.dim():
        raise RuntimeError(f"a and b must both be 2-D or both 3-D, not "
                           f"{a.dim()}-D and {b.dim()}-D")
    *lead, M, K = a.shape
    N = b.shape[-2] if trans_b else b.shape[-1]
    if out is None:
        out = torch.empty((*lead, M, N), device=a.device, dtype=out_dtype)
    c = (*lead, M, N)
    args = {"a": (a, a.shape), "out": (out, c),
            "b": (b, (*lead, N, K) if trans_b else (*lead, K, N))}
    for name, t, shape in (("bias", bias, (N,)), ("res", res, c)):
        if t is not None:
            args[name] = (t, shape)
    _cuda_args(a.device, (torch.float32, torch.bfloat16), **args)
    if aux is not None:
        _cuda_args(a.device, aux=(aux, c))
    dtypes = sum(_BF16_BITS[name] for name, (t, _) in args.items()
                 if t.dtype == torch.bfloat16)
    batch, bs = 1, (0, 0, 0)
    if lead:
        batch, bs = lead[0], (a.stride(0), b.stride(0), out.stride(0))
    _build.check(lib, "tmx_gemm", lib.tmx_gemm(
        _ptr(a), _ptr(b), _ptr(out), M, N, K, int(trans_b), _ptr(bias),
        _ptr(res), _ptr(aux), act, dtypes, batch, *bs,
        gemm_copy_width(a, b), stream))
    return out


def _layer_norm_bf16(lib, x2, scale, bias, eps, stream):
    """LayerNorm rows of float32 or bfloat16 x2 (scale and bias alike) with
    fp32 statistics; returns (y rounded to bfloat16, mean, 1/sigma)."""
    M, D = x2.shape
    y = torch.empty((M, D), device=x2.device, dtype=torch.bfloat16)
    mean = torch.empty(M, device=x2.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    _build.check(lib, "tmx_layer_norm_bf16", lib.tmx_layer_norm_bf16(
        _ptr(x2), _ptr(scale), _ptr(bias), _ptr(y), _ptr(mean), _ptr(rstd),
        M, D, eps, int(x2.dtype == torch.bfloat16), stream))
    return y, mean, rstd


def _ln_vjp_any(lib, dy, x2, mean, rstd, scale, cot, stream):
    """``_ln_vjp_cuda`` on float32 or bfloat16 x2, scale and cot (dy
    float32), written in x2's dtype."""
    M, D = x2.shape
    out = torch.empty_like(x2)
    _build.check(lib, "tmx_layer_norm_vjp_any", lib.tmx_layer_norm_vjp_any(
        _ptr(dy), _ptr(x2), _ptr(mean), _ptr(rstd), _ptr(scale), _ptr(cot),
        _ptr(out), M, D, int(x2.dtype == torch.bfloat16), stream))
    return out


def gemm_bf16_copies(K: int, N: int, trans_b: bool, a_aligned: bool = True,
                     b_aligned: bool = True) -> Tuple[int, bool, bool, bool]:
    """Which bf16 operands ``_gemm_bf16`` copies before the launch: the
    GEMM's TMA copies need every row of A and B to start on a 16-byte
    boundary. K (the row length of A and of a B[N, K]) or N (that of a
    B[K, N]) that is not a multiple of 8, or a pointer off that boundary
    (``*_aligned`` false), takes a zero-filled copy: K padded
    to a multiple of 8 in both operands (zeros add nothing to the
    products), a B[K, N] with such an N copied transposed to B[N, Kp].
    Returns (Kp, copy a, copy b, trans_b of the launch)."""
    kp = -(-K // 8) * 8
    transpose = not trans_b and N % 8 != 0
    return (kp, kp != K or not a_aligned,
            kp != K or not b_aligned or transpose, trans_b or transpose)


def _padded(t, rows: int, cols: int, transpose: bool = False):
    """A zero-filled copy [..., rows, cols] of t (or of its transpose)."""
    src = t.transpose(-1, -2) if transpose else t
    out = t.new_zeros((*t.shape[:-2], rows, cols))
    out[..., :src.shape[-2], :src.shape[-1]] = src
    return out


def _round_bf16(lib, t, stream):
    """A float32 tensor rounded to bfloat16 (to nearest even) by the bf16
    library's rounding kernel; a bfloat16 one as it is."""
    if t.dtype == torch.bfloat16:
        return t
    out = torch.empty(t.shape, device=t.device, dtype=torch.bfloat16)
    _build.check(lib, "tmx_round_bf16", lib.tmx_round_bf16(
        _ptr(t), _ptr(out), t.numel(), stream))
    _gemm_bf16.rounded += 1
    return out


def _gemm_bf16(lib, a, b, stream, trans_b=False, bias=None, res=None,
               aux=None, act=_ACT_NONE, out_dtype=torch.float32):
    """``_gemm``'s function with bf16 products (``fast_dots``): a and b
    rounded to bf16, the products summed in fp32, the epilogue in fp32.
    a, b, bias and res are each float32 or bfloat16, aux float32; the
    output is new, of ``out_dtype``. Every operand is contiguous and of
    its shape, or it is refused before the launch. The kernel reads bf16
    operands through TMA: a float32 a or b is first rounded by a kernel
    of its own (counted in ``_gemm_bf16.rounded``), and an operand whose
    rows TMA cannot read is copied (``gemm_bf16_copies``, counted in
    ``_gemm_bf16.copies``). ``gemm_plain(..., fast_dots=True)`` is the
    same function in PyTorch."""
    if a.dim() not in (2, 3) or b.dim() != a.dim():
        raise RuntimeError(f"a and b must both be 2-D or both 3-D, not "
                           f"{a.dim()}-D and {b.dim()}-D")
    *lead, M, K = a.shape
    N = b.shape[-2] if trans_b else b.shape[-1]
    c = (*lead, M, N)
    out = torch.empty(c, device=a.device, dtype=out_dtype)
    args = {"a": (a, a.shape), "out": (out, c),
            "b": (b, (*lead, N, K) if trans_b else (*lead, K, N))}
    for name, t, shape in (("bias", bias, (N,)), ("res", res, c)):
        if t is not None:
            args[name] = (t, shape)
    _cuda_args(a.device, (torch.float32, torch.bfloat16), **args)
    if aux is not None:
        _cuda_args(a.device, aux=(aux, c))
    a, b = _round_bf16(lib, a, stream), _round_bf16(lib, b, stream)
    dtypes = _BF16_BITS["a"] | _BF16_BITS["b"] | sum(
        _BF16_BITS[name] for name in ("out", "bias", "res")
        if name in args and args[name][0].dtype == torch.bfloat16)
    kp, copy_a, copy_b, launch_t = gemm_bf16_copies(
        K, N, trans_b, a.data_ptr() % 16 == 0, b.data_ptr() % 16 == 0)
    if copy_a:
        a = _padded(a, M, kp)
    if copy_b:
        b = (_padded(b, N, kp, transpose=not trans_b) if launch_t
             else _padded(b, kp, N))
    _gemm_bf16.copies += copy_a + copy_b
    batch, bs = 1, (0, 0, 0)
    if lead:
        batch, bs = lead[0], (a.stride(0), b.stride(0), out.stride(0))
    _build.check(lib, "tmx_gemm_bf16", lib.tmx_gemm_bf16(
        _ptr(a), _ptr(b), _ptr(out), M, N, kp, int(launch_t), _ptr(bias),
        _ptr(res), _ptr(aux), act, dtypes, batch, *bs, stream))
    return out


def _check_heads(D: int, nheads: int, S: int, backward: bool, device,
                 fast_dots: bool = False) -> None:
    if D % nheads:
        raise RuntimeError(f"width {D} not divisible by {nheads} heads")
    fa.ensure_attention(S, D // nheads, backward, device, fast_dots)


def _block_args(fast_dots: bool, lead: str, **tensors) -> torch.dtype:
    """Check a block wrapper's CUDA arguments (``_cuda_args``), all of the
    dtype of tensor ``lead`` (``fa.storage_dtype``) but r, which is float32;
    returns that dtype."""
    t = tensors[lead][0]
    dtype = fa.storage_dtype(t, fast_dots)
    r = tensors.pop("r", None)
    _cuda_args(t.device, (dtype,), **tensors)
    if r is not None:
        _cuda_args(t.device, r=r)
    return dtype


def attn_block_fwd(x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor,
                   w_out: torch.Tensor, b_out: torch.Tensor,
                   ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                   nheads: int, eps: float = 1e-6,
                   fast_dots: bool = False) -> torch.Tensor:
    """x [B, S, D] → x + proj(attention(LN(x))).

    Replaces ``attn_block_pallas.attn_block_fwd`` (``_fwd_kernel``). Bound
    by operations (2·B·S·D·4D for the projections plus 4·B·H·S²·dh for
    attention, all on the tensor cores as 3xTF32); four launches: LN rows
    → qkv GEMM with the bias in its epilogue → attention per (query tile,
    head, image) with A only in registers → out-projection GEMM with bias
    and residual in its epilogue, so qkv and the merged output are the
    only round trips. ``fast_dots``: the same four launches with bf16
    products (``_attn_block_fwd_bf16``): the GEMMs and the attention on
    ``wgmma`` over TMA-copied tiles, the attention in one sweep over the
    keys at S ≤ 256."""
    if _build.on_cpu(x):
        return attn_block_fwd_plain(x, w_qkv, b_qkv, w_out, b_out, ln_scale,
                                    ln_bias, nheads, eps, fast_dots)
    B, S, D = x.shape
    _block_args(fast_dots, "x", x=(x, (B, S, D)), w_qkv=(w_qkv, (D, 3 * D)),
                b_qkv=(b_qkv, (3 * D,)), w_out=(w_out, (D, D)),
                b_out=(b_out, (D,)), ln_scale=(ln_scale, (D,)),
                ln_bias=(ln_bias, (D,)))
    lib = library(fast_dots)
    _check_heads(D, nheads, S, False, x.device, fast_dots)
    x2 = x.view(B * S, D)
    if fast_dots:
        with torch.cuda.device(x.device):
            out = _attn_block_fwd_bf16(lib, x2, w_qkv, b_qkv, w_out, b_out,
                                       ln_scale, ln_bias, (B, S, D), nheads,
                                       eps, _build.stream(x.device))
        attn_block_fwd.launches_bf16 += 1
        return out.view(B, S, D)
    with torch.cuda.device(x.device):
        st = _build.stream(x.device)
        h1, _, _ = _layer_norm(lib, x2, ln_scale, ln_bias, eps, st)
        qkv = _gemm(lib, h1, w_qkv, st, bias=b_qkv)
        merged = torch.empty((B * S, D), device=x.device, dtype=torch.float32)
        fa.attn_fwd_launch_qkv(qkv.view(B, S, 3 * D), merged.view(B, S, D),
                               nheads, st)
        out = _gemm(lib, merged, w_out, st, bias=b_out, res=x2,
                    out_dtype=x.dtype)
    attn_block_fwd.launches += 1
    return out.view(B, S, D)


def mlp_block_fwd(x_mid: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor, ln_scale: torch.Tensor,
                  ln_bias: torch.Tensor, eps: float = 1e-6,
                  chunks: int = 8, fast_dots: bool = False) -> torch.Tensor:
    """x_mid → x_mid + GELU_erf(LN2(x_mid)·w1 + b1)·w2 + b2.

    Replaces ``attn_block_pallas.mlp_block_fwd`` (``_mlp_fwd_kernel``).
    Bound by operations (4·B·S·D·I, 3xTF32 on the tensor cores); LN rows
    → W1 GEMM with bias and exact GELU in its epilogue → W2 GEMM with bias
    and residual in its epilogue. The [B*S, I] hidden goes through device memory once each way
    (the Pallas kernel kept [S, I/chunks] tiles in VMEM). ``fast_dots``:
    the same launches with bf16 products, the hidden stored in bf16."""
    if _build.on_cpu(x_mid):
        return mlp_block_fwd_plain(x_mid, w1, b1, w2, b2, ln_scale, ln_bias,
                                   eps, chunks, fast_dots)
    _check_chunks(w1.shape[1], chunks)
    (B, S, D), I = x_mid.shape, w1.shape[1]
    dtype = _block_args(fast_dots, "x_mid", x_mid=(x_mid, (B, S, D)),
                        w1=(w1, (D, I)), b1=(b1, (I,)), w2=(w2, (I, D)),
                        b2=(b2, (D,)), ln_scale=(ln_scale, (D,)),
                        ln_bias=(ln_bias, (D,)))
    lib = library(fast_dots)
    x2 = x_mid.view(B * S, D)
    if fast_dots:
        with torch.cuda.device(x_mid.device):
            st = _build.stream(x_mid.device)
            h2, _, _ = _layer_norm_bf16(lib, x2, ln_scale, ln_bias, eps, st)
            g = _gemm_bf16(lib, h2, w1, st, bias=b1, act=_ACT_GELU,
                           out_dtype=torch.bfloat16)                # [M, I]
            out = _gemm_bf16(lib, g, w2, st, bias=b2, res=x2,
                             out_dtype=dtype)
        mlp_block_fwd.launches_bf16 += 1
        return out.view(B, S, D)
    with torch.cuda.device(x_mid.device):
        st = _build.stream(x_mid.device)
        h2, _, _ = _layer_norm(lib, x2, ln_scale, ln_bias, eps, st)
        g = _gemm(lib, h2, w1, st, bias=b1, act=_ACT_GELU)       # [M, I]
        out = _gemm(lib, g, w2, st, bias=b2, res=x2, out_dtype=dtype)
    mlp_block_fwd.launches += 1
    return out.view(B, S, D)


def mlp_block_bwd(x_mid: torch.Tensor, cot_out: torch.Tensor,
                  w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                  ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                  eps: float = 1e-6, chunks: int = 8,
                  fast_dots: bool = False) -> torch.Tensor:
    """cot_mid = cot_out + LN2-VJP((GELU'(a1) ⊙ cot_out·w2ᵀ)·w1ᵀ), with
    a1 = LN2(x_mid)·w1 + b1 recomputed (no a1 tape).

    Replaces ``attn_block_pallas.mlp_block_bwd`` (``_mlp_bwd_kernel``).
    Bound by operations (6·B·S·D·I, 3xTF32 on the tensor cores); LN rows
    → a1 GEMM → cot·w2ᵀ GEMM whose epilogue multiplies by GELU'(a1) in
    place over a1 → ·w1ᵀ GEMM → LN-VJP rows with the residual skip.
    ``fast_dots``: bf16 products; a1 stays fp32 (GELU' reads it) and the
    product that multiplies it goes to a bf16 buffer of its own."""
    if _build.on_cpu(x_mid):
        return mlp_block_bwd_plain(x_mid, cot_out, w1, b1, w2, ln_scale,
                                   ln_bias, eps, chunks, fast_dots)
    _check_chunks(w1.shape[1], chunks)
    (B, S, D), I = x_mid.shape, w1.shape[1]
    _block_args(fast_dots, "x_mid", x_mid=(x_mid, (B, S, D)),
                cot_out=(cot_out, (B, S, D)), w1=(w1, (D, I)), b1=(b1, (I,)),
                w2=(w2, (I, D)), ln_scale=(ln_scale, (D,)),
                ln_bias=(ln_bias, (D,)))
    lib = library(fast_dots)
    x2, c2 = x_mid.view(B * S, D), cot_out.view(B * S, D)
    if fast_dots:
        with torch.cuda.device(x_mid.device):
            st = _build.stream(x_mid.device)
            h2, mean, rstd = _layer_norm_bf16(lib, x2, ln_scale, ln_bias,
                                              eps, st)
            a1 = _gemm_bf16(lib, h2, w1, st, bias=b1)              # [M, I]
            da = _gemm_bf16(lib, c2, w2, st, trans_b=True, aux=a1,
                            act=_ACT_MUL_GELU_GRAD, out_dtype=torch.bfloat16)
            dh2 = _gemm_bf16(lib, da, w1, st, trans_b=True)        # [M, D]
            out = _ln_vjp_any(lib, dh2, x2, mean, rstd, ln_scale, c2, st)
        mlp_block_bwd.launches_bf16 += 1
        return out.view(B, S, D)
    with torch.cuda.device(x_mid.device):
        st = _build.stream(x_mid.device)
        h2, mean, rstd = _layer_norm(lib, x2, ln_scale, ln_bias, eps, st)
        a1 = _gemm(lib, h2, w1, st, bias=b1)                      # [M, I]
        # da = GELU'(a1) ⊙ (cot·w2ᵀ), written over a1 in place
        _gemm(lib, c2, w2, st, trans_b=True, aux=a1,
              act=_ACT_MUL_GELU_GRAD, out=a1)
        dh2 = _gemm(lib, a1, w1, st, trans_b=True)                # [M, D]
        out = _ln_vjp_cuda(lib, dh2, x2, mean, rstd, ln_scale, c2, st)
    mlp_block_bwd.launches += 1
    return out.view(B, S, D)


def attn_block_bwd(x: torch.Tensor, cot_mid: torch.Tensor, r: torch.Tensor,
                   w_qkv: torch.Tensor, b_qkv: torch.Tensor,
                   w_out: torch.Tensor, ln_scale: torch.Tensor,
                   ln_bias: torch.Tensor, nheads: int, eps: float = 1e-6,
                   fast_dots: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward of ``attn_block_fwd`` fused with the relevancy fold.

    x, cot_mid: [B, S, D]; r: [B, S] (the running CLS row). Returns
    (cot_x [B, S, D] with the residual skip, e_row [B, S]).

    Replaces ``attn_block_pallas.attn_block_bwd`` (``_bwd_kernel``). Bound
    by operations (4·B·S·D·3D + 2·B·S·D² for the projections and
    10·B·H·S²·dh for attention, all 3xTF32 on the tensor cores). LN rows →
    qkv GEMM → cot·W_outᵀ GEMM → attention backward (q pass: the online
    row statistics and dq; kv pass: A recomputed from the saved row max and
    1/sum, dk, dv and the per-head fold Σ_q r_q relu(A∘dA); heads summed in
    a fixed order, so e_row is deterministic) → dqkv·W_qkvᵀ GEMM → LN-VJP
    rows. A never reaches device memory. ``fast_dots``: the same launches
    with bf16 products (``_attn_block_bwd_bf16``); r and e_row float32."""
    if _build.on_cpu(x):
        return attn_block_bwd_plain(x, cot_mid, r, w_qkv, b_qkv, w_out,
                                    ln_scale, ln_bias, nheads, eps, fast_dots)
    B, S, D = x.shape
    _block_args(fast_dots, "x", x=(x, (B, S, D)), cot_mid=(cot_mid, (B, S, D)),
                r=(r, (B, S)), w_qkv=(w_qkv, (D, 3 * D)),
                b_qkv=(b_qkv, (3 * D,)), w_out=(w_out, (D, D)),
                ln_scale=(ln_scale, (D,)), ln_bias=(ln_bias, (D,)))
    lib = library(fast_dots)
    _check_heads(D, nheads, S, True, x.device, fast_dots)
    x2, c2 = x.view(B * S, D), cot_mid.view(B * S, D)
    dev = x.device
    if fast_dots:
        with torch.cuda.device(dev):
            cot_x, e_row = _attn_block_bwd_bf16(
                lib, x2, c2, r, w_qkv, b_qkv, w_out, ln_scale, ln_bias,
                (B, S, D), nheads, eps, _build.stream(dev))
        attn_block_bwd.launches_bf16 += 1
        return cot_x.view(B, S, D), e_row
    with torch.cuda.device(dev):
        st = _build.stream(dev)
        h1, mean, rstd = _layer_norm(lib, x2, ln_scale, ln_bias, eps, st)
        qkv = _gemm(lib, h1, w_qkv, st, bias=b_qkv)               # [M, 3D]
        dm = _gemm(lib, c2, w_out, st, trans_b=True)              # [M, D]
        dqkv = torch.empty_like(qkv)
        e_row = fa.attn_bwd_launch(
            *fa.qkv_heads(qkv.view(B, S, 3 * D), nheads),
            fa.heads(dm.view(B, S, D), nheads), r,
            *fa.qkv_heads(dqkv.view(B, S, 3 * D), nheads), st)
        dh1 = _gemm(lib, dqkv, w_qkv, st, trans_b=True)           # [M, D]
        cot_x = _ln_vjp_cuda(lib, dh1, x2, mean, rstd, ln_scale, c2, st)
    attn_block_bwd.launches += 1
    return cot_x.view(B, S, D), e_row


def _attn_block_fwd_bf16(lib, x2, w_qkv, b_qkv, w_out, b_out, ln_scale,
                         ln_bias, shape, nheads, eps, st):
    """``attn_block_fwd``'s launches with bf16 products on x2 [B*S, D]
    (``shape`` = (B, S, D)): LN rows → bf16 h1 → qkv GEMM (bias, bf16 out)
    → bf16 attention → out-projection GEMM (bias and residual, x's
    dtype)."""
    B, S, D = shape
    M = B * S
    h1, _, _ = _layer_norm_bf16(lib, x2, ln_scale, ln_bias, eps, st)
    qkv = _gemm_bf16(lib, h1, w_qkv, st, bias=b_qkv, out_dtype=torch.bfloat16)
    merged = torch.empty((M, D), device=x2.device, dtype=torch.bfloat16)
    fa.attn_fwd_launch_qkv(qkv.view(B, S, 3 * D), merged.view(B, S, D),
                           nheads, st, fast_dots=True)
    return _gemm_bf16(lib, merged, w_out, st, bias=b_out, res=x2,
                      out_dtype=x2.dtype)


def _attn_block_bwd_bf16(lib, x2, c2, r, w_qkv, b_qkv, w_out, ln_scale,
                         ln_bias, shape, nheads, eps, st):
    """``attn_block_bwd``'s launches with bf16 products: LN rows → qkv GEMM
    (bf16 out) → cot·W_outᵀ GEMM (bf16 out) → bf16 attention backward
    (dqkv in bf16, e_row fp32) → dqkv·W_qkvᵀ GEMM (fp32 out) → LN-VJP
    rows with the residual skip (x's dtype). Returns (cot_x [B*S, D],
    e_row)."""
    B, S, D = shape
    h1, mean, rstd = _layer_norm_bf16(lib, x2, ln_scale, ln_bias, eps, st)
    qkv = _gemm_bf16(lib, h1, w_qkv, st, bias=b_qkv, out_dtype=torch.bfloat16)
    dm = _gemm_bf16(lib, c2, w_out, st, trans_b=True,
                    out_dtype=torch.bfloat16)                     # [M, D]
    dqkv = torch.empty_like(qkv)
    e_row = fa.attn_bwd_launch(
        *fa.qkv_heads(qkv.view(B, S, 3 * D), nheads),
        fa.heads(dm.view(B, S, D), nheads), r,
        *fa.qkv_heads(dqkv.view(B, S, 3 * D), nheads), st, fast_dots=True)
    dh1 = _gemm_bf16(lib, dqkv, w_qkv, st, trans_b=True)          # [M, D]
    return _ln_vjp_any(lib, dh1, x2, mean, rstd, ln_scale, c2, st), e_row


KERNELS = (attn_block_fwd, mlp_block_fwd, mlp_block_bwd, attn_block_bwd)
for _fn in KERNELS:
    _fn.launches = _fn.launches_bf16 = 0
_gemm_bf16.copies = _gemm_bf16.rounded = 0


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
    _gemm_bf16.copies = _gemm_bf16.rounded = 0
