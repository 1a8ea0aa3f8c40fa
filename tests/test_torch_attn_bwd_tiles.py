"""The attention backward's tile order and online recurrences, emulated on
the CPU.

csrc/attn_block.cu computes dq, dk, dv and e_row = r · mean_h relu(A ∘ dA)
in two passes that never hold a score row:

  * the q pass streams 32-key tiles twice: first the online row max m, sum
    l and u = Σ 2^(s − m)·dA in the log2 domain, all three rescaled
    together (dsum = u / l); then ds = A (dA − dsum) scale and dq += ds·k,
    each tile's product in a fresh accumulator added in fp32;
  * the kv pass streams 32-query tiles with their (m, 1/l, dsum, r):
    Aᵀ = 2^(sᵀ − m)·(1/l), the fold Σ_q r_q relu(Aᵀ∘dAᵀ), dv += Aᵀ·dout
    and dk += dsᵀ·q; padded queries carry 1/l = 0 and r = 0;
  * e_row sums the heads in a fixed order.

This file runs that order in torch, vectorised over rows (which the kernels
split across warps and blocks without changing any row's arithmetic), with
keys past S at −inf and dh zero-padded to a multiple of 8. Its products are
either plain fp32 or the 3xTF32 split that the backward takes from
csrc/mma_tf32.cuh (per 8-deep k step, lo·hi + hi·lo + hi·hi added to an
fp32 accumulator, hi rounded to TF32 and lo cut to it as the mma reads
``split_tf32_fast``'s lo; ``split_tf32`` of tests/test_torch_gemm_tf32.py).
Each result is held to the JAX kernel in interpret mode with full-fp32
dots and, output by output, within 1e-5 · max|ref| of the plain version in
float64, the bar that the card's gates use (tests/test_torch_kernels_cuda.py,
chip_smoke.py); a single TF32 product misses it.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.ops import flash_attention as jfa
from transformer_mm_explainability_tpu_torch.ops import flash_attention as tfa
from test_torch_gemm_tf32 import split_tf32
from test_torch_kernels_cuda import flash_inputs

TILE = 32                  # keys (q pass) or queries (kv pass) per tile
LOG2E = 1.4426950408889634
F64_BAR = 1e-5
# fp32 against fp32 in another order: a few ulps of O(10) values
TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(S, dh) for S in (1, 31, 33, 65, 197) for dh in (8, 20, 64)]


def product(a: torch.Tensor, b: torch.Tensor, terms: str) -> torch.Tensor:
    """a [..., M, K] @ b [..., K, N] as one tile's product: "fp32" a plain
    fp32 matmul; "3x" (3xTF32) or "1x" (hi·hi alone) per 8-deep k step,
    each step's exact TF32 products added to an fp32 accumulator."""
    if terms == "fp32":
        return a @ b
    a_hi, a_lo = split_tf32(a.contiguous(), fast=True)
    b_hi, b_lo = split_tf32(b.contiguous(), fast=True)
    c = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        k = slice(k0, k0 + 8)
        if terms == "3x":
            c = c + a_lo[..., k] @ b_hi[..., k, :]
            c = c + a_hi[..., k] @ b_lo[..., k, :]
        c = c + a_hi[..., k] @ b_hi[..., k, :]
    return c


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """x [..., S, d] zero-filled to [..., rows, d]."""
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[-2]))


def q_pass(q, k, v, dout, scale, terms):
    """dq and the row statistics (m, 1/l, dsum) of every query row."""
    S = q.shape[-2]
    scale_log2 = np.float32(scale * np.float32(LOG2E))
    padded = -(-S // TILE) * TILE
    kp, vp = pad_rows(k, padded), pad_rows(v, padded)
    m = torch.full(q.shape[:-1], -math.inf)
    l, u = torch.zeros_like(m), torch.zeros_like(m)

    def scores(k0):
        kt, vt = kp[..., k0:k0 + TILE, :], vp[..., k0:k0 + TILE, :]
        s = product(q, kt.transpose(-1, -2), terms) * scale_log2
        valid = torch.arange(k0, k0 + TILE) < S
        return torch.where(valid, s, -math.inf), product(
            dout, vt.transpose(-1, -2), terms), kt

    for k0 in range(0, padded, TILE):             # sweep 1: statistics
        s, g, _ = scores(k0)
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - mx)                # 0 on the first tile
        m = mx
        p = torch.exp2(s - m[..., None])
        l = l * alpha + p.sum(-1)
        u = u * alpha + (p * g).sum(-1)
    inv = 1.0 / l
    dsum = u * inv
    dq = torch.zeros_like(q)
    for k0 in range(0, padded, TILE):             # sweep 2: ds and dq
        s, g, kt = scores(k0)
        a = torch.exp2(s - m[..., None]) * inv[..., None]
        ds = a * (g - dsum[..., None]) * scale
        dq = dq + product(ds, kt, terms)          # fresh per tile
    return dq, m, inv, dsum


def kv_pass(q, k, v, dout, r, m, inv, dsum, scale, terms):
    """dk, dv and the per-head fold e_h[key] = Σ_q r_q relu(A ∘ dA)."""
    B, H, S, _ = q.shape
    scale_log2 = np.float32(scale * np.float32(LOG2E))
    padded = -(-S // TILE) * TILE
    qp, op = pad_rows(q, padded), pad_rows(dout, padded)
    # padded queries: 1/l = 0 and r = 0 (m = dsum = 0), so A = 0 there
    stats = [torch.nn.functional.pad(x, (0, padded - S))
             for x in (m, inv, dsum, r[:, None, :].expand(B, H, S))]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    fold = torch.zeros((B, H, S))
    for q0 in range(0, padded, TILE):
        qt, ot = qp[..., q0:q0 + TILE, :], op[..., q0:q0 + TILE, :]
        mt, it, dt, rt = (x[..., None, q0:q0 + TILE] for x in stats)
        st = product(k, qt.transpose(-1, -2), terms)      # [B, H, S, TILE]
        gt = product(v, ot.transpose(-1, -2), terms)
        a = torch.exp2(st * scale_log2 - mt) * it
        fold = fold + (torch.clamp(a * gt, min=0.0) * rt).sum(-1)
        ds = a * (gt - dt) * scale
        dv = dv + product(a, ot, terms)
        dk = dk + product(ds, qt, terms)
    e_row = torch.zeros((B, S))
    for h in range(H):                                    # fixed head order
        e_row = e_row + fold[:, h]
    return dk, dv, e_row * np.float32(1.0 / H)


def tiled_backward(q, k, v, dout, r, terms):
    """(dq, dk, dv, e_row) by the two passes, dh zero-padded to a multiple
    of 8 (exact: the padded columns add nothing) and scaled by the true
    1/√dh."""
    dh = q.shape[-1]
    scale = np.float32(1.0 / math.sqrt(dh))
    qp, kp, vp, op = (torch.nn.functional.pad(x, (0, -dh % 8))
                      for x in (q, k, v, dout))
    dq, m, inv, dsum = q_pass(qp, kp, vp, op, scale, terms)
    dk, dv, e_row = kv_pass(qp, kp, vp, op, r, m, inv, dsum, scale, terms)
    return dq[..., :dh], dk[..., :dh], dv[..., :dh], e_row


def within_bar(got, want64) -> list:
    """Per output: max|Δ| from float64 within F64_BAR · max|ref|."""
    return [float((g.double() - w).abs().max()) <= F64_BAR * float(w.abs().max())
            for g, w in zip(got, want64)]


@pytest.mark.parametrize("terms", ["fp32", "3x"])
@pytest.mark.parametrize("S,dh", SHAPES)
def test_tiled_backward_matches_pallas_and_float64(S, dh, terms):
    f = flash_inputs(1, 2, S, dh, seed=11)
    args = [f[name] for name in ("q", "k", "v", "dout", "r")]
    got = tiled_backward(*(torch.from_numpy(a) for a in args), terms)
    want = jfa.flash_bwd_ehat(*(jnp.asarray(a) for a in args),
                              interpret=True, fast_dots=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    want64 = tfa.flash_bwd_ehat_plain(
        *(torch.from_numpy(a.astype(np.float64)) for a in args))
    assert all(within_bar(got, want64))


@pytest.mark.parametrize("S,dh", [(197, 64), (65, 20)])
def test_single_tf32_backward_misses_the_bar(S, dh):
    """The float64 bar separates 3xTF32 from one TF32 product per product
    (hi·hi alone, about three decimal digits)."""
    f = flash_inputs(1, 2, S, dh, seed=11)
    args = [f[name] for name in ("q", "k", "v", "dout", "r")]
    got = tiled_backward(*(torch.from_numpy(a) for a in args), "1x")
    want64 = tfa.flash_bwd_ehat_plain(
        *(torch.from_numpy(a.astype(np.float64)) for a in args))
    assert not all(within_bar(got, want64))
