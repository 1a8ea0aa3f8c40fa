"""The relevancy chain kernels' schedule, emulated on the CPU.

csrc/relevancy_chain.cu runs the rule-6 chain R ← R + Ê_l·R in two steps:

  * one launch reduces every layer from ``start_layer`` on,
    Ê_l = (1/H) Σ_h relu(A_lh ∘ G_lh), heads in order, into row-padded
    planes ``[B, L', S, Sp]`` (Sp = S rounded up to a multiple of 4, the
    padded columns 0), and sets R0 = I and R1 = 0 on ``[B, Sp, Sp]``;
  * per layer, the tensor-core GEMM of csrc/common.cuh writes
    Ê_l·R + R (M = S, N = K = Sp) into the other R buffer: per 32-deep k
    slice a fresh accumulator takes, per 8-deep step, lo·hi + hi·lo + hi·hi
    (``split_tf32_fast``; ``split_tf32`` of tests/test_torch_gemm_tf32.py),
    and is added to the fp32 sum; the slices past K are zero-filled.

This file runs that schedule in torch and holds it to the JAX package's
Pallas chain in interpret mode and, within 1e-5 · max|R64|, to the chain
in float64 (``chain_f64``, the card's bar, tests/test_torch_kernels_cuda.py),
at S = 197 (padded to 200), 50 (to 52) and 128 (no padding), with
``start_layer`` 0, 1 and L, where that bar fails R = I and a chain of
single-pass TF32 products. It also shows that the padding adds exact
zeros: the padded product's [:S, :S] equals the unpadded one's bit for
bit, and the padded rows and columns of R stay 0.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.ops import relevancy_pallas as jrp
from transformer_mm_explainability_tpu_torch.ops import relevancy_pallas as trp
from test_torch_gemm_tf32 import split_tf32, to_tf32
from test_torch_kernels_cuda import chain_f64, chain_inputs

BK = 32            # k per slice of the GEMM (kGemmBK), one fresh accumulator
F64_BAR = 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)
L = 3


def ehat_pass(cams: torch.Tensor, grads: torch.Tensor, start: int):
    """The reduction launch: [B, L', S, Sp] planes, heads summed in order,
    then divided by H; padded columns 0."""
    B, _, H, S, _ = cams.shape
    Sp = trp.padded(S)
    s = torch.zeros((B, L - start, S, S))
    for h in range(H):
        s = s + torch.relu(cams[:, start:, h] * grads[:, start:, h])
    return torch.nn.functional.pad(s / H, (0, Sp - S))


def gemm(a: torch.Tensor, b: torch.Tensor, res: torch.Tensor):
    """a [B, M, K] @ b [B, K, N] + res as the tensor-core GEMM sums it: K
    zero-filled to whole 32-deep slices; per slice a fresh accumulator of
    3xTF32 products per 8-deep step, added to the fp32 sum."""
    K = a.shape[-1]
    Kt = -(-K // BK) * BK
    a = torch.nn.functional.pad(a, (0, Kt - K))
    b = torch.nn.functional.pad(b, (0, 0, 0, Kt - K))
    a_hi, a_lo = split_tf32(a.contiguous(), fast=True)
    b_hi, b_lo = split_tf32(b.contiguous(), fast=True)
    acc = torch.zeros(a.shape[0], a.shape[1], b.shape[2])
    for k0 in range(0, Kt, BK):
        d = torch.zeros_like(acc)
        for s0 in range(k0, k0 + BK, 8):
            k = slice(s0, s0 + 8)
            d = d + a_lo[..., k] @ b_hi[..., k, :]
            d = d + a_hi[..., k] @ b_lo[..., k, :]
            d = d + a_hi[..., k] @ b_hi[..., k, :]
        acc = acc + d
    return acc + res


def padded_chain(e: torch.Tensor, S: int):
    """The products on the padded buffers; returns R [B, Sp, Sp]."""
    B, Lr, _, Sp = e.shape
    R = torch.zeros((B, Sp, Sp))
    R[:, :S, :S] = torch.eye(S)
    for i in range(Lr):
        nxt = torch.zeros_like(R)               # R1 = 0 before its first use
        nxt[:, :S] = gemm(e[:, i], R, R[:, :S])   # M = S rows written
        R = nxt
    return R


@functools.lru_cache(maxsize=None)
def _case(S: int, start: int):
    """(cams, grads, the JAX kernel's [B, S, S] in interpret mode; at
    start = L, where the Pallas call has no layer to copy, JAX's
    dispatcher, whose chain returns I)."""
    cams, grads = chain_inputs(2, L, 2, S, seed=S)
    if start == L:
        want = np.asarray(jrp.self_attention_relevancy_auto(
            jnp.asarray(cams), jnp.asarray(grads), start_layer=start))
    else:
        want = np.asarray(jrp.self_attention_relevancy_pallas(
            jnp.asarray(cams), jnp.asarray(grads), start_layer=start,
            interpret=True))
    return torch.from_numpy(cams), torch.from_numpy(grads), want


@pytest.mark.parametrize("start", [0, 1, L])
@pytest.mark.parametrize("S", [197, 50, 128])
def test_padded_chain_matches_pallas_and_float64(S, start):
    cams, grads, want = _case(S, start)
    e = ehat_pass(cams, grads, start)
    assert e.shape == (2, L - start, S, trp.padded(S))
    assert not e[..., S:].any()
    R = padded_chain(e, S)
    assert not R[:, S:].any() and not R[:, :, S:].any()
    got = R[:, :S, :S]
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want64 = chain_f64(cams, grads, start)
    bar = F64_BAR * float(want64.abs().max())
    err = float((got.double() - want64).abs().max())
    assert err <= bar, err
    if start < L:   # the bar fails R = I and single-pass TF32 products
        e = e[..., :S]
        one_pass = torch.eye(S).expand(2, S, S)
        for i in range(e.shape[1]):
            one_pass = one_pass + to_tf32(e[:, i].contiguous()) @ to_tf32(
                one_pass.contiguous())
        assert float((want64 - torch.eye(S)).abs().max()) > 100 * bar
        assert float((one_pass.double() - want64).abs().max()) > bar


@pytest.mark.parametrize("S", [197, 50])
def test_padding_adds_exact_zeros(S):
    """One layer's product on the padded planes equals the product on the
    unpadded ones (K = S, the GEMM's own zero-filled tail) bit for bit."""
    cams, grads, _ = _case(S, 0)
    e = ehat_pass(cams, grads, 0)[:, 0]
    R = padded_chain(ehat_pass(cams, grads, L - 1), S)   # a one-layer R
    got = gemm(e, R, R[:, :S])[..., :S]
    want = gemm(e[..., :S].contiguous(), R[:, :S, :S].contiguous(),
                R[:, :S, :S])
    assert torch.equal(got, want)


def test_padded_rows_are_16_byte_aligned():
    """Sp: the next multiple of 4 floats, S itself where it is one."""
    assert [trp.padded(S) for S in (1, 4, 50, 128, 197, 200)] == \
        [4, 4, 52, 128, 200, 200]
