"""The precision scheme of the port's tensor-core GEMM, emulated on the CPU.

csrc/mma_tf32.cuh rounds an fp32 value to TF32 with two integer operations
(``to_tf32``: add half a TF32 ulp to the bits, clear the 13 dropped bits)
and splits it into hi + lo (``split_tf32``; the GEMM's
``split_tf32_fast`` leaves lo unrounded, and the mma reads it cut to
TF32); csrc/common.cuh's GEMM takes each product as lo·hi + hi·lo + hi·hi
and adds the products of each k slice to an fp32 accumulator. This file
emulates those bit operations in torch, adding every k8 step in fp32, and
pins the bar that the card's GEMM gate uses (tests/test_torch_kernels_cuda.py,
chip_smoke.py): max|Δ| from float64 within 1e-5 · max|C64|, which 3xTF32
meets with either split and a single TF32 product (hi·hi) misses. Runs on
the CPU.
"""

import numpy as np
import pytest
import torch

GEMM_BAR = 1e-5


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``to_tf32`` of mma_tf32.cuh on fp32 ``x``: (bits + 0x1000) &
    0xffffe000, as unsigned 32-bit arithmetic."""
    bits = x.view(torch.int32).to(torch.int64) & 0xffffffff
    bits = (bits + 0x1000) & 0xffffe000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def cut_tf32(x: torch.Tensor) -> torch.Tensor:
    """x with the 13 bits TF32 drops cleared: how an mma reads a .tf32
    operand whose low bits are set."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def split_tf32(x: torch.Tensor, fast: bool = False):
    """``split_tf32`` (lo rounded) or, with ``fast``, ``split_tf32_fast``
    as the mma reads it (lo cut)."""
    hi = to_tf32(x)
    return hi, (cut_tf32 if fast else to_tf32)(x - hi)


def tf32_reference(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest, ties away from zero, to 10 stored significand
    bits, in float64 (normal numbers and zero)."""
    m, e = np.frexp(x.astype(np.float64))      # |m| in [0.5, 1): 11 bits
    r = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5) / 2.0 ** 11
    return np.ldexp(r, e).astype(np.float32)


def bits(x: float) -> int:
    return int(np.float32(x).view(np.uint32))


def from_bits(u: int) -> float:
    return float(np.uint32(u).view(np.float32))


@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),                    # tie: away
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),              # negative tie
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),                    # below the tie
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),                 # tie, odd: up
    (2.0 - 2.0 ** -11, 2.0),                                 # carry
    (-(2.0 ** 5) * (2.0 - 2.0 ** -11), -(2.0 ** 6)),         # carry, neg
    (from_bits(0x7f7fffff), float("inf")),                   # carry to inf
    (from_bits(0x00301000), from_bits(0x00302000)),          # subnormal tie
    (from_bits(0x00300fff), from_bits(0x00300000)),          # subnormal
    (from_bits(0x00000001), 0.0),                            # tiny subnormal
    (0.0, 0.0),
    (-0.0, -0.0),
])
def test_to_tf32_rounds_to_nearest_ties_away(x, want):
    got = to_tf32(torch.tensor([x], dtype=torch.float32))
    assert bits(float(got)) == bits(want)
    assert bits(float(got)) & 0x1fff == 0


def test_to_tf32_matches_rounding_of_random_normals():
    rng = np.random.RandomState(0)
    x = (rng.randn(20000) * np.exp(rng.randn(20000) * 10)).astype(np.float32)
    got = to_tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, tf32_reference(x))
    for fast in (False, True):
        hi, lo = split_tf32(torch.from_numpy(x), fast)
        # hi + lo holds x to about 2^-22 of |x| (2^-21 with lo cut)
        err = np.abs((hi.double() + lo.double()).numpy()
                     - x.astype(np.float64))
        assert (err <= 2.0 ** -20 * np.abs(x)).all()


def emulated_gemm(a: torch.Tensor, b: torch.Tensor, terms: str):
    """a [M, K] @ b [K, N] split as the kernels split it: per k8 step, the
    chosen TF32 products (each exact in fp32) added to an fp32 accumulator,
    small terms first. terms: "3x" (lo·hi + hi·lo + hi·hi, split_tf32),
    "3x fast" (the same with split_tf32_fast) or "1x" (hi·hi)."""
    fast = terms == "3x fast"
    a_hi, a_lo = split_tf32(a, fast)
    b_hi, b_lo = split_tf32(b, fast)
    c = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 8):
        k = slice(k0, k0 + 8)
        if terms != "1x":
            c = c + a_lo[:, k] @ b_hi[k]
            c = c + a_hi[:, k] @ b_lo[k]
        c = c + a_hi[:, k] @ b_hi[k]
    return c


def relative_error(K: int, terms: str, seed: int = 0) -> float:
    rng = np.random.RandomState(seed)
    a = rng.randn(16, K).astype(np.float32)
    b = rng.randn(K, 24).astype(np.float32)
    want = torch.from_numpy(a.astype(np.float64) @ b.astype(np.float64))
    got = emulated_gemm(torch.from_numpy(a), torch.from_numpy(b), terms)
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("terms", ["3x", "3x fast"])
@pytest.mark.parametrize("K", [197, 768, 2304, 3072])
def test_3xtf32_product_within_the_bar(K, terms):
    assert relative_error(K, terms) <= GEMM_BAR


@pytest.mark.parametrize("K", [197, 768, 2304, 3072])
def test_single_tf32_product_misses_the_bar(K):
    assert relative_error(K, "1x") > GEMM_BAR
