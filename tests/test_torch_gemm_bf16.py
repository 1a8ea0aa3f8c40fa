"""The bf16-product GEMM's wrapper (``ops/attn_block._gemm_bf16``) on the
CPU: the rule that decides which operands it copies before the kernel's
TMA copies read them (``gemm_bf16_copies``, a pure function), and the CUDA
branch run on CPU tensors against a stand-in library that records each
call and computes what the kernel would from the operands it was handed.

The kernel reads bf16 operands whose rows start on 16-byte boundaries: K
(the rows of A and of a B[N, K]) and N (the rows of a B[K, N]) a multiple
of 8. Other shapes get zero-padded copies, which add nothing to the
products, so the launch's operands must give the same float64 product as
the wrapper's; float32 operands are rounded to bf16 (to nearest even)
first. The kernel itself is held to float64 on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu_torch.ops import _build
from transformer_mm_explainability_tpu_torch.ops import attn_block as tab

KS = (1, 5, 8, 33, 64, 197, 768, 3072)
NS = (1, 7, 8, 33, 769, 768, 2304)


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("N", NS)
def test_copy_rule_gives_every_shape_rows_tma_reads(K, N, trans_b):
    """Every shape gets a launch whose rows are whole 16-byte units of
    bf16: K padded to the next multiple of 8 (nothing else), a B[K, N]
    with N off that grid copied transposed; aligned operands of aligned
    shapes are never copied."""
    for a_ok in (True, False):
        for b_ok in (True, False):
            kp, copy_a, copy_b, launch_t = tab.gemm_bf16_copies(
                K, N, trans_b, a_ok, b_ok)
            assert kp % 8 == 0 and K <= kp < K + 8
            assert copy_a == (kp != K or not a_ok)
            assert launch_t == (trans_b or N % 8 != 0)
            assert (N if not launch_t else kp) % 8 == 0   # B's row length
            assert copy_b == (kp != K or not b_ok or launch_t != trans_b)
    assert tab.gemm_bf16_copies(768, 768, False) == (768, False, False, False)


class _Recorder:
    """A stand-in for the bf16 library: pointers map back to the tensors
    the wrapper passed (``tab._ptr`` is patched to note them);
    ``tmx_round_bf16`` rounds as the kernel does, ``tmx_gemm_bf16`` keeps
    its operands and computes the product with ``gemm_plain``."""

    def __init__(self):
        self.tensors, self.gemms, self.rounds = {}, [], 0

    def ptr(self, t):
        if t is None:
            return None
        self.tensors[t.data_ptr()] = t
        return t.data_ptr()

    def tmx_round_bf16(self, x, y, n, stream):
        src, dst = self.tensors[x], self.tensors[y]
        assert src.dtype == torch.float32 and dst.dtype == torch.bfloat16
        assert src.numel() == dst.numel() == n
        dst.copy_(src)   # torch rounds to nearest even, as the kernel
        self.rounds += 1
        return 0

    def tmx_gemm_bf16(self, A, B, C, M, N, K, trans_b, bias, res, aux, act,
                      dtypes, batch, bsA, bsB, bsC, stream):
        a, b, c = self.tensors[A], self.tensors[B], self.tensors[C]
        assert a.dtype == b.dtype == torch.bfloat16 and dtypes & 3 == 3
        assert a.shape[-2:] == (M, K) and K % 8 == 0
        assert b.shape[-2:] == ((N, K) if trans_b else (K, N))
        assert (K if trans_b else N) % 8 == 0
        assert a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
        if batch > 1:
            assert (bsA, bsB, bsC) == (a.stride(0), b.stride(0), c.stride(0))
        self.gemms.append((a, b, bool(trans_b), K))
        c.copy_(tab.gemm_plain(a.double(), b.double(), bool(trans_b)))
        return 0


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(tab, "_ptr", rec.ptr)
    tab.reset_launch_counts()
    yield rec
    tab.reset_launch_counts()


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("dtypes", ["bf16 bf16", "bf16 f32", "f32 bf16",
                                    "f32 f32"])
@pytest.mark.parametrize("M,N,K,lead", [
    (127, 769, 5, ()), (128, 768, 33, ()), (129, 70, 768, ()),
    (7, 33, 197, ()), (9, 16, 24, (3,)), (5, 13, 11, (2,))])
def test_cuda_branch_copies_rounds_and_keeps_the_product(
        recorder, M, N, K, lead, trans_b, dtypes):
    """What the kernel is handed: bf16 a and b (each float32 one rounded
    once, counted in ``_gemm_bf16.rounded``), zero-padded or transposed
    copies exactly where the rule asks (counted in ``_gemm_bf16.copies``),
    and operands whose float64 product equals the product of the caller's
    operands rounded to bf16, in the caller's shape."""
    rng = np.random.RandomState(M + N + K)
    da, db = ({"f32": torch.float32, "bf16": torch.bfloat16}[x]
              for x in dtypes.split())
    a = torch.from_numpy(rng.randn(*lead, M, K).astype(np.float32)).to(da)
    b = torch.from_numpy(rng.randn(
        *lead, *((N, K) if trans_b else (K, N))).astype(np.float32)).to(db)
    out = tab._gemm_bf16(recorder, a, b, 0, trans_b=trans_b)
    assert out.shape == (*lead, M, N) and out.dtype == torch.float32
    kp, copy_a, copy_b, launch_t = tab.gemm_bf16_copies(K, N, trans_b)
    assert tab._gemm_bf16.copies == copy_a + copy_b
    assert tab._gemm_bf16.rounded == recorder.rounds == (
        (da == torch.float32) + (db == torch.float32))
    (ga, gb, gt, gk), = recorder.gemms
    assert (gt, gk) == (launch_t, kp)
    want = tab.gemm_plain(a.double(), b.double(), trans_b, fast_dots=True)
    torch.testing.assert_close(out, want.float(), rtol=1e-6, atol=1e-6)
    if not copy_a:   # no copy: the caller's tensor (or its rounding) itself
        assert ga.shape == a.shape


def test_cuda_branch_takes_bf16_aligned_operands_as_they_are(recorder):
    """The main path's operands (bf16, K and N multiples of 8, fresh
    tensors) reach the kernel with no copy and no rounding."""
    a = torch.randn(197, 768).to(torch.bfloat16)
    b = torch.randn(768, 3072).to(torch.bfloat16)
    tab._gemm_bf16(recorder, a, b, 0)
    (ga, gb, gt, gk), = recorder.gemms
    assert ga is a and gb is b and (gt, gk) == (False, 768)
    assert tab._gemm_bf16.copies == tab._gemm_bf16.rounded == 0


def test_cuda_branch_copies_an_operand_off_a_16_byte_boundary(recorder):
    """A view that starts 2 bytes into its storage is copied (counted),
    and the product is unchanged."""
    store = torch.randn(33 * 64 + 1).to(torch.bfloat16)
    a = store[1:].view(33, 64)
    assert a.data_ptr() % 16 != 0
    b = torch.randn(64, 16).to(torch.bfloat16)
    out = tab._gemm_bf16(recorder, a, b, 0)
    assert tab._gemm_bf16.copies == 1
    (ga, _, _, _), = recorder.gemms
    assert ga is not a and torch.equal(ga, a)
    torch.testing.assert_close(
        out, tab.gemm_plain(a.double(), b.double()).float(), rtol=1e-6,
        atol=1e-6)


def test_launch_counters_reset_with_the_wrappers(recorder):
    tab._gemm_bf16(recorder, torch.randn(3, 5), torch.randn(5, 7), 0)
    assert tab._gemm_bf16.copies == 2 and tab._gemm_bf16.rounded == 2
    tab.reset_launch_counts()
    assert tab._gemm_bf16.copies == tab._gemm_bf16.rounded == 0
    assert _build.on_cpu(torch.zeros(1))
