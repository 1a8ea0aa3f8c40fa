"""The port's block kernels (ops/attn_block.py, csrc/attn_block.cu).

On the CPU: each wrapper's plain version against the JAX package's Pallas
kernel (``interpret=True, fast_dots=False``, i.e. full-fp32 dots and the
exact erf), at the small shapes of tests/test_flash_attention.py, plus the
dispatch rules. The CUDA kernels themselves are held to these
plain versions on the card by tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.ops import attn_block_pallas as jab
from transformer_mm_explainability_tpu_torch.ops import _build
from transformer_mm_explainability_tpu_torch.ops import attn_block as tab
from test_torch_kernels_cuda import (ATTN_SHAPES, EPS, MLP_SHAPES, TOL,
                                     attn_bwd, attn_fwd, attn_inputs,
                                     mlp_bwd, mlp_fwd, mlp_inputs, to_torch)

JAX_KW = dict(interpret=True, fast_dots=False)


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("B,H,S,D", ATTN_SHAPES)
def test_attn_block_fwd_plain_matches_pallas(B, H, S, D):
    a = attn_inputs(B, S, D)
    want = np.asarray(attn_fwd(jab, _j(a), H, **JAX_KW))
    np.testing.assert_allclose(attn_fwd(tab, to_torch(a), H).numpy(), want,
                               **TOL)


@pytest.mark.parametrize("B,H,S,D", ATTN_SHAPES)
def test_attn_block_bwd_plain_matches_pallas(B, H, S, D):
    a = attn_inputs(B, S, D, seed=1)
    want_cot, want_e = attn_bwd(jab, _j(a), H, **JAX_KW)
    got_cot, got_e = attn_bwd(tab, to_torch(a), H)
    np.testing.assert_allclose(got_cot.numpy(), np.asarray(want_cot), **TOL)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), **TOL)


@pytest.mark.parametrize("B,S,D,I,chunks", MLP_SHAPES)
def test_mlp_block_fwd_plain_matches_pallas(B, S, D, I, chunks):
    m = mlp_inputs(B, S, D, I)
    want = np.asarray(mlp_fwd(jab, _j(m), chunks, **JAX_KW))
    np.testing.assert_allclose(mlp_fwd(tab, to_torch(m), chunks).numpy(), want,
                               **TOL)


@pytest.mark.parametrize("B,S,D,I,chunks", MLP_SHAPES)
def test_mlp_block_bwd_plain_matches_pallas(B, S, D, I, chunks):
    m = mlp_inputs(B, S, D, I, seed=2)
    want = np.asarray(mlp_bwd(jab, _j(m), chunks, **JAX_KW))
    np.testing.assert_allclose(mlp_bwd(tab, to_torch(m), chunks).numpy(), want,
                               **TOL)


@pytest.mark.parametrize("fn", [mlp_fwd, mlp_bwd])
def test_mlp_chunks_must_divide_hidden(fn):
    m = to_torch(mlp_inputs(1, 5, 16, 48))
    with pytest.raises(AssertionError, match="not divisible by chunks=5"):
        fn(tab, m, 5)


def test_cpu_tensors_take_plain_path_without_launch_or_build():
    """A CPU tensor goes to the plain version: no launch counted, nothing
    built or loaded."""
    tab.reset_launch_counts()
    a = to_torch(attn_inputs(1, 5, 16))
    m = to_torch(mlp_inputs(1, 5, 16, 32))
    attn_fwd(tab, a, 2)
    attn_bwd(tab, a, 2)
    mlp_fwd(tab, m, 4)
    mlp_bwd(tab, m, 4)
    assert tab.launch_counts() == {"attn_block_fwd": 0, "mlp_block_fwd": 0,
                                   "mlp_block_bwd": 0, "attn_block_bwd": 0}
    assert "attn_block" not in _build._loaded


def test_other_devices_raise():
    a = to_torch(attn_inputs(1, 5, 16), device="meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        attn_fwd(tab, a, 2)


def _gemm_case(case):
    """Operands of ``_gemm`` that the kernel would misread: a 3-D a with a
    shared 2-D b (its row stride taken for a batch stride), and others."""
    z = lambda *s: torch.zeros(s)
    a, b, kw = z(3, 5, 8), z(3, 8, 6), {}
    if case == "shared 2-D b":
        b = z(8, 6)
    elif case == "2-D out":
        kw["out"] = z(5, 6)
    elif case == "2-D res":
        kw["res"] = z(5, 6)
    elif case == "other batch":
        b = z(2, 8, 6)
    elif case == "other K":
        b = z(3, 7, 6)
    elif case == "transposed a":
        a = z(3, 8, 5).transpose(1, 2)
    elif case == "float64 aux":
        kw.update(aux=z(3, 5, 6).double(), act=tab._ACT_MUL_GELU_GRAD)
    elif case == "bias of other N":
        kw["bias"] = z(5)
    elif case == "4-D a":
        a, b = z(1, 3, 5, 8), z(1, 3, 8, 6)
    return a, b, kw


@pytest.mark.parametrize("case,match", [
    ("shared 2-D b", "both be 2-D or both 3-D"), ("4-D a", "both be 2-D"),
    ("2-D out", "out has shape"), ("2-D res", "res has shape"),
    ("other batch", "b has shape"), ("other K", "b has shape"),
    ("transposed a", "a must be contiguous"), ("float64 aux", "float64"),
    ("bias of other N", "bias has shape")])
def test_gemm_refuses_operands_before_launch(case, match):
    """``_gemm`` checks its operands before it touches the library: with no
    library at all, each bad case raises its own error."""
    a, b, kw = _gemm_case(case)
    with pytest.raises(RuntimeError, match=match):
        tab._gemm(None, a, b, 0, **kw)


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "NVCC_DEFAULT", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_library_path_tracks_source_and_flags(monkeypatch):
    p = _build.library_path("attn_block")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("libattn_block-")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("attn_block") != p


def test_library_path_tracks_headers(monkeypatch, tmp_path):
    """A source's library is rebuilt when a header it can include changes,
    not only when the source does."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    first = _build.library_path("k")
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert _build.library_path("k") != first
    second = _build.library_path("k")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "extra.h").write_text("// new header\n")
    third = _build.library_path("k")
    assert third not in (first, second)
    (tmp_path / "notes.txt").write_text("not a header")
    assert _build.library_path("k") == third
