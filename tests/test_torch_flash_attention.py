"""The port's fused attention (ops/flash_attention.py) against the JAX
package's Pallas kernels.

On the CPU each wrapper runs its plain version; it is held to the JAX
kernel in interpret mode with full-fp32 dots (``interpret=True,
fast_dots=False``) at the shapes of tests/test_flash_attention.py. The
CUDA kernels are held to these plain versions on the card by
tests/test_torch_kernels_cuda.py.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.ops import flash_attention as jfa
from transformer_mm_explainability_tpu_torch.ops import _build
from transformer_mm_explainability_tpu_torch.ops import flash_attention as tfa
from test_torch_kernels_cuda import FLASH_SHAPES, flash_inputs

JAX_KW = dict(interpret=True, fast_dots=False)
TOL = dict(rtol=1e-5, atol=1e-6)


def _both(arrays):
    """(JAX arrays, torch tensors) of the same numpy inputs."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("B,H,S,Dh", FLASH_SHAPES)
def test_flash_fwd_plain_matches_pallas(B, H, S, Dh):
    f = flash_inputs(B, H, S, Dh)
    j, t = _both([f["q"], f["k"], f["v"]])
    _close([tfa.flash_fwd(*t)], [jfa.flash_fwd(*j, **JAX_KW)])


@pytest.mark.parametrize("B,H,S,Dh", FLASH_SHAPES)
def test_flash_bwd_ehat_plain_matches_pallas(B, H, S, Dh):
    f = flash_inputs(B, H, S, Dh, seed=1)
    j, t = _both([f["q"], f["k"], f["v"], f["dout"], f["r"]])
    _close(tfa.flash_bwd_ehat(*t), jfa.flash_bwd_ehat(*j, **JAX_KW))


@pytest.mark.parametrize("B,H,S,Dh", FLASH_SHAPES)
def test_flash_fwd_qkv_plain_matches_pallas(B, H, S, Dh):
    f = flash_inputs(B, H, S, Dh, seed=2)
    j, t = _both([f["qkv"]])
    _close([tfa.flash_fwd_qkv(*t, H)], [jfa.flash_fwd_qkv(*j, H, **JAX_KW)])


@pytest.mark.parametrize("B,H,S,Dh", FLASH_SHAPES)
def test_flash_bwd_ehat_qkv_plain_matches_pallas(B, H, S, Dh):
    f = flash_inputs(B, H, S, Dh, seed=3)
    j, t = _both([f["qkv"], f["dmerged"], f["r"]])
    _close(tfa.flash_bwd_ehat_qkv(*t, H),
           jfa.flash_bwd_ehat_qkv(*j, H, **JAX_KW))


@pytest.mark.parametrize("B,H,S,Dh", FLASH_SHAPES)
def test_split_head_views_match_qkv_wrappers(B, H, S, Dh):
    """The per-head wrappers on split-head views of a qkv tensor give what
    the qkv wrappers give on the tensor itself."""
    f = {k: torch.from_numpy(v) for k, v in flash_inputs(B, H, S, Dh).items()}
    views = tfa.qkv_heads(f["qkv"], H)
    assert all(v.data_ptr() >= f["qkv"].data_ptr() for v in views)
    out = tfa.flash_fwd(*views)
    torch.testing.assert_close(out, tfa.heads(tfa.flash_fwd_qkv(f["qkv"], H),
                                              H), rtol=0, atol=0)
    *grads, e_row = tfa.flash_bwd_ehat(*views, tfa.heads(f["dmerged"], H),
                                       f["r"])
    dqkv, e_qkv = tfa.flash_bwd_ehat_qkv(f["qkv"], f["dmerged"], f["r"], H)
    for g, want in zip(grads, tfa.qkv_heads(dqkv, H)):
        torch.testing.assert_close(g, want, rtol=0, atol=0)
    torch.testing.assert_close(e_row, e_qkv, rtol=0, atol=0)


def test_cpu_tensors_take_plain_path_without_launch_or_build():
    tfa.reset_launch_counts()
    f = {k: torch.from_numpy(v) for k, v in flash_inputs(1, 2, 5, 4).items()}
    tfa.flash_fwd(f["q"], f["k"], f["v"])
    tfa.flash_bwd_ehat(f["q"], f["k"], f["v"], f["dout"], f["r"])
    tfa.flash_fwd_qkv(f["qkv"], 2)
    tfa.flash_bwd_ehat_qkv(f["qkv"], f["dmerged"], f["r"], 2)
    assert set(tfa.launch_counts().values()) == {0}
    assert "attn_block" not in _build._loaded


def test_other_devices_raise():
    q = torch.zeros((1, 2, 5, 4), device="meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        tfa.flash_fwd(q, q, q)


def _stub_lib(smem_need: int):
    """The three entry points ``check_attention`` reads, with an H100's
    opt-in limit (232,448 bytes)."""
    return types.SimpleNamespace(tmx_max_dh=lambda: 128,
                                 tmx_attn_smem=lambda S, dh, bwd: smem_need,
                                 tmx_smem_optin=lambda: 232448)


@pytest.mark.parametrize("dh,need,match", [
    (160, 1000, "head dim 160 > 128"),
    (64, 232449, "needs 232449 bytes of shared memory"),
    (64, 232448, None)])
def test_check_attention_rejects_before_launch(dh, need, match):
    if match is None:
        tfa.check_attention(_stub_lib(need), 197, dh, backward=True)
        return
    with pytest.raises(RuntimeError, match=match):
        tfa.check_attention(_stub_lib(need), 2000, dh, backward=True)
