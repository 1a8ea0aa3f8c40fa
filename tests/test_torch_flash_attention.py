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


def _stub_lib(smem_need):
    """The three entry points ``check_attention`` reads, with an H100's
    opt-in limit (232,448 bytes). ``smem_need``: the bytes a block needs,
    or a function of (S, dh, backward) that gives them."""
    need = smem_need if callable(smem_need) else lambda S, dh, bwd: smem_need
    return types.SimpleNamespace(tmx_max_dh=lambda: 128, tmx_attn_smem=need,
                                 tmx_smem_optin=lambda: 232448)


def _smem_at_dh64(S, dh, backward):
    """What csrc/attn_block.cu reports at dh = 64, fixed by dh whatever S:
    the forward's Q tile and K/V rings (52,224 bytes); the backward's two
    64-row blocks, two rings of 32-row tiles and the kv pass's ring of
    query statistics (70,656 bytes)."""
    return 70656 if backward else 52224


@pytest.mark.parametrize("dh,need,S,backward,match", [
    (160, 1000, 2000, True, "head dim 160 > 128"),
    (64, 232449, 2000, True, "needs 232449 bytes of shared memory"),
    (64, 232448, 197, True, None),
    (64, _smem_at_dh64, 4000, False, None),
    (64, _smem_at_dh64, 2000, True, None)])
def test_check_attention_rejects_before_launch(dh, need, S, backward, match):
    if match is None:
        tfa.check_attention(_stub_lib(need), S, dh, backward=backward)
        return
    with pytest.raises(RuntimeError, match=match):
        tfa.check_attention(_stub_lib(need), S, dh, backward=backward)


@pytest.mark.parametrize("offset,shape,make,want", [
    (0, (2, 7, 48), lambda t: tfa.qkv_heads(t, 4), 16),       # merged, dh 4
    (0, (2, 7, 48), lambda t: tfa.qkv_heads(t[..., :45], 3), 4),   # dh 5
    (1, (2, 7, 48), lambda t: tfa.qkv_heads(t, 4), 4),        # base + 4 bytes
    (0, (2, 7, 3, 17), lambda t: [t[..., :16]] * 3, 4),       # row stride 17
    (0, (2, 7, 4, 12), lambda t: [t.transpose(1, 2)] * 3, 16)])
def test_copy_width_follows_dh_strides_and_alignment(offset, shape, make,
                                                     want):
    """The forward's copy width: 16 bytes only where every row of q, k
    and v starts on a 16-byte boundary and dh is a multiple of 4."""
    n = int(np.prod(shape))
    storage = torch.zeros(n + 8)
    start = (-storage.data_ptr() // 4) % 4 + offset   # 16-byte boundary
    t = storage[start:start + n].view(shape)
    assert t.data_ptr() % 16 == 4 * offset
    views = make(t)
    assert tfa.copy_width(views[0].shape[-1], *tfa.view_args(*views)) == want


@pytest.mark.parametrize("B,S,H,dh,pad", [(2, 17, 4, 16, 0), (1, 33, 3, 20, 0),
                                          (2, 9, 2, 8, 5)])
def test_qkv_args_are_those_of_the_split_head_views(B, S, H, dh, pad):
    """The merged-layout launch passes the kernel the pointers and strides
    of ``qkv_heads`` / ``heads`` views, computed without making them (pad:
    a qkv whose rows are longer than 3D, as a column slice)."""
    D = H * dh
    qkv = torch.zeros(B, S, 3 * D + pad)[..., :3 * D]
    out = torch.zeros(B, S, D)
    views = (*tfa.qkv_heads(qkv, H), tfa.heads(out, H))
    assert tfa.qkv_args(qkv, out, H) == tfa.view_args(*views)
