"""bf16 storage with fp32 products, and RoIPool on bf16 features, on the CPU.

The JAX kernels take bfloat16 tensors without ``fast_dots``: each upcasts
its inputs on load (``attn_block_pallas._fwd_kernel``'s
``x_ref[0].astype(jnp.float32)``, the same in ``flash_attention``), runs
its arithmetic in fp32 and writes the outputs in the inputs' dtype, e_row in
float32. The port's plain versions compute the same function, and its
CUDA wrappers route such a call to the fp32 kernels of
``csrc/attn_block.cu``, which read and write bf16 themselves (their bf16
instances in ``csrc/attn_block_s16.cu``; ``tests/test_torch_kernels_cuda.py``
holds them on the card to the fp32 kernels on the widened tensors, to the
bit). The JAX RoIPool keeps the features' dtype; the port's takes bf16
features with float32 boxes.

Here, at the tiny widths of ``tests/test_torch_fast_dots.py`` (B=2, S=17,
D=64, H=4, I=256) on inputs rounded to bf16:
  * each of the eight wrappers' plain versions on bfloat16 tensors with
    ``fast_dots=False`` against the JAX wrapper on the same bfloat16 arrays
    in interpret mode. The two round each bf16 output once from fp32 values
    that XLA and torch compute in different orders (an ulp apart here and
    there), so a value that sits on a bf16 rounding edge may round to the
    neighbouring bf16 value: the bf16 outputs equal JAX's but for at most
    1/256 of their elements (measured 0-3 of 2,176-6,528), and those lie
    within 2⁻⁷ · max|ref| of it (a rounding at an edge, after a sum that may
    cancel; measured ≤ 7.1e-4), the bar of ``tests/test_torch_fast_dots.py``
    for bf16 outputs. Float32 outputs (e_row): within 1e-5 · max|ref|
    (measured ≤ 2.6e-7);
  * ``roi_pool_plain`` on bf16 features against the JAX kernel in
    interpret mode: equal to the bit, bfloat16;
  * the wrappers' CUDA branch with a stand-in library (nothing built): the
    fp32 entry points only, with the bf16 flags and dtype bits they pass,
    the bf16 tensors' own pointers (no widened copy), float32
    intermediates and outputs in the inputs' dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.ops import attn_block_pallas as jab
from transformer_mm_explainability_tpu.ops import flash_attention as jfa
from transformer_mm_explainability_tpu.ops import roi_pool_pallas as jroi
from transformer_mm_explainability_tpu_torch.ops import attn_block as tab
from transformer_mm_explainability_tpu_torch.ops import flash_attention as tfa
from transformer_mm_explainability_tpu_torch.ops import (
    roi_pool_pallas as trpool)
from test_torch_fast_dots import (CALLS, INPUTS, SEEDS, _bf16_values,
                                  _fake_cuda, _tuple)
from test_torch_kernels_cuda import roi_inputs

FP32_BAR = 1e-5
FLIP_SHARE = 1 / 256
BF16_BAR = 2.0 ** -7


def _bf16_tensors(arrays):
    return {k: torch.from_numpy(v) if k == "r" else
            torch.from_numpy(v).bfloat16() for k, v in arrays.items()}


@pytest.mark.parametrize("name", list(CALLS))
def test_plain_bf16_storage_matches_jax_upcast_kernels(name):
    kind, call = CALLS[name]
    arrays = _bf16_values(INPUTS[kind](SEEDS.get(name, 0)))
    jmod = jab if kind in ("attn", "mlp") else jfa
    want = _tuple(call(jmod, {k: jnp.asarray(v, jnp.float32 if k == "r"
                                             else jnp.bfloat16)
                              for k, v in arrays.items()}, interpret=True))
    mod = tab if kind in ("attn", "mlp") else tfa
    got = _tuple(call(mod, _bf16_tensors(arrays), fast_dots=False))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = torch.from_numpy(np.asarray(jnp.asarray(w, jnp.float32)))
        if g.dtype == torch.float32:     # e_row
            top = float(w.abs().max())
            assert float((g - w).abs().max()) <= FP32_BAR * top, (name, i)
            continue
        assert g.dtype == torch.bfloat16, (name, i, g.dtype)
        diff = (g.float() - w).abs()
        flips = int((diff != 0).sum())
        top = float(diff.max()) / float(w.abs().max())
        assert flips <= FLIP_SHARE * g.numel() and top <= BF16_BAR, \
            (name, i, flips, top)


def test_roi_pool_plain_bf16_matches_jax_kernel():
    feats, boxes = roi_inputs(9, 13, 8, 40, seed=3)
    want = jroi.roi_pool_pallas(jnp.asarray(feats, jnp.bfloat16),
                                jnp.asarray(boxes), 7, 1 / 16,
                                interpret=True)
    assert want.dtype == jnp.bfloat16
    got = trpool.roi_pool_pallas(torch.from_numpy(feats).bfloat16(),
                                 torch.from_numpy(boxes), 7, 1 / 16)
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(np.asarray(jnp.asarray(want, jnp.float32)))
    assert torch.equal(got.float(), want)
    # the bf16 map's maxima are the fp32 map's on the same values
    f32 = trpool.roi_pool_plain(torch.from_numpy(feats).bfloat16().float(),
                                torch.from_numpy(boxes), 7, 1 / 16)
    assert torch.equal(got.float(), f32)


def test_roi_pool_takes_float32_boxes_only():
    """bf16 boxes raise on either device: the kernel computes its bins from
    fp32 box coordinates (an intended departure from the JAX wrapper,
    whose ``roi_bin_bounds`` rounds in the boxes' dtype)."""
    feats, boxes = roi_inputs(5, 6, 4, 3)
    f, b = torch.from_numpy(feats), torch.from_numpy(boxes)
    for feat in (f, f.bfloat16()):
        with pytest.raises(RuntimeError, match="float32 boxes"):
            trpool.roi_pool_pallas(feat, b.bfloat16(), 7, 1 / 16)
    with pytest.raises(RuntimeError, match="float32 or bfloat16"):
        trpool.roi_pool_pallas(f.half(), b, 7, 1 / 16)


A, B_, OUT, BIAS, RES = (tab._BF16_BITS[k]
                         for k in ("a", "b", "out", "bias", "res"))
# each wrapper's GEMMs on bf16 storage: (trans_b, act, dtypes, the
# tensors whose pointers reach the kernel as they are, by argument slot:
# 0 a, 1 b, 7 bias, 8 res)
GEMMS = {
    "attn_block_fwd": [(0, 0, B_ | BIAS, {1: "wqkv", 7: "bqkv"}),
                       (0, 0, B_ | OUT | BIAS | RES,
                        {1: "wout", 7: "bout", 8: "x"})],
    "attn_block_bwd": [(0, 0, B_ | BIAS, {1: "wqkv", 7: "bqkv"}),
                       (1, 0, A | B_, {0: "cot", 1: "wout"}),
                       (1, 0, B_, {1: "wqkv"})],
    "mlp_block_fwd": [(0, 1, B_ | BIAS, {1: "w1", 7: "b1"}),
                      (0, 0, B_ | OUT | BIAS | RES,
                       {1: "w2", 7: "b2", 8: "x"})],
    "mlp_block_bwd": [(0, 0, B_ | BIAS, {1: "w1", 7: "b1"}),
                      (1, 2, A | B_, {0: "cot", 1: "w2"}),
                      (1, 0, B_, {1: "w1"})],
}


@pytest.mark.parametrize("name", list(CALLS))
def test_cuda_branch_reads_bf16_storage_in_place(name, monkeypatch):
    """bf16 tensors without fast_dots: the fp32 library's entry points only
    (no ``*_bf16`` entry, no rounding kernel), counted in ``launches``;
    the GEMM's dtype bits mark exactly the bf16 tensors, the LayerNorm
    rows and the attention take the bf16 flag where their operands are
    bf16, and every bf16 operand reaches the kernel by its own pointer;
    the block branches' intermediates (LN outputs, qkv, the merged output,
    a1, dqkv) are float32, the outputs bfloat16, e_row float32."""
    fake = _fake_cuda(monkeypatch)
    tab.reset_launch_counts()
    tfa.reset_launch_counts()
    kind, call = CALLS[name]
    t = _bf16_tensors(_bf16_values(INPUTS[kind](SEEDS.get(name, 0))))
    out = _tuple(call(tab if kind in ("attn", "mlp") else tfa, t,
                      fast_dots=False))
    names = [n for n, _ in fake.calls]
    assert not any(n.endswith(("_bf16", "_any")) for n in names), names
    mod = tab if kind in ("attn", "mlp") else tfa
    assert getattr(mod, name).launches == 1
    assert getattr(mod, name).launches_bf16 == 0
    e_row = name in ("attn_block_bwd", "flash_bwd_ehat", "flash_bwd_ehat_qkv")
    for i, o in enumerate(out):
        last = i == len(out) - 1
        assert o.dtype == (torch.float32 if e_row and last
                           else torch.bfloat16), (name, i, o.dtype)
    ptr = lambda k: t[k].data_ptr()
    if kind == "flash":
        which = "tmx_attn_bwd" if "bwd" in name else "tmx_attn_fwd"
        (args,) = [a for n, a in fake.calls if n == which]
        operands = ["q", "k", "v"] + (["dout"] if "bwd" in name else [])
        if name.endswith("qkv"):     # q, k, v of the merged bf16 qkv
            want = [ptr("qkv") + 2 * 64 * j for j in range(3)]
            want += [ptr("dmerged")] if "bwd" in name else []
        else:
            want = [ptr(k) for k in operands]
        got_ptrs = list(args[:3]) + ([args[3]] if "bwd" in name else [])
        assert got_ptrs == want, name
        assert args[-3] == 1                     # is_bf16
        assert args[-2] == 16                    # dh 16: 8-element copies
        return
    gemms = [(a[6], a[10], a[11], a) for n, a in fake.calls
             if n == "tmx_gemm"]
    assert [g[:3] for g in gemms] == [g[:3] for g in GEMMS[name]], name
    for (_, _, _, args), (_, _, _, slots) in zip(gemms, GEMMS[name]):
        for slot, key in slots.items():
            assert args[slot] == ptr(key), (name, slot, key)
    lns = [a for n, a in fake.calls if n == "tmx_layer_norm"]
    assert len(lns) == 1 and lns[0][9] == 1
    assert lns[0][:3] == (ptr("x"), ptr("g1" if kind == "attn" else "g2"),
                          ptr("b1" if kind == "attn" else "bb2"))
    vjps = [a for n, a in fake.calls if n == "tmx_layer_norm_vjp"]
    assert len(vjps) == int(name.endswith("bwd"))
    for a in vjps:
        assert a[9] == 1 and (a[1], a[5]) == (ptr("x"), ptr("cot"))
    attn = [a for n, a in fake.calls if n in ("tmx_attn_fwd", "tmx_attn_bwd")]
    assert len(attn) == int(kind == "attn")
    assert all(a[-3] == 0 for a in attn)   # the float32 qkv intermediate


def test_roi_pool_cuda_branch_reads_bf16_features(monkeypatch):
    fake = _fake_cuda(monkeypatch)
    feats, boxes = roi_inputs(5, 6, 8, 3)
    f = torch.from_numpy(feats).bfloat16()
    b = torch.from_numpy(boxes)
    trpool.reset_launch_counts()
    out = trpool.roi_pool_pallas(f, b, 7, 1 / 16)
    assert out.dtype == torch.bfloat16 and out.shape == (3, 7, 7, 8)
    (args,) = [a for n, a in fake.calls if n == "tmx_roi_pool"]
    assert args[0] == f.data_ptr() and args[2] == out.data_ptr()
    assert args[-2] == 1 and trpool.roi_pool_pallas.launches == 1
