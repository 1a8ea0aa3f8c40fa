"""The port's CUDA kernels (csrc/attn_block.cu, csrc/attn_block_bf16.cu,
csrc/relevancy_chain.cu, csrc/roi_pool.cu) against their plain versions, on
the card; their GEMMs (csrc/common.cuh) also against float64. The DETR
explanation path, which runs no kernel of the port, on the card against the
CPU.

Every test here is marked ``cuda`` and skips where there is no CUDA
device. The file imports neither JAX nor the JAX package, so it runs on a
machine with PyTorch alone; there, skip the repository's conftest (it
configures JAX):

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

The input builders below are shared with tests/test_torch_attn_block.py,
tests/test_torch_flash_attention.py, tests/test_torch_relevancy_chain.py and
tests/test_torch_frcnn.py, which hold the plain versions to the JAX package
on the CPU.
"""

import re

import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu_torch.models import frcnn as tfrcnn
from transformer_mm_explainability_tpu_torch.models import vit as tvit
from transformer_mm_explainability_tpu_torch.ops import _build
from transformer_mm_explainability_tpu_torch.ops import attn_block as tab
from transformer_mm_explainability_tpu_torch.ops import flash_attention as tfa
from transformer_mm_explainability_tpu_torch.ops import relevancy_pallas as trp
from transformer_mm_explainability_tpu_torch.ops import roi_pool_pallas as trpool

# different fp32 reduction orders (per-head 2D dots, chunked hidden dim vs
# whole-matrix products): a few-ulp spread on O(10) magnitudes
TOL = dict(rtol=5e-4, atol=1e-4)
EPS = 1e-6
ATTN_SHAPES = [(2, 4, 17, 64), (1, 6, 49, 96)]
MLP_SHAPES = [(2, 17, 64, 256, 4), (1, 9, 32, 96, 3)]
# (B, H, S, dh): the shapes of tests/test_flash_attention.py; then a ragged
# third 64-key tile (S = 130) and head dims that are not a multiple of 16
# (40, 24) or of 8 (20)
FLASH_SHAPES = [(2, 4, 17, 16), (1, 2, 33, 8), (2, 4, 17, 64), (1, 6, 49, 96),
                (1, 3, 130, 40), (1, 2, 65, 24), (1, 2, 65, 20)]


def attn_inputs(B, S, D, seed=0):
    """x, cot, r and attention weights; weights at 1/√D keep logits O(1)."""
    rng = np.random.RandomState(seed)
    f = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)
    w = lambda *s: (rng.randn(*s) / np.sqrt(D)).astype(np.float32)
    x = f(B, S, D)
    wqkv, bqkv = w(D, 3 * D), 0.1 * f(3 * D)
    wout, bout = w(D, D), 0.1 * f(D)
    g1, b1 = 1.0 + 0.1 * f(D), 0.1 * f(D)
    cot = f(B, S, D)
    r = rng.rand(B, S).astype(np.float32)
    return dict(x=x, cot=cot, r=r, wqkv=wqkv, bqkv=bqkv, wout=wout,
                bout=bout, g1=g1, b1=b1)


def mlp_inputs(B, S, D, I, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)
    w = lambda *s: (rng.randn(*s) / np.sqrt(D)).astype(np.float32)
    return dict(x=f(B, S, D), cot=f(B, S, D), w1=w(D, I), b1=0.1 * f(I),
                w2=w(I, D), b2=0.1 * f(D), g2=1.0 + 0.1 * f(D),
                bb2=0.1 * f(D))


def flash_inputs(B, H, S, Dh, seed=0):
    """A merged qkv [B, S, 3D], a merged cotangent [B, S, D], r [B, S], and
    contiguous per-head copies q, k, v, dout [B, H, S, Dh] of them."""
    rng = np.random.RandomState(seed)
    D = H * Dh
    f = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)
    qkv, dmerged = f(B, S, 3 * D), f(B, S, D)
    r = rng.rand(B, S).astype(np.float32)
    split = lambda x: np.ascontiguousarray(
        x.reshape(B, S, H, Dh).transpose(0, 2, 1, 3))
    q, k, v = (split(t) for t in np.split(qkv, 3, axis=-1))
    return dict(qkv=qkv, dmerged=dmerged, r=r, q=q, k=k, v=v,
                dout=split(dmerged))


def chain_inputs(B, L, H, S, seed=0):
    """Attention-like captures [B, L, H, S, S] (rows of |randn| summing to
    one) and gradients."""
    rng = np.random.RandomState(seed)
    cams = np.abs(rng.randn(B, L, H, S, S)).astype(np.float32)
    cams /= cams.sum(-1, keepdims=True)
    grads = rng.randn(B, L, H, S, S).astype(np.float32)
    return cams, grads


def chain_f64(cams, grads, start_layer=0):
    """The rule-6 chain in float64, [B, L, H, S, S] x2 -> [B, S, S]: Ê_l =
    mean_h relu(A ∘ G), R ← R + Ê_l·R from R = I. (The port's plain chain
    takes its Ê in fp32 whatever the captures' dtype.)"""
    e = torch.clamp(cams.double() * grads.double(), min=0).mean(dim=2)
    e = e[:, start_layer:]
    B, S = cams.shape[0], cams.shape[-1]
    R = torch.eye(S, dtype=torch.float64, device=cams.device).expand(B, S, S)
    for i in range(e.shape[1]):
        R = R + e[:, i] @ R
    return R


def roi_inputs(H, W, C, K, seed=0, stride=16):
    """A feature map [H, W, C] and K xyxy boxes over its H·stride × W·stride
    image; the first three (where K allows) are a tiny, a clipped and a
    degenerate box."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(H, W, C).astype(np.float32)
    b = rng.rand(K, 4).astype(np.float32)
    x0, y0 = b[:, 0] * W * stride * 0.9, b[:, 1] * H * stride * 0.9
    boxes = np.stack([x0, y0, x0 + b[:, 2] * W * stride * 0.6,
                      y0 + b[:, 3] * H * stride * 0.6], 1)
    special = [[0, 0, 2, 2],                                        # tiny
               [W * stride - 3, H * stride - 3, W * stride + 50,
                H * stride + 50],                                   # clipped
               [5, 5, 5, 5]]                                        # degenerate
    n = min(K, len(special))
    boxes[:n] = special[:n]
    return feats, boxes.astype(np.float32)


def roi_edge_boxes(H, W, stride=16):
    """xyxy boxes over the H·stride × W·stride image that exercise the bin
    arithmetic: roi < P, past the map's edges, outside it, degenerate,
    inverted, corners on and just under the .5 rounding edge, the whole
    map."""
    Wi, Hi = W * stride, H * stride
    return np.array([
        [0, 0, 2, 2],                          # tiny: roi 1 < P
        [Wi - 3, Hi - 3, Wi + 50, Hi + 50],    # past the right / lower edge
        [-90, -70, -20, -30],                  # wholly above-left of the map
        [Wi + 40, 10, Wi + 90, 60],            # wholly right of the map
        [5, 5, 5, 5],                          # degenerate
        [60, 50, 20, 10],                      # inverted: roi clamped to 1
        [24, 40, 56, 88],                      # x·s + 0.5 exactly an integer
        [23.999998, 39.999996, 55.999996, 87.99999],   # just under it
        [8, 8, 8 + 16 * 5, 8 + 16 * 3],        # roi 6 and 4 (< P = 14)
        [0, 0, Wi - 1, Hi - 1],                # the whole map
        [-30, 20, Wi / 2, Hi + 30],            # clipped on two sides
    ], np.float32)


# TINY of tests/test_frcnn.py
FRCNN_TINY = dict(stages=(1, 1, 1, 1), anchor_sizes=(32, 64),
                  aspect_ratios=(1.0,), pre_nms_topk=50, post_nms_topk=12,
                  pooler_resolution=4, num_classes=9, num_attrs=5,
                  max_detections=6)


def to_torch(d, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in d.items()}


def attn_fwd(mod, a, H, **kw):
    return mod.attn_block_fwd(a["x"], a["wqkv"], a["bqkv"], a["wout"],
                              a["bout"], a["g1"], a["b1"], H, EPS, **kw)


def attn_bwd(mod, a, H, **kw):
    return mod.attn_block_bwd(a["x"], a["cot"], a["r"], a["wqkv"], a["bqkv"],
                              a["wout"], a["g1"], a["b1"], H, EPS, **kw)


def mlp_fwd(mod, m, chunks, **kw):
    return mod.mlp_block_fwd(m["x"], m["w1"], m["b1"], m["w2"], m["b2"],
                             m["g2"], m["bb2"], EPS, chunks=chunks, **kw)


def mlp_bwd(mod, m, chunks, **kw):
    return mod.mlp_block_bwd(m["x"], m["cot"], m["w1"], m["b1"], m["w2"],
                             m["g2"], m["bb2"], EPS, chunks=chunks, **kw)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CUDA_ATTN = ATTN_SHAPES + [(8, 12, 197, 768)]
CUDA_MLP = MLP_SHAPES + [(8, 197, 768, 3072, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,D", CUDA_ATTN)
def test_attn_block_fwd_kernel_matches_plain(cuda, B, H, S, D):
    a = to_torch(attn_inputs(B, S, D), cuda)
    before = tab.attn_block_fwd.launches
    got = attn_fwd(tab, a, H)
    torch.cuda.synchronize()
    assert tab.attn_block_fwd.launches == before + 1
    want = tab.attn_block_fwd_plain(a["x"], a["wqkv"], a["bqkv"], a["wout"],
                                    a["bout"], a["g1"], a["b1"], H, EPS)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,D", CUDA_ATTN)
def test_attn_block_bwd_kernel_matches_plain(cuda, B, H, S, D):
    a = to_torch(attn_inputs(B, S, D, seed=1), cuda)
    got_cot, got_e = attn_bwd(tab, a, H)
    torch.cuda.synchronize()
    want_cot, want_e = tab.attn_block_bwd_plain(
        a["x"], a["cot"], a["r"], a["wqkv"], a["bqkv"], a["wout"], a["g1"],
        a["b1"], H, EPS)
    torch.testing.assert_close(got_cot, want_cot, **TOL)
    torch.testing.assert_close(got_e, want_e, **TOL)
    again_cot, again_e = attn_bwd(tab, a, H)
    # no atomics: the same inputs give the same bits
    assert torch.equal(again_cot, got_cot) and torch.equal(again_e, got_e)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,I,chunks", CUDA_MLP)
def test_mlp_block_kernels_match_plain(cuda, B, S, D, I, chunks):
    m = to_torch(mlp_inputs(B, S, D, I), cuda)
    got_f, got_b = mlp_fwd(tab, m, chunks), mlp_bwd(tab, m, chunks)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_f, tab.mlp_block_fwd_plain(
        m["x"], m["w1"], m["b1"], m["w2"], m["b2"], m["g2"], m["bb2"], EPS,
        chunks), **TOL)
    torch.testing.assert_close(got_b, tab.mlp_block_bwd_plain(
        m["x"], m["cot"], m["w1"], m["b1"], m["w2"], m["g2"], m["bb2"], EPS,
        chunks), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("key,bad,match", [
    ("x", lambda t: t.transpose(0, 1).contiguous().transpose(0, 1),
     "contiguous"),
    ("bqkv", lambda t: t[:-1], "shape"),
    ("wout", lambda t: t.double(), "float32"),
    ("g1", lambda t: t.cpu(), "expected cuda")])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda, key, bad,
                                                            match):
    a = to_torch(attn_inputs(2, 5, 16), cuda)
    a[key] = bad(a[key])
    with pytest.raises(RuntimeError, match=match):
        attn_fwd(tab, a, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("width,heads", [(64, 4), (96, 6)])
def test_slice_on_kernels_matches_plain_chains(cuda, width, heads):
    """relevancy_fused_block2 through the kernels == relevancy and
    relevancy_streamed_row in plain torch on the card (max|Δ| < 1e-4)."""
    cfg = tvit.ViTConfig(image_size=64, patch_size=16, width=width, depth=3,
                         num_heads=heads, num_classes=10)
    model = tvit.init_params(0, cfg, cuda)
    gen = torch.Generator().manual_seed(1)
    images = torch.randn((3, 64, 64, 3), generator=gen).to(cuda)
    targets = torch.tensor([1, 2, 3], device=cuda)
    tab.reset_launch_counts()
    got = tvit.relevancy_fused_block2(model, images, targets)
    assert set(tab.launch_counts().values()) == {cfg.depth}
    for ref in (tvit.relevancy(model, images, targets),
                tvit.relevancy_streamed_row(model, images, targets)):
        assert float((got - ref).abs().max()) < 1e-4


# ---------------------------------------------------------------------------
# ops/flash_attention and ops/relevancy_pallas
# ---------------------------------------------------------------------------

CUDA_FLASH = FLASH_SHAPES + [(8, 12, 197, 64), (1, 2, 300, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,Dh", CUDA_FLASH)
def test_flash_kernels_match_plain(cuda, B, H, S, Dh):
    f = to_torch(flash_inputs(B, H, S, Dh), cuda)
    per_head = (f["q"], f["k"], f["v"])
    tfa.reset_launch_counts()
    calls = [
        (tfa.flash_fwd(*per_head), tfa.flash_fwd_plain(*per_head)),
        (tfa.flash_bwd_ehat(*per_head, f["dout"], f["r"]),
         tfa.flash_bwd_ehat_plain(*per_head, f["dout"], f["r"])),
        (tfa.flash_fwd_qkv(f["qkv"], H),
         tfa.flash_fwd_qkv_plain(f["qkv"], H)),
        (tfa.flash_bwd_ehat_qkv(f["qkv"], f["dmerged"], f["r"], H),
         tfa.flash_bwd_ehat_qkv_plain(f["qkv"], f["dmerged"], f["r"], H))]
    torch.cuda.synchronize()
    assert set(tfa.launch_counts().values()) == {1}
    for got, want in calls:
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,Dh", CUDA_FLASH)
def test_flash_views_equal_qkv_kernels_and_repeat_bits(cuda, B, H, S, Dh):
    """The per-head kernels on split-head views of qkv write what the qkv
    kernels write (same bits), and a second run gives the same bits."""
    f = to_torch(flash_inputs(B, H, S, Dh, seed=1), cuda)
    views = tfa.qkv_heads(f["qkv"], H)
    dout = tfa.heads(f["dmerged"], H)
    assert not views[0].is_contiguous() and not dout.is_contiguous()
    out = tfa.flash_fwd(*views)
    assert torch.equal(out, tfa.heads(tfa.flash_fwd_qkv(f["qkv"], H), H))
    *grads, e_row = tfa.flash_bwd_ehat(*views, dout, f["r"])
    dqkv, e_qkv = tfa.flash_bwd_ehat_qkv(f["qkv"], f["dmerged"], f["r"], H)
    for g, want in zip(grads, tfa.qkv_heads(dqkv, H)):
        assert torch.equal(g, want)
    assert torch.equal(e_row, e_qkv)
    again = tfa.flash_bwd_ehat_qkv(f["qkv"], f["dmerged"], f["r"], H)
    assert torch.equal(again[0], dqkv) and torch.equal(again[1], e_qkv)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,Dh", [(8, 12, 197, 64), (1, 2, 300, 128)])
def test_flash_fwd_within_1e5_of_float64(cuda, B, H, S, Dh):
    """The forward's 3xTF32 products are fp32-accurate: within 1e-5 of the
    plain version run in float64 on the same inputs, where one TF32
    product (about 10 mantissa bits) misses on these O(1) values."""
    f = to_torch(flash_inputs(B, H, S, Dh, seed=4), cuda)
    want = tfa.flash_fwd_qkv_plain(f["qkv"].double(), H)
    got = tfa.flash_fwd_qkv(f["qkv"], H)
    assert float((got.double() - want).abs().max()) <= 1e-5
    got = tfa.flash_fwd(f["q"], f["k"], f["v"])
    want = tfa.flash_fwd_plain(f["q"].double(), f["k"].double(),
                               f["v"].double())
    assert float((got.double() - want).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_flash_fwd_long_sequence_matches_plain(cuda):
    """S = 4,000: the forward's shared memory is fixed by dh, so a length
    past the old score-row ceiling (about 3,300 at dh = 64) runs."""
    f = to_torch(flash_inputs(1, 2, 4000, 64, seed=5), cuda)
    tfa.reset_launch_counts()
    got = tfa.flash_fwd(f["q"], f["k"], f["v"])
    torch.cuda.synchronize()
    assert tfa.launch_counts()["flash_fwd"] == 1
    torch.testing.assert_close(
        got, tfa.flash_fwd_plain(f["q"], f["k"], f["v"]), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2000, 4000])
def test_flash_bwd_long_sequence_matches_plain(cuda, S):
    """S = 2,000 and 4,000: the backward's shared memory is fixed by dh
    (the same need at S = 197), so lengths past the old score-row ceiling
    (about 1,490 at dh = 64) run."""
    lib = tfa.library()
    assert lib.tmx_attn_smem(S, 64, 1) == lib.tmx_attn_smem(197, 64, 1)
    f = to_torch(flash_inputs(1, 2, S, 64, seed=5), cuda)
    args = (f["q"], f["k"], f["v"], f["dout"], f["r"])
    tfa.reset_launch_counts()
    got = tfa.flash_bwd_ehat(*args)
    torch.cuda.synchronize()
    assert tfa.launch_counts()["flash_bwd_ehat"] == 1
    for g, w in zip(got, tfa.flash_bwd_ehat_plain(*args)):
        torch.testing.assert_close(g, w, **TOL)


def assert_within_of_f64(got, want, bar=1e-5):
    """max|Δ| from the float64 result within ``bar`` · max|want|."""
    err = float((got.double() - want).abs().max())
    scale = float(want.abs().max())
    assert err <= bar * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,Dh", FLASH_SHAPES + [(8, 12, 197, 64)])
def test_flash_bwd_within_1e5_of_float64(cuda, B, H, S, Dh):
    """The backward's 3xTF32 products are fp32-accurate: each of dq, dk,
    dv and e_row, per-head and merged, within 1e-5 · max|ref| of the plain
    version run in float64 on the same inputs; one TF32 product (about 10
    mantissa bits, before the cancellation in dA − dsum) misses that."""
    f = to_torch(flash_inputs(B, H, S, Dh, seed=6), cuda)
    f64 = {k: v.double() for k, v in f.items()}
    keys = ("q", "k", "v", "dout", "r")
    got = tfa.flash_bwd_ehat(*(f[k] for k in keys))
    want = tfa.flash_bwd_ehat_plain(*(f64[k] for k in keys))
    for g, w in zip(got, want):
        assert_within_of_f64(g, w)
    dqkv, e_row = tfa.flash_bwd_ehat_qkv(f["qkv"], f["dmerged"], f["r"], H)
    w_qkv, w_e = tfa.flash_bwd_ehat_qkv_plain(f64["qkv"], f64["dmerged"],
                                              f64["r"], H)
    for g, w in zip(tfa.qkv_heads(dqkv, H), tfa.qkv_heads(w_qkv, H)):
        assert_within_of_f64(g, w)
    assert_within_of_f64(e_row, w_e)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,Dh", FLASH_SHAPES + [(8, 12, 197, 64)])
def test_attn_block_bwd_e_row_within_1e5_of_float64(cuda, B, H, S, Dh):
    """attn_block_bwd's e_row (GEMMs and attention backward, all 3xTF32)
    within 1e-5 · max|e64| of the plain block run in float64."""
    a = to_torch(attn_inputs(B, S, H * Dh, seed=7), cuda)
    _, got = attn_bwd(tab, a, H)
    a64 = {k: v.double() for k, v in a.items()}
    _, want = tab.attn_block_bwd_plain(
        a64["x"], a64["cot"], a64["r"], a64["wqkv"], a64["bqkv"],
        a64["wout"], a64["g1"], a64["b1"], H, EPS)
    assert_within_of_f64(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [64, 20])
def test_flash_bwd_unaligned_views_take_4_byte_copies(cuda, Dh):
    """q, k, v, dout = t[..., :dh] of [B, H, S, dh + 1] tensors: rows off
    the 16-byte grid, so the backward copies 4 bytes at a time. It matches
    the plain version, repeats its bits, and gives the bits of the 16-byte
    copies of the same values."""
    B, H, S = 2, 3, 77
    t = [torch.from_numpy(np.random.RandomState(i).randn(B, H, S, Dh + 1)
                          .astype(np.float32) * 0.5).to(cuda)[..., :Dh]
         for i in range(4)]
    r = torch.rand((B, S), generator=torch.Generator().manual_seed(0)).to(cuda)
    assert tfa.copy_width(Dh, *tfa.view_args(*t)) == 4
    dense = [x.contiguous() for x in t]
    assert tfa.copy_width(Dh, *tfa.view_args(*dense)) == 16
    got = tfa.flash_bwd_ehat(*t, r)
    for g, w in zip(got, tfa.flash_bwd_ehat_plain(*t, r)):
        torch.testing.assert_close(g, w, **TOL)
    for again in (tfa.flash_bwd_ehat(*t, r), tfa.flash_bwd_ehat(*dense, r)):
        assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.cuda
def test_attn_bwd_refuses_16_byte_copies_of_unaligned_rows(cuda):
    """The C side refuses 16-byte copies where a row of dout is off the
    16-byte grid, as it does for the forward and the GEMM."""
    B, H, S, dh = 1, 2, 33, 64
    q = torch.randn((B, H, S, dh), device=cuda)
    dout = torch.randn((B, H, S, dh + 1), device=cuda)[..., :dh]
    r = torch.rand((B, S), device=cuda)
    out = [torch.empty_like(q) for _ in range(3)]
    e = [torch.empty(n, device=cuda) for n in (3 * B * H * S, B * H * S,
                                              B * S)]
    lib = tfa.library()
    pointers, strides = tfa.view_args(q, q, q, dout, *out)
    err = lib.tmx_attn_bwd(*pointers[:4], r.data_ptr(), *pointers[4:],
                           *(x.data_ptr() for x in e),
                           tfa._stride_array(strides), B, S, H, dh, 0.125, 0,
                           16, _build.stream(cuda))
    with pytest.raises(RuntimeError, match="tmx_attn_bwd"):
        _build.check(lib, "tmx_attn_bwd", err)


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [64, 20])
def test_flash_fwd_unaligned_views_take_4_byte_copies(cuda, Dh):
    """q, k, v = t[..., :dh] of a [B, H, S, dh + 1] tensor: rows off the
    16-byte grid, so the kernel copies 4 bytes at a time. It matches the
    plain version, repeats its bits, and gives the bits of the 16-byte
    copies of the same values."""
    B, H, S = 2, 3, 77
    t = [torch.from_numpy(np.random.RandomState(i).randn(B, H, S, Dh + 1)
                          .astype(np.float32) * 0.5).to(cuda)[..., :Dh]
         for i in range(3)]
    assert tfa.copy_width(Dh, *tfa.view_args(*t)) == 4
    dense = [x.contiguous() for x in t]
    assert tfa.copy_width(Dh, *tfa.view_args(*dense)) == 16
    got = tfa.flash_fwd(*t)
    torch.testing.assert_close(got, tfa.flash_fwd_plain(*t), **TOL)
    assert torch.equal(tfa.flash_fwd(*t), got)
    assert torch.equal(tfa.flash_fwd(*dense), got)


@pytest.mark.cuda
@pytest.mark.parametrize("case,match", [
    ("double", "float32"), ("half", "float32"), ("dh160", "head dim 160")])
def test_flash_wrappers_reject_before_launch(cuda, case, match):
    tfa.reset_launch_counts()
    q = torch.randn((1, 2, 33, 64), device=cuda)
    r = torch.rand((1, 33), device=cuda)
    with pytest.raises(RuntimeError, match=match):
        if case in ("double", "half"):
            t = q.double() if case == "double" else q.half()
            tfa.flash_fwd(t, t, t)
        else:
            t = torch.randn((1, 2, 33, 160), device=cuda)
            tfa.flash_bwd_ehat(t, t, t, t, r)
    assert set(tfa.launch_counts().values()) == {0}


@pytest.mark.cuda
@pytest.mark.parametrize("S,start_layer", [(37, 0), (128, 0), (197, 0),
                                           (197, 1), (37, 2), (37, -1)])
def test_relevancy_chain_kernel_matches_plain(cuda, S, start_layer):
    cams, grads = (torch.from_numpy(t).to(cuda)
                   for t in chain_inputs(2, 4, 3, S))
    trp.reset_launch_counts()
    got = trp.self_attention_relevancy_pallas(cams, grads, start_layer)
    want = trp.self_attention_relevancy_pallas_plain(cams, grads, start_layer)
    torch.cuda.synchronize()
    assert trp.launch_counts() == {"self_attention_relevancy_pallas": 1}
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    again = trp.self_attention_relevancy_auto(cams, grads, start_layer)
    assert torch.equal(again, got)


@pytest.mark.cuda
def test_relevancy_chain_past_last_layer_launches_nothing(cuda):
    """start_layer = L folds no layer: R is the identity and no kernel runs,
    so no launch is counted."""
    cams, grads = (torch.from_numpy(t).to(cuda)
                   for t in chain_inputs(2, 3, 2, 37))
    trp.reset_launch_counts()
    got = trp.self_attention_relevancy_pallas(cams, grads, start_layer=3)
    assert trp.launch_counts() == {"self_attention_relevancy_pallas": 0}
    assert torch.equal(got, torch.eye(37, device=cuda).expand(2, 37, 37))
    assert torch.equal(got, trp.self_attention_relevancy_pallas_plain(
        cams, grads, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,S", [(3, 4, 2, 50), (8, 12, 12, 197)])
def test_relevancy_chain_reads_strided_capture_views(cuda, B, L, H, S):
    """capture's [L, B, H, S, S] stacks, batch axis moved first, go in
    without a copy and give what their contiguous copies give."""
    cams, grads = (torch.from_numpy(t).to(cuda).movedim(1, 0).contiguous()
                   .movedim(0, 1) for t in chain_inputs(B, L, H, S, seed=2))
    assert not cams.is_contiguous()
    got = trp.self_attention_relevancy_pallas(cams, grads)
    want = trp.self_attention_relevancy_pallas(cams.contiguous(),
                                               grads.contiguous())
    assert torch.equal(got, want)
    assert got.is_contiguous() and got.shape == (B, S, S)


@pytest.mark.cuda
@pytest.mark.parametrize("bad,match", [
    (lambda t: t.double(), "float32"),
    (lambda t: t.transpose(-1, -2), "contiguous"),
    (lambda t: t[:, :, :1], "shape")])
def test_relevancy_chain_rejects(cuda, bad, match):
    cams, grads = (torch.from_numpy(t).to(cuda)
                   for t in chain_inputs(1, 2, 2, 9))
    with pytest.raises(RuntimeError, match=match):
        trp.self_attention_relevancy_pallas(cams, bad(grads))


@pytest.mark.cuda
@pytest.mark.parametrize("path,counts", [
    ("relevancy_fused", {"flash_fwd_qkv": 3, "flash_bwd_ehat_qkv": 3}),
    ("relevancy_fused_block", {"attn_block_fwd": 3, "attn_block_bwd": 3})])
def test_fused_paths_on_kernels_match_plain_chains(cuda, path, counts):
    cfg = tvit.ViTConfig(image_size=64, patch_size=16, width=96, depth=3,
                         num_heads=6, num_classes=10)
    model = tvit.init_params(0, cfg, cuda)
    gen = torch.Generator().manual_seed(1)
    images = torch.randn((3, 64, 64, 3), generator=gen).to(cuda)
    targets = torch.tensor([1, 2, 3], device=cuda)
    tab.reset_launch_counts()
    tfa.reset_launch_counts()
    got = getattr(tvit, path)(model, images, targets)
    launched = {**tab.launch_counts(), **tfa.launch_counts()}
    assert launched == {name: counts.get(name, 0) for name in launched}
    for ref in (tvit.relevancy(model, images, targets),
                tvit.relevancy_streamed_row(model, images, targets),
                tvit.relevancy_streamed(model, images, targets)):
        assert float((got - ref).abs().max()) < 1e-4


# ---------------------------------------------------------------------------
# the GEMM of csrc/common.cuh (3xTF32 on the tensor cores), through
# ops/attn_block._gemm and the chain wrapper, against float64
# ---------------------------------------------------------------------------

# max|Δ| from float64 over max|C64|: 3xTF32 keeps fp32 accuracy (about
# 1e-7 here), a single TF32 product misses the bar (about 3e-4;
# tests/test_torch_gemm_tf32.py emulates both on the CPU)
GEMM_BAR = 1e-5
GEMM_DIMS = (1, 7, 33, 197, 1576)
GEMM_SHAPES = ([(m, n, k) for m in GEMM_DIMS for n in GEMM_DIMS
                for k in (1, 197)]
               + [(m, n, k) for m, n in ((1576, 768), (33, 197), (7, 1576))
                  for k in (7, 33, 1576, 3072)])
GEMM_EPILOGUES = ("bias", "bias_res", "bias_gelu", "gelu_grad_aux_is_out",
                  "res")


def gemm_operands(M, N, K, trans_b, seed=0, lead=()):
    rng = np.random.RandomState(seed)
    a = rng.randn(*lead, M, K).astype(np.float32)
    b = rng.randn(*lead, *((N, K) if trans_b else (K, N))).astype(np.float32)
    return a, b


def gemm_f64(a, b, trans_b, **kw):
    """The GEMM's function (``gemm_plain``) in float64."""
    return tab.gemm_plain(a.double(), b.double(), trans_b,
                          **{k: v.double() if torch.is_tensor(v) else v
                             for k, v in kw.items()})


def gemm_cuda(a, b, **kw):
    return tab._gemm(tab.library(), a, b, _build.stream(a.device), **kw)


def assert_near_f64(got, want):
    err = float((got.double() - want).abs().max())
    scale = float(want.abs().max())
    assert err <= GEMM_BAR * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("M,N,K", GEMM_SHAPES)
def test_gemm_within_1e5_of_float64_and_repeats_bits(cuda, M, N, K,
                                                      trans_b):
    a, b = (torch.from_numpy(t).to(cuda)
            for t in gemm_operands(M, N, K, trans_b))
    row_b = K if trans_b else N
    assert tab.gemm_copy_width(a, b) == (16 if K % 4 == row_b % 4 == 0
                                         else 4)
    got = gemm_cuda(a, b, trans_b=trans_b)
    torch.cuda.synchronize()
    assert got.shape == (M, N)
    assert_near_f64(got, gemm_f64(a, b, trans_b))
    assert torch.equal(gemm_cuda(a, b, trans_b=trans_b), got)


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("M,N,K", [(197, 768, 768), (33, 197, 77)])
@pytest.mark.parametrize("epilogue", GEMM_EPILOGUES)
def test_gemm_epilogues_within_1e5_of_float64(cuda, epilogue, M, N, K,
                                              trans_b):
    """Each epilogue of the block kernels, with 8-byte (N even) and
    scalar (N odd) accesses; GELU'(aux) written over aux itself, as
    mlp_block_bwd does."""
    a, b = (torch.from_numpy(t).to(cuda)
            for t in gemm_operands(M, N, K, trans_b, seed=1))
    rng = np.random.RandomState(2)
    bias, res, aux = (torch.from_numpy(t.astype(np.float32)).to(cuda)
                      for t in (rng.randn(N), rng.randn(M, N),
                                rng.randn(M, N)))
    kw = {"bias": dict(bias=bias),
          "bias_res": dict(bias=bias, res=res),
          "bias_gelu": dict(bias=bias, act=tab._ACT_GELU),
          "gelu_grad_aux_is_out": dict(aux=aux, act=tab._ACT_MUL_GELU_GRAD),
          "res": dict(res=res)}[epilogue]
    want = gemm_f64(a, b, trans_b, **kw)
    if "aux" in kw:
        kw["out"] = kw["aux"] = aux.clone()
        got = gemm_cuda(a, b, trans_b=trans_b, **kw)
        assert got is kw["out"]
        again = gemm_cuda(a, b, trans_b=trans_b,
                          **{**kw, "out": aux.clone(), "aux": aux.clone()})
    else:
        got = gemm_cuda(a, b, trans_b=trans_b, **kw)
        again = gemm_cuda(a, b, trans_b=trans_b, **kw)
    torch.cuda.synchronize()
    assert_near_f64(got, want)
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("Bt,M,N,K", [(8, 197, 197, 197), (3, 64, 40, 96)])
def test_gemm_batched_within_1e5_of_float64(cuda, Bt, M, N, K):
    """Batched products with the chain's residual epilogue: planes of
    197-float rows (most rows start off the 16-byte grid: 4-byte copies)
    and aligned planes (16-byte copies)."""
    a, b = (torch.from_numpy(t).to(cuda)
            for t in gemm_operands(M, N, K, False, seed=3, lead=(Bt,)))
    res = torch.from_numpy(np.random.RandomState(4).randn(Bt, M, N)
                           .astype(np.float32)).to(cuda)
    assert tab.gemm_copy_width(a, b) == (4 if K % 4 else 16)
    got = gemm_cuda(a, b, res=res)
    torch.cuda.synchronize()
    assert got.shape == (Bt, M, N)
    assert_near_f64(got, gemm_f64(a, b, False, res=res))
    assert torch.equal(gemm_cuda(a, b, res=res), got)


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("which", ["a", "b"])
def test_gemm_operand_off_by_one_float_takes_4_byte_copies(cuda, which,
                                                           trans_b):
    """An operand that starts one float past a 16-byte boundary: 4-byte
    copies, the same shared-memory contents, so the bits of the 16-byte
    copies of the same values."""
    M, N, K = 197, 96, 768
    a, b = (torch.from_numpy(t).to(cuda)
            for t in gemm_operands(M, N, K, trans_b, seed=5))
    dense = gemm_cuda(a, b, trans_b=trans_b)
    t = a if which == "a" else b
    buf = torch.empty(t.numel() + 1, device=cuda)
    shifted = buf[1:].view(t.shape)
    shifted.copy_(t)
    a2, b2 = (shifted, b) if which == "a" else (a, shifted)
    assert tab.gemm_copy_width(a, b) == 16
    assert tab.gemm_copy_width(a2, b2) == 4
    got = gemm_cuda(a2, b2, trans_b=trans_b)
    torch.cuda.synchronize()
    assert_near_f64(got, gemm_f64(a, b, trans_b))
    assert torch.equal(got, dense)


@pytest.mark.cuda
def test_gemm_refuses_16_byte_copies_of_unaligned_rows(cuda):
    lib = tab.library()
    buf = torch.randn(33 * 8 + 1, device=cuda)
    a, b = buf[1:].view(33, 8), torch.randn(8, 16, device=cuda)
    out = torch.empty(33, 16, device=cuda)
    err = lib.tmx_gemm(a.data_ptr(), b.data_ptr(), out.data_ptr(), 33, 16, 8,
                       0, None, None, None, tab._ACT_NONE, 0, 1, 0, 0, 0, 16,
                       _build.stream(cuda))
    with pytest.raises(RuntimeError, match="tmx_gemm"):
        _build.check(lib, "tmx_gemm", err)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,S", [(2, 6, 3, 197), (2, 6, 3, 128),
                                     (2, 6, 3, 200), (8, 12, 12, 197),
                                     (16, 2, 2, 197)])
def test_relevancy_chain_within_1e5_of_float64(cuda, B, L, H, S):
    """The chain's products through the tensor-core GEMM on rows padded to
    a multiple of 4 floats (16-byte copies; 197 → 200, 128 and 200 as
    they are), against the plain chain in float64 and in fp32 (rtol 5e-4,
    atol 1e-4), at ViT-B/16's B = 8, L = 12, H = 12, S = 197 too; at
    B = 16 the products have more tiles than the card has SMs (4 warps a
    tile)."""
    cams, grads = (torch.from_numpy(t).to(cuda)
                   for t in chain_inputs(B, L, H, S, seed=6))
    got = trp.self_attention_relevancy_pallas(cams, grads)
    assert got.is_contiguous() and got.shape == (B, S, S)
    want = chain_f64(cams, grads)
    torch.cuda.synchronize()
    assert_near_f64(got, want)
    moved = float((want - torch.eye(S, device=cuda)).abs().max())
    assert moved > 100 * GEMM_BAR * float(want.abs().max())   # R far from I
    torch.testing.assert_close(
        got, trp.self_attention_relevancy_pallas_plain(cams, grads), **TOL)


# ---------------------------------------------------------------------------
# ops/roi_pool_pallas and models/frcnn
# ---------------------------------------------------------------------------

# (H, W, C, K, P): the JAX test's shape, C not a multiple of 4 (30, 5, 3:
# one float per thread), K = 1, the protocol shape ([50, 76, 1024] res4 map
# of an 800×1216 image) at K = 1, 300 and 1000, C = 1020 (float4, a partial
# last chunk of channels) and P = 20 (two bands of column bins)
CUDA_ROI = [(25, 38, 96, 11, 14), (13, 17, 30, 7, 4), (9, 9, 5, 1, 2),
            (50, 76, 1024, 1, 14), (50, 76, 1024, 300, 14),
            (50, 76, 1024, 1000, 14), (50, 76, 1020, 200, 14),
            (50, 76, 3, 1000, 14), (30, 40, 64, 50, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,C,K,P", CUDA_ROI)
def test_roi_pool_kernel_equals_plain(cuda, H, W, C, K, P):
    """A max involves no rounding: the kernel equals its plain version."""
    feats, boxes = (torch.from_numpy(t).to(cuda)
                    for t in roi_inputs(H, W, C, K))
    trpool.reset_launch_counts()
    got = trpool.roi_pool_pallas(feats, boxes, P, 1 / 16)
    torch.cuda.synchronize()
    assert trpool.launch_counts() == {"roi_pool_pallas": 1}
    want = trpool.roi_pool_plain(feats, boxes, P, 1 / 16)
    assert got.shape == (K, P, P, C)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1024, 3])
@pytest.mark.parametrize("P", [14, 4, 3, 20, 1])
def test_roi_pool_kernel_equals_plain_on_edge_boxes(cuda, C, P):
    """roi < P (a row or column in several bins), boxes past and outside
    the map, degenerate and inverted boxes, .5 rounding edges; the kernel's
    own bins (fp32 multiply, then add) against ``roi_bin_bounds``."""
    rng = np.random.RandomState(7)
    feats = torch.from_numpy(rng.randn(14, 18, C).astype(np.float32)).to(cuda)
    boxes = torch.from_numpy(roi_edge_boxes(14, 18)).to(cuda)
    got = trpool.roi_pool_pallas(feats, boxes, P, 1 / 16)
    assert torch.equal(got, trpool.roi_pool_plain(feats, boxes, P, 1 / 16))


@pytest.mark.cuda
def test_roi_pool_kernel_takes_strided_boxes_and_odd_scales(cuda):
    """Boxes as a strided view, and a scale that is not a power of two (its
    products round), against the plain version."""
    feats, boxes = (torch.from_numpy(t).to(cuda)
                    for t in roi_inputs(40, 52, 16, 64, seed=8, stride=13))
    strided = boxes.t().contiguous().t()
    assert not strided.is_contiguous()
    for scale in (1 / 13, 1 / 3, 0.0731):
        got = trpool.roi_pool_pallas(feats, strided, 7, scale)
        assert torch.equal(got, trpool.roi_pool_plain(feats, boxes, 7,
                                                      scale))


@pytest.mark.cuda
def test_roi_pool_kernel_maps_nan_and_inf_to_zero(cuda):
    feats, boxes = (torch.from_numpy(t).to(cuda)
                    for t in roi_inputs(12, 12, 8, 4, seed=3))
    feats[:, :, 1] = float("nan")
    feats[:, :, 2] = float("inf")
    got = trpool.roi_pool_pallas(feats, boxes, 3, 1 / 16)
    assert torch.equal(got, trpool.roi_pool_plain(feats, boxes, 3, 1 / 16))
    assert torch.isfinite(got).all()
    assert not got[..., 1:3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("bad,match", [
    (lambda f, b: (f.double(), b), "float32"),
    (lambda f, b: (f, b.half()), "float32"),
    (lambda f, b: (f.transpose(0, 1), b), "contiguous"),
    (lambda f, b: (f[None], b), r"\[H, W, C\]"),
    (lambda f, b: (f, b[:, :3]), r"\[K, 4\]"),
    (lambda f, b: (f, b.cpu()), "expected cuda")])
def test_roi_pool_rejects_before_launch(cuda, bad, match):
    feats, boxes = (torch.from_numpy(t).to(cuda)
                    for t in roi_inputs(10, 12, 8, 3))
    trpool.reset_launch_counts()
    with pytest.raises(RuntimeError, match=match):
        trpool.roi_pool_pallas(*bad(feats, boxes), 4, 1 / 16)
    assert trpool.launch_counts() == {"roi_pool_pallas": 0}


@pytest.mark.cuda
def test_frcnn_forward_pallas_equals_xla_on_cuda(cuda):
    """frcnn.forward at the tiny config on the card: the kernel path
    (the default) and the plain RoIPool give the same pooled features, so
    the same outputs (cuDNN runs the same convolutions in both)."""
    import dataclasses

    cfg = tfrcnn.FrcnnConfig(**FRCNN_TINY)
    assert cfg.roi_pool_impl == "pallas"
    params = tfrcnn.init_params(0, cfg, cuda)
    img = torch.from_numpy(np.random.RandomState(5).randn(128, 160, 3)
                           .astype(np.float32)).to(cuda)
    trpool.reset_launch_counts()
    with torch.no_grad():
        got = tfrcnn.forward(params, img, cfg)
        assert trpool.launch_counts() == {"roi_pool_pallas": 1}
        want = tfrcnn.forward(params, img,
                              dataclasses.replace(cfg, roi_pool_impl="xla"))
    assert trpool.launch_counts() == {"roi_pool_pallas": 1}
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-5,
                                   msg=k)


def _bias_leaves(tree):
    """Every bias tensor (a leaf whose name starts with ``b``) of a DETR
    layer tree of dicts and NamedTuples."""
    items = tree._asdict().items() if hasattr(tree, "_fields") \
        else tree.items()
    for name, leaf in items:
        if isinstance(leaf, dict) or hasattr(leaf, "_fields"):
            yield from _bias_leaves(leaf)
        elif name.startswith("b"):
            yield leaf


@pytest.mark.cuda
def test_detr_explain_image_cuda_equals_cpu(cuda):
    """The DETR explanation path at a tiny size (D 32, 4 heads, 2 + 3
    layers, one bottleneck per stage) on the card against the CPU: rows
    of every non-LRP method within rtol 1e-4 / atol 1e-5, the masks of the
    same rows equal, ``explain_image``'s detections equal, no kernel
    launched. The layers' biases are drawn: ``init_params`` zeroes them,
    and then the first decoder layer's values and Ê are 0 and every
    no-aggregation row is 0 on both sides. Those rows (a product of every
    layer's Ê) are ~1e-13 here, so their absolute bar scales with them."""
    from transformer_mm_explainability_tpu_torch._device import params_to
    from transformer_mm_explainability_tpu_torch.explain import detr as ed
    from transformer_mm_explainability_tpu_torch.harness import detr_segm
    from transformer_mm_explainability_tpu_torch.models import detr

    cfg = detr.DETRConfig(num_classes=7, num_queries=6, d_model=32,
                          nheads=4, num_encoder_layers=2,
                          num_decoder_layers=3, dim_feedforward=64,
                          backbone_stages=(1, 1, 1, 1))
    cpu = detr.init_params(0, cfg, "cpu")
    gen = torch.Generator().manual_seed(7)
    for tree in (cpu["encoder"], cpu["decoder"]):
        for leaf in _bias_leaves(tree):
            leaf.add_(0.1 * torch.randn(leaf.shape, generator=gen))
    params = params_to(cpu, cuda)
    img = torch.from_numpy(np.random.RandomState(4).randn(64, 96, 3)
                           .astype(np.float32))
    valid = torch.zeros(64, 96)
    valid[:40, :60] = 1.0
    q, c = np.array([0, 3, 5, 1]), np.array([1, 2, 6, 0])
    mods = (tab, tfa, trp, trpool)
    for mod in mods:
        mod.reset_launch_counts()
    for method in ("ours_no_lrp", "ours_no_lrp_no_norm",
                   "ablation_no_self_in_10", "ablation_no_aggregation",
                   "raw_attn", "attn_gradcam", "rollout"):
        want = ed.generate(method, cpu, img, q, c, cfg, valid)
        got = ed.generate(method, params, img.to(cuda), q, c, cfg,
                          valid.to(cuda))
        top = float(want.abs().max())
        assert top > 0, method
        atol = 1e-5 * top if method == "ablation_no_aggregation" else 1e-5
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=atol,
                                   msg=method)
        assert torch.isfinite(got).all()
        if method == "ours_no_lrp":
            assert float(want.abs().max()) > 1e-3
            m_cpu = detr_segm.masks_from_relevancy(want, (2, 3), (64, 96))
            m_gpu = detr_segm.masks_from_relevancy(want.to(cuda), (2, 3),
                                                   (64, 96))
            assert torch.equal(m_gpu.cpu(), m_cpu)
    segm = detr_segm.SegmConfig(confidence_threshold=0.0, max_detections=5,
                                max_queries_per_pass=2)
    a = detr_segm.explain_image(cpu, img, cfg, segm, pad_valid=valid)
    b = detr_segm.explain_image(params, img.to(cuda), cfg, segm,
                                pad_valid=valid.to(cuda))
    for k in ("query_idx", "classes"):
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_allclose(a["scores"], b["scores"], rtol=1e-4)
    assert b["masks"].shape == (5, 64, 96)
    for mod in mods:
        assert all(n == 0 for n in mod.launch_counts().values())


# ---------------------------------------------------------------------------
# the bf16-product mode (fast_dots) and bf16 tensors: csrc/attn_block_bf16.cu
# and gemm_bf16.cuh's wgmma GEMM, against the plain versions with
# fast_dots on the card
# ---------------------------------------------------------------------------

# kernel against plain, as shares of max|plain|. The fp32 values before a
# bf16 rounding differ by an ulp now and then (sum order, exp2f against
# torch's exp, the LayerNorm statistics), which flips the rounding of an
# operand on a bf16 rounding edge and moves the outputs it feeds by up to
# one rounding of one term; in the attention block a flip reaches every row
# of its image. So the median |Δ| over the elements is held to a tenth of
# the same median between fast_dots and fp32 on the same values (at least
# MEDIAN_FLOOR), max|Δ| to one rounding of a term (2⁻⁸), and one more ulp
# of the largest element for a bf16 output (2⁻⁶).
FAST_MAX_BARS = {torch.float32: 2.0 ** -8, torch.bfloat16: 2.0 ** -6}
MEDIAN_FLOOR = 5e-6
FAST_DTYPES = [torch.float32, torch.bfloat16]


def _fast_close(got, want, ref):
    """Each output of ``got`` (the kernels) against ``want`` (the plain
    version with fast_dots) at the bars above; ``ref``: the plain version
    without fast_dots on the same values in float32."""
    as_tuple = lambda x: x if isinstance(x, tuple) else (x,)
    for g, w, f in zip(as_tuple(got), as_tuple(want), as_tuple(ref)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.isfinite(g).all()
        top = float(w.float().abs().max())
        med = lambda a, b: float((a.float() - b.float()).abs().median())
        bar = max(MEDIAN_FLOOR * top, med(w, f) / 10)
        assert med(g, w) <= bar, (med(g, w), bar, top)
        err = float((g.float() - w.float()).abs().max())
        assert err <= FAST_MAX_BARS[g.dtype] * top, (err, top)


def _f32(d):
    return {k: v.float() for k, v in d.items()}


def _stored(d, dtype):
    """The inputs in ``dtype``, r float32."""
    return {k: v if k == "r" else v.to(dtype) for k, v in d.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FAST_DTYPES)
@pytest.mark.parametrize("B,H,S,D", CUDA_ATTN)
def test_attn_block_kernels_fast_dots_match_plain(cuda, B, H, S, D, dtype):
    """attn_block_fwd / attn_block_bwd with fast_dots on float32 and
    bfloat16 tensors: the bf16-product kernels (counted apart from the fp32
    ones), outputs in the inputs' dtype and e_row float32, within
    FAST_BARS of the plain versions, the same bits on a second call."""
    a = _stored(to_torch(attn_inputs(B, S, D), cuda), dtype)
    tab.reset_launch_counts()
    fwd = attn_fwd(tab, a, H, fast_dots=True)
    bwd = attn_bwd(tab, a, H, fast_dots=True)
    torch.cuda.synchronize()
    assert tab.bf16_launch_counts() == {
        "attn_block_fwd_bf16": 1, "mlp_block_fwd_bf16": 0,
        "mlp_block_bwd_bf16": 0, "attn_block_bwd_bf16": 1}
    assert set(tab.launch_counts().values()) == {0}
    assert fwd.dtype == bwd[0].dtype == dtype
    assert bwd[1].dtype == torch.float32
    fwd_plain = lambda t, fast: tab.attn_block_fwd_plain(
        t["x"], t["wqkv"], t["bqkv"], t["wout"], t["bout"], t["g1"], t["b1"],
        H, EPS, fast_dots=fast)
    bwd_plain = lambda t, fast: tab.attn_block_bwd_plain(
        t["x"], t["cot"], t["r"], t["wqkv"], t["bqkv"], t["wout"], t["g1"],
        t["b1"], H, EPS, fast_dots=fast)
    _fast_close(fwd, fwd_plain(a, True), fwd_plain(_f32(a), False))
    _fast_close(bwd, bwd_plain(a, True), bwd_plain(_f32(a), False))
    assert torch.equal(attn_fwd(tab, a, H, fast_dots=True), fwd)
    again = attn_bwd(tab, a, H, fast_dots=True)
    assert all(torch.equal(x, y) for x, y in zip(again, bwd))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FAST_DTYPES)
@pytest.mark.parametrize("B,S,D,I,chunks", CUDA_MLP)
def test_mlp_block_kernels_fast_dots_match_plain(cuda, B, S, D, I, chunks,
                                                 dtype):
    m = _stored(to_torch(mlp_inputs(B, S, D, I), cuda), dtype)
    tab.reset_launch_counts()
    fwd = mlp_fwd(tab, m, chunks, fast_dots=True)
    bwd = mlp_bwd(tab, m, chunks, fast_dots=True)
    torch.cuda.synchronize()
    assert tab.bf16_launch_counts() == {
        "attn_block_fwd_bf16": 0, "mlp_block_fwd_bf16": 1,
        "mlp_block_bwd_bf16": 1, "attn_block_bwd_bf16": 0}
    assert fwd.dtype == bwd.dtype == dtype
    fwd_plain = lambda t, fast: tab.mlp_block_fwd_plain(
        t["x"], t["w1"], t["b1"], t["w2"], t["b2"], t["g2"], t["bb2"], EPS,
        chunks, fast_dots=fast)
    bwd_plain = lambda t, fast: tab.mlp_block_bwd_plain(
        t["x"], t["cot"], t["w1"], t["b1"], t["w2"], t["g2"], t["bb2"], EPS,
        chunks, fast_dots=fast)
    _fast_close(fwd, fwd_plain(m, True), fwd_plain(_f32(m), False))
    _fast_close(bwd, bwd_plain(m, True), bwd_plain(_f32(m), False))
    assert torch.equal(mlp_bwd(tab, m, chunks, fast_dots=True), bwd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FAST_DTYPES)
@pytest.mark.parametrize("B,H,S,Dh", CUDA_FLASH)
def test_flash_kernels_fast_dots_match_plain(cuda, B, H, S, Dh, dtype):
    """The four flash wrappers with fast_dots (head dims 8 to 128, padded
    to 64 or 128 in the kernels; S up to 300), and the per-head kernels on
    split-head views of qkv write the qkv kernels' bits."""
    f = _stored(to_torch(flash_inputs(B, H, S, Dh), cuda), dtype)
    f32 = _f32(f)
    plain = {
        "fwd": lambda t, fast: tfa.flash_fwd_plain(t["q"], t["k"], t["v"],
                                                   fast_dots=fast),
        "bwd": lambda t, fast: tfa.flash_bwd_ehat_plain(
            t["q"], t["k"], t["v"], t["dout"], t["r"], fast_dots=fast),
        "fwd_qkv": lambda t, fast: tfa.flash_fwd_qkv_plain(t["qkv"], H,
                                                           fast_dots=fast),
        "bwd_qkv": lambda t, fast: tfa.flash_bwd_ehat_qkv_plain(
            t["qkv"], t["dmerged"], t["r"], H, fast_dots=fast)}
    tfa.reset_launch_counts()
    got = {
        "fwd": tfa.flash_fwd(f["q"], f["k"], f["v"], fast_dots=True),
        "bwd": tfa.flash_bwd_ehat(f["q"], f["k"], f["v"], f["dout"], f["r"],
                                  fast_dots=True),
        "fwd_qkv": tfa.flash_fwd_qkv(f["qkv"], H, fast_dots=True),
        "bwd_qkv": tfa.flash_bwd_ehat_qkv(f["qkv"], f["dmerged"], f["r"], H,
                                          fast_dots=True)}
    torch.cuda.synchronize()
    assert set(tfa.bf16_launch_counts().values()) == {1}
    assert set(tfa.launch_counts().values()) == {0}
    for key, out in got.items():
        _fast_close(out, plain[key](f, True), plain[key](f32, False))
    views = tfa.qkv_heads(f["qkv"], H)
    out = tfa.flash_fwd(*views, fast_dots=True)
    assert torch.equal(out, tfa.heads(got["fwd_qkv"], H))
    *grads, e_row = tfa.flash_bwd_ehat(*views, tfa.heads(f["dmerged"], H),
                                       f["r"], fast_dots=True)
    dqkv, e_qkv = got["bwd_qkv"]
    assert all(torch.equal(g, w) for g, w in zip(grads, tfa.qkv_heads(dqkv,
                                                                      H)))
    assert torch.equal(e_row, e_qkv)


# the bf16 backward's edges (B, H, S, dh): S around the 64-row tiles and
# the 128-key blocks (1 to 1,100), head dims padded to 64 or 128 (8, 40,
# 64, 72, 128) and the grids either side of the key-width table (B·H = 6
# takes 64-key blocks at every S here, 96 and 384 take 128-key ones at S =
# 197: 192 and 768 blocks for 132 SMs)
FAST_BWD_EDGES = (
    [(2, 3, s, 64) for s in (1, 63, 64, 65, 127, 128, 129, 197, 257, 513,
                             1100)]
    + [(2, 3, s, dh) for dh in (8, 40, 72, 128) for s in (1, 65, 129, 257,
                                                          1100)]
    + [(8, 12, 197, 64), (32, 12, 197, 64)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FAST_DTYPES)
@pytest.mark.parametrize("B,H,S,Dh", FAST_BWD_EDGES)
def test_flash_bwd_fast_dots_edges_match_plain(cuda, B, H, S, Dh, dtype):
    """The bf16 backward (wgmma, TMA) at its edges on float32 and bfloat16
    tensors: flash_bwd_ehat and flash_bwd_ehat_qkv within the FAST bars of
    their plain versions, the same bits on a second call, the per-head
    kernels on split-head views of qkv the qkv kernels' bits; each key
    width forced (64 or 128 keys a block where dh <= 64: dq's partial sums
    per 64 or per 128 keys, in key order) within the same bars and
    repeating its bits, dk, dv and e_row equal across the widths. The
    packed operands are counted: all four on float32 tensors, none on
    aligned bfloat16 ones (dh a multiple of 8)."""
    f = _stored(to_torch(flash_inputs(B, H, S, Dh, seed=3), cuda), dtype)
    f32 = _f32(f)
    per_head = lambda t: (t["q"], t["k"], t["v"], t["dout"], t["r"])
    tfa.reset_launch_counts()
    got = tfa.flash_bwd_ehat(*per_head(f), fast_dots=True)
    torch.cuda.synchronize()
    packs = 4 * (dtype == torch.float32 or Dh % 8 != 0)
    copies = (tfa.attn_bwd_launch.copies, tfa.attn_bwd_launch.rounded)
    assert copies == ((0, packs) if dtype == torch.float32 else (packs, 0))
    assert tfa.attn_bwd_launch.dq_partial_sums == 1
    _fast_close(got, tfa.flash_bwd_ehat_plain(*per_head(f), fast_dots=True),
                tfa.flash_bwd_ehat_plain(*per_head(f32)))
    qkv = tfa.flash_bwd_ehat_qkv(f["qkv"], f["dmerged"], f["r"], H,
                                 fast_dots=True)
    _fast_close(qkv, tfa.flash_bwd_ehat_qkv_plain(f["qkv"], f["dmerged"],
                                                  f["r"], H, fast_dots=True),
                tfa.flash_bwd_ehat_qkv_plain(f32["qkv"], f32["dmerged"],
                                             f32["r"], H))
    again = tfa.flash_bwd_ehat(*per_head(f), fast_dots=True)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    *grads, e_row = tfa.flash_bwd_ehat(*tfa.qkv_heads(f["qkv"], H),
                                       tfa.heads(f["dmerged"], H), f["r"],
                                       fast_dots=True)
    assert all(torch.equal(g, w) for g, w in zip(grads, tfa.qkv_heads(
        qkv[0], H)))
    assert torch.equal(e_row, qkv[1])
    lib = tfa.library(fast_dots=True)
    want = tfa.flash_bwd_ehat_plain(*per_head(f), fast_dots=True)
    ref = tfa.flash_bwd_ehat_plain(*per_head(f32))
    try:
        for keys in (64, 128):
            assert lib.tmx_attn_bwd_bf16_force_keys(keys) == keys
            forced = tfa.flash_bwd_ehat(*per_head(f), fast_dots=True)
            _fast_close(forced, want, ref)
            assert all(torch.equal(a, g) for a, g in zip(
                forced, tfa.flash_bwd_ehat(*per_head(f), fast_dots=True)))
            assert all(torch.equal(a, g) for a, g in zip(forced[1:], got[1:]))
    finally:
        lib.tmx_attn_bwd_bf16_force_keys(0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FAST_DTYPES)
def test_flash_bwd_fast_dots_packs_views_tma_cannot_read(cuda, dtype):
    """q, k, v, dout = t[..., 1:dh + 1] of [B, H, S, dh + 8] tensors: rows
    2 or 4 bytes past the 16-byte grid, which TMA cannot read, so each is
    packed (counted as a copy for bfloat16, as rounded for float32); the
    outputs are the bits of the same values stored contiguously, and within
    the FAST bars of the plain version."""
    B, H, S, Dh = 2, 3, 77, 64
    t = [torch.from_numpy(np.random.RandomState(i).randn(B, H, S, Dh + 8)
                          .astype(np.float32) * 0.5).to(cuda, dtype)
         [..., 1:Dh + 1] for i in range(4)]
    r = torch.rand((B, S), generator=torch.Generator().manual_seed(0)).to(cuda)
    dense = [x.contiguous() for x in t]
    tfa.reset_launch_counts()
    got = tfa.flash_bwd_ehat(*t, r, fast_dots=True)
    torch.cuda.synchronize()
    counts = (tfa.attn_bwd_launch.copies, tfa.attn_bwd_launch.rounded)
    assert counts == ((4, 0) if dtype == torch.bfloat16 else (0, 4))
    _fast_close(got, tfa.flash_bwd_ehat_plain(*t, r, fast_dots=True),
                tfa.flash_bwd_ehat_plain(*(x.float() for x in t), r))
    tfa.reset_launch_counts()
    want = tfa.flash_bwd_ehat(*dense, r, fast_dots=True)
    assert tfa.attn_bwd_launch.copies == 0
    assert all(torch.equal(a, g) for a, g in zip(want, got))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2000, 4000])
def test_flash_bwd_fast_dots_long_sequence_matches_plain(cuda, S):
    """S = 2,000 and 4,000 (B=1, H=2): the bf16 backward's shared memory
    is fixed by dh, and its partial dq sums grow with S (63 at S = 4,000)."""
    lib = tfa.library(fast_dots=True)
    assert lib.tmx_attn_smem_bf16(S, 64, 1) == lib.tmx_attn_smem_bf16(197, 64,
                                                                       1)
    for dtype in FAST_DTYPES:
        f = _stored(to_torch(flash_inputs(1, 2, S, 64, seed=5), cuda), dtype)
        args = (f["q"], f["k"], f["v"], f["dout"], f["r"])
        tfa.reset_launch_counts()
        got = tfa.flash_bwd_ehat(*args, fast_dots=True)
        torch.cuda.synchronize()
        assert tfa.bf16_launch_counts()["flash_bwd_ehat_bf16"] == 1
        _fast_close(got, tfa.flash_bwd_ehat_plain(*args, fast_dots=True),
                    tfa.flash_bwd_ehat_plain(*(x.float() for x in args)))
        assert all(torch.equal(a, g) for a, g in zip(
            tfa.flash_bwd_ehat(*args, fast_dots=True), got))


def _sass(lib_name: str) -> str:
    """``cuobjdump -sass`` of a built library of csrc/."""
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(_build.library_path(lib_name))],
                          capture_output=True, text=True, check=True).stdout


def _bodies(sass: str, functions) -> dict:
    """Each of ``functions``' SASS, up to the next function's."""
    starts = [m.start() for m in re.finditer(r"Function : ", sass)]
    out = {}
    for f in functions:
        i = sass.index(f"Function : {f}")
        end = min([s for s in starts if s > i], default=len(sass))
        out[f] = sass[i:end]
    return out


@pytest.mark.cuda
def test_attn_bwd_bf16_runs_wgmma_and_lost_the_mma_sync_kernels(cuda):
    """The built bf16 library's SASS: the backward's statistics and
    key-major passes hold wgmma products (HGMMA) and TMA loads (UTMALDG);
    the two mma.sync passes they replaced (``attn_bwd_q_bf16_kernel``,
    ``attn_bwd_kv_bf16_kernel``) are gone; the key-width table takes 128
    keys a block where those blocks still give every SM one, 64 past dh =
    64 or on smaller grids."""
    lib = tfa.library(fast_dots=True)
    sass = _sass("attn_block_bf16")
    functions = re.findall(r"Function : (\S+)", sass)
    bwd = [f for f in functions if "attn_bwd" in f]
    assert not [f for f in bwd if re.search(r"attn_bwd_(q|kv)_bf16", f)], bwd
    wgmma = [f for f in bwd if "wgmma" in f]
    assert any("stats" in f for f in wgmma) and any("keys" in f
                                                    for f in wgmma), bwd
    for f, body in _bodies(sass, wgmma).items():
        assert "HGMMA.64x64x16" in body and "UTMALDG" in body, f
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for S, dh, BH in ((197, 64, 96), (197, 64, 384), (197, 64, 12),
                      (1100, 64, 6), (197, 128, 384), (4000, 64, 2)):
        want = 64 if dh > 64 or -(-S // 128) * BH < sms else 128
        assert lib.tmx_attn_bwd_bf16_keys(S, dh, BH) == want, (S, dh, BH)


# the bf16 forward's edges (B, H, S, dh): S around the 64-row tiles, both
# sides of the one-sweep cap (256 keys: 4 tiles of 64 in the accumulators,
# two sweeps past it) and far past it (1,100); head dims padded to 64 or 128
# (8, 40, 64, 72, 128); B·H = 6, 96 and 384 (grids of 24 to 1,536 blocks for
# 132 SMs)
FAST_FWD_EDGES = (
    [(2, 3, s, 64) for s in (1, 63, 64, 65, 129, 197, 256, 257, 1100)]
    + [(2, 3, s, dh) for dh in (8, 40, 72, 128) for s in (1, 65, 197, 257,
                                                          1100)]
    + [(8, 12, 197, 64), (32, 12, 197, 64), (32, 12, 197, 128),
       (8, 12, 256, 40)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FAST_DTYPES)
@pytest.mark.parametrize("B,H,S,Dh", FAST_FWD_EDGES)
def test_flash_fwd_fast_dots_edges_match_plain(cuda, B, H, S, Dh, dtype):
    """The bf16 forward (wgmma, TMA) at its edges on float32 and bfloat16
    tensors: flash_fwd and flash_fwd_qkv within the FAST bars of their
    plain versions, the same bits on a second call, the per-head kernel on
    split-head views of qkv the qkv kernel's bits. The packed operands are
    counted: q, k, v on float32 tensors, none on aligned bfloat16 ones
    (dh a multiple of 8)."""
    f = _stored(to_torch(flash_inputs(B, H, S, Dh, seed=4), cuda), dtype)
    f32 = _f32(f)
    per_head = lambda t: (t["q"], t["k"], t["v"])
    tfa.reset_launch_counts()
    got = tfa.flash_fwd(*per_head(f), fast_dots=True)
    torch.cuda.synchronize()
    packs = 3 * (dtype == torch.float32 or Dh % 8 != 0)
    copies = (tfa.attn_fwd_launch.copies, tfa.attn_fwd_launch.rounded)
    assert copies == ((0, packs) if dtype == torch.float32 else (packs, 0))
    assert tfa.bf16_launch_counts()["flash_fwd_bf16"] == 1
    assert got.dtype == dtype and got.shape == f["q"].shape
    _fast_close(got, tfa.flash_fwd_plain(*per_head(f), fast_dots=True),
                tfa.flash_fwd_plain(*per_head(f32)))
    assert torch.equal(tfa.flash_fwd(*per_head(f), fast_dots=True), got)
    qkv = tfa.flash_fwd_qkv(f["qkv"], H, fast_dots=True)
    _fast_close(qkv, tfa.flash_fwd_qkv_plain(f["qkv"], H, fast_dots=True),
                tfa.flash_fwd_qkv_plain(f32["qkv"], H))
    assert torch.equal(tfa.flash_fwd_qkv(f["qkv"], H, fast_dots=True), qkv)
    views = tfa.flash_fwd(*tfa.qkv_heads(f["qkv"], H), fast_dots=True)
    assert torch.equal(views, tfa.heads(qkv, H))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FAST_DTYPES)
def test_flash_fwd_fast_dots_packs_views_tma_cannot_read(cuda, dtype):
    """q, k, v = t[..., 1:dh + 1] of [B, H, S, dh + 8] tensors (rows off the
    16-byte grid): each is packed, and the output is the bits of the same
    values stored contiguously."""
    B, H, S, Dh = 2, 3, 77, 64
    t = [torch.from_numpy(np.random.RandomState(i).randn(B, H, S, Dh + 8)
                          .astype(np.float32) * 0.5).to(cuda, dtype)
         [..., 1:Dh + 1] for i in range(3)]
    tfa.reset_launch_counts()
    got = tfa.flash_fwd(*t, fast_dots=True)
    torch.cuda.synchronize()
    counts = (tfa.attn_fwd_launch.copies, tfa.attn_fwd_launch.rounded)
    assert counts == ((3, 0) if dtype == torch.bfloat16 else (0, 3))
    _fast_close(got, tfa.flash_fwd_plain(*t, fast_dots=True),
                tfa.flash_fwd_plain(*(x.float() for x in t)))
    tfa.reset_launch_counts()
    want = tfa.flash_fwd(*(x.contiguous() for x in t), fast_dots=True)
    assert tfa.attn_fwd_launch.copies == 0
    assert torch.equal(want, got)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2000, 4000])
def test_flash_fwd_fast_dots_long_sequence_matches_plain(cuda, S):
    """S = 2,000 and 4,000 (B=1, H=2): two sweeps, shared memory fixed by
    dh; the same bits on a second call."""
    lib = tfa.library(fast_dots=True)
    assert lib.tmx_attn_smem_bf16(S, 64, 0) == lib.tmx_attn_smem_bf16(300, 64,
                                                                       0)
    for dtype in FAST_DTYPES:
        f = _stored(to_torch(flash_inputs(1, 2, S, 64, seed=6), cuda), dtype)
        args = (f["q"], f["k"], f["v"])
        got = tfa.flash_fwd(*args, fast_dots=True)
        _fast_close(got, tfa.flash_fwd_plain(*args, fast_dots=True),
                    tfa.flash_fwd_plain(*(x.float() for x in args)))
        assert torch.equal(tfa.flash_fwd(*args, fast_dots=True), got)


@pytest.mark.cuda
def test_attn_fwd_bf16_runs_wgmma_and_the_library_lost_mma_sync(cuda):
    """The built bf16 library's SASS: the forward's kernels hold wgmma
    products (HGMMA) and TMA loads (UTMALDG), one sweep and two; the
    mma.sync forward (``attn_fwd_bf16_kernel``) is gone, and no function of
    the library has an mma.sync bf16 product (HMMA.16816.F32.BF16) any
    more."""
    tfa.library(fast_dots=True)   # built
    sass = _sass("attn_block_bf16")
    assert "HMMA.16816.F32.BF16" not in sass
    functions = re.findall(r"Function : (\S+)", sass)
    fwd = [f for f in functions if "attn_fwd" in f]
    assert not [f for f in fwd if "attn_fwd_bf16_kernel" in f], fwd
    assert {"tile", "sweeps"} <= {k for f in fwd for k in ("tile", "sweeps")
                                  if f"attn_fwd_{k}_wgmma_kernel" in f}, fwd
    for f, body in _bodies(sass, fwd).items():
        assert "HGMMA.64x64x16" in body and "UTMALDG" in body, f


@pytest.mark.cuda
def test_kernels_under_a_float64_default_return_float32(cuda):
    """#6, #8 and #9 (the fp32 kernels, and #6 and #8 with fast_dots) under
    ``torch.set_default_dtype(torch.float64)``: their scratch and outputs
    are float32, equal in value to their plain versions'."""
    f = to_torch(flash_inputs(2, 3, 77, 64), cuda)
    cams, grads = (torch.from_numpy(t).to(cuda)
                   for t in chain_inputs(2, 4, 3, 37))
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        per_head = (f["q"], f["k"], f["v"], f["dout"], f["r"])
        for fast in (False, True):
            got = tfa.flash_bwd_ehat(*per_head, fast_dots=fast)
            want = tfa.flash_bwd_ehat_plain(*per_head, fast_dots=fast)
            qkv = tfa.flash_bwd_ehat_qkv(f["qkv"], f["dmerged"], f["r"], 3,
                                         fast_dots=fast)
            want_qkv = tfa.flash_bwd_ehat_qkv_plain(f["qkv"], f["dmerged"],
                                                    f["r"], 3, fast_dots=fast)
            torch.cuda.synchronize()
            assert all(t.dtype == torch.float32 for t in got + qkv)
            if fast:
                _fast_close(got, want, tfa.flash_bwd_ehat_plain(*per_head))
                _fast_close(qkv, want_qkv, tfa.flash_bwd_ehat_qkv_plain(
                    f["qkv"], f["dmerged"], f["r"], 3))
            else:
                for g, w in zip(got + qkv, want + want_qkv):
                    torch.testing.assert_close(g, w, **TOL)
        for start in (0, 1, 4):
            got = trp.self_attention_relevancy_pallas(cams, grads, start)
            want = trp.self_attention_relevancy_pallas_plain(cams, grads,
                                                             start)
            assert got.dtype == torch.float32
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    finally:
        torch.set_default_dtype(old)


@pytest.mark.cuda
def test_bf16_tensors_need_fast_dots_on_cuda(cuda):
    """bf16 tensors without fast_dots run the fp32 kernels on bf16 storage
    (counted in ``launches``, none in ``launches_bf16``), equal to the bit
    to the fp32 kernels on the widened tensors rounded once; float16 and
    mixed dtypes still raise before any launch."""
    a = _stored(to_torch(attn_inputs(1, 5, 16), cuda), torch.bfloat16)
    f = _stored(to_torch(flash_inputs(1, 2, 5, 8), cuda), torch.bfloat16)
    tab.reset_launch_counts()
    tfa.reset_launch_counts()
    for call in (lambda a, f: attn_fwd(tab, a, 2),
                 lambda a, f: tfa.flash_fwd(f["q"], f["k"], f["v"]),
                 lambda a, f: tfa.flash_bwd_ehat_qkv(f["qkv"], f["dmerged"],
                                                     f["r"], 2)):
        got = call(a, f)
        want = call(_f32(a), _f32(f))
        got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
        for g, w in zip(got, want):
            assert torch.equal(g, w.to(g.dtype))
        assert got[0].dtype == torch.bfloat16
    with pytest.raises(RuntimeError, match="float16"):
        tfa.flash_fwd(f["q"].half(), f["k"].half(), f["v"].half())
    with pytest.raises(RuntimeError, match="float32"):   # mixed dtypes
        tfa.flash_fwd(f["q"].float(), f["k"], f["v"], fast_dots=True)
    assert set({**tab.bf16_launch_counts(),
                **tfa.bf16_launch_counts()}.values()) == {0}
    assert tab.attn_block_fwd.launches == 2
    assert tfa.flash_fwd.launches == tfa.flash_bwd_ehat_qkv.launches == 2


def gemm_bf16_cuda(a, b, **kw):
    return tab._gemm_bf16(tab.library(fast_dots=True), a, b,
                          _build.stream(a.device), **kw)


# (M, N, K, batch): the main path's widths at B=1, 8 and 32 (M = 197,
# 1576, 6304); M at the edges of the 128-row tiles (127, 128, 129) and of
# the waves (1576 rows and 768 columns: 78 tiles of 128 x 128 for 132 SMs);
# N = 769 and 70 (ragged column tiles, rows of a B[K, N] that the wrapper
# copies transposed); K = 5 and 33 (zero-padded to 8 and 40 by the
# wrapper), 197 and 3072 (the longest K of the path); three products of
# one call (batch 3)
GEMM_BF16_SHAPES = [(1, 1, 1, 1), (7, 33, 197, 1), (33, 7, 5, 1),
                    (127, 769, 5, 1), (128, 768, 33, 1), (129, 70, 768, 1),
                    (130, 70, 33, 1), (197, 768, 768, 1),
                    (1576, 2304, 768, 1), (1576, 768, 3072, 1),
                    (6304, 768, 3072, 1), (6304, 3072, 768, 1),
                    (130, 72, 96, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("M,N,K,batch", GEMM_BF16_SHAPES)
@pytest.mark.parametrize("dtypes", ["f32 f32 f32", "bf16 f32 bf16",
                                    "bf16 bf16 f32", "f32 bf16 bf16"])
def test_gemm_bf16_matches_rounded_operands_in_float64(cuda, M, N, K, batch,
                                                       trans_b, dtypes):
    """The bf16-product GEMM (a, b and out each float32 or bfloat16: the
    four storage pairs of a and b) against the float64 product of the
    operands rounded to bf16 (``gemm_plain`` with fast_dots in float64):
    the rounding is the same (to nearest even), so only the fp32 sum
    differs, within GEMM_BAR · max|C64| for a float32 output and one bf16
    rounding for a bfloat16 one; the same bits twice. The wrapper's copies
    (K not a multiple of 8, or N of a B[K, N]) are counted, none on the
    aligned shapes."""
    da, db, dout = ({"f32": torch.float32, "bf16": torch.bfloat16}[x]
                    for x in dtypes.split())
    lead = (batch,) if batch > 1 else ()
    a, b = (torch.from_numpy(t).to(cuda)
            for t in gemm_operands(M, N, K, trans_b, seed=6, lead=lead))
    a, b = a.to(da), b.to(db)
    tab.reset_launch_counts()
    got = gemm_bf16_cuda(a, b, trans_b=trans_b, out_dtype=dout)
    torch.cuda.synchronize()
    assert got.dtype == dout and got.shape == (*lead, M, N)
    _, copy_a, copy_b, _ = tab.gemm_bf16_copies(K, N, trans_b)
    assert tab._gemm_bf16.copies == copy_a + copy_b
    assert (copy_a or copy_b) == (K % 8 != 0 or (not trans_b and N % 8 != 0))
    want = tab.gemm_plain(a.double(), b.double(), trans_b, fast_dots=True)
    if dout == torch.float32:
        assert_near_f64(got, want)
    else:
        err = float((got.double() - want).abs().max())
        assert err <= 2.0 ** -8 * float(want.abs().max()), err
    assert torch.equal(gemm_bf16_cuda(a, b, trans_b=trans_b,
                                      out_dtype=dout), got)


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("epilogue", GEMM_EPILOGUES)
@pytest.mark.parametrize("dtype", FAST_DTYPES)
@pytest.mark.parametrize("M,N,K,batch", [(197, 769, 768, 1),
                                         (129, 768, 33, 1),
                                         (1576, 768, 3072, 1),
                                         (130, 72, 96, 3)])
def test_gemm_bf16_epilogues(cuda, epilogue, trans_b, dtype, M, N, K, batch):
    """Each epilogue with bias and res in float32 or bfloat16 (aux
    float32), in fp32 before the float32 output, against float64 within
    GEMM_BAR · max|C64|, the same bits twice: ragged columns (N = 769, one
    column at a time), a padded K, the longest K of the path, and a batch
    of three products with bias over the columns of each."""
    lead = (batch,) if batch > 1 else ()
    a, b = (torch.from_numpy(t).to(cuda)
            for t in gemm_operands(M, N, K, trans_b, seed=7, lead=lead))
    rng = np.random.RandomState(8)
    bias, res, aux = (torch.from_numpy(t.astype(np.float32)).to(cuda)
                      for t in (rng.randn(N), rng.randn(*lead, M, N),
                                rng.randn(*lead, M, N)))
    bias, res = bias.to(dtype), res.to(dtype)
    kw = {"bias": dict(bias=bias),
          "bias_res": dict(bias=bias, res=res),
          "bias_gelu": dict(bias=bias, act=tab._ACT_GELU),
          "gelu_grad_aux_is_out": dict(aux=aux, act=tab._ACT_MUL_GELU_GRAD),
          "res": dict(res=res)}[epilogue]
    got = gemm_bf16_cuda(a, b, trans_b=trans_b, **kw)
    torch.cuda.synchronize()
    want = tab.gemm_plain(a.double(), b.double(), trans_b, fast_dots=True,
                          **{k: v.double() if torch.is_tensor(v) else v
                             for k, v in kw.items()})
    assert_near_f64(got, want)
    assert torch.equal(gemm_bf16_cuda(a, b, trans_b=trans_b, **kw), got)


@pytest.mark.cuda
def test_gemm_bf16_library_runs_wgmma_and_lost_the_mma_sync_kernel(cuda):
    """The built bf16 library's SASS: the GEMM is the wgmma kernel (HGMMA
    instructions, TMA loads), and the mma.sync kernel it replaced
    (``gemm_bf16_kernel``) is gone; the launcher's tile table takes 64
    columns only where 128 would leave more than half the SMs idle."""
    lib = tab.library(fast_dots=True)
    sass = _sass("attn_block_bf16")
    functions = re.findall(r"Function : (\S+)", sass)
    gemm = [f for f in functions if "gemm_bf16" in f]
    assert gemm and all("gemm_bf16_wgmma_kernel" in f for f in gemm), gemm
    body = sass[sass.index(gemm[0]):]
    assert "HGMMA.64x" in body and "UTMALDG" in body
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for M, N, batch in ((197, 768, 1), (197, 3072, 1), (1576, 768, 1),
                        (6304, 3072, 1), (130, 72, 3)):
        tiles128 = -(-M // 128) * -(-N // 128) * batch
        want = 64 if 2 * tiles128 < sms else 128
        assert lib.tmx_gemm_bf16_tile(M, N, batch) == want, (M, N, batch)


@pytest.mark.cuda
@pytest.mark.parametrize("path,kernels", [
    ("relevancy_fused_block2", ("attn_block_fwd", "mlp_block_fwd",
                                "mlp_block_bwd", "attn_block_bwd")),
    ("relevancy_fused", ("flash_fwd_qkv", "flash_bwd_ehat_qkv")),
    ("relevancy_fused_block", ("attn_block_fwd", "attn_block_bwd"))])
def test_fused_paths_fast_dots_on_kernels(cuda, path, kernels):
    """The three paths with fast_dots: the bf16-product kernels depth times
    each and nothing else; the maps within the JAX package's bar of its
    chip's fast mode (max|Δ| ≤ 1e-4 or 0.5 % of max|ref|) of the fp32 maps,
    on the CPU's plain fast_dots maps likewise; a bfloat16 model with
    bfloat16 images runs the same kernels to finite float32 maps."""
    cfg = tvit.ViTConfig(image_size=64, patch_size=16, width=64, depth=3,
                         num_heads=4, num_classes=10)
    cpu = tvit.init_params(0, cfg, "cpu")
    model = tvit.init_params(0, cfg, cuda)
    gen = torch.Generator().manual_seed(1)
    images = torch.randn((3, 64, 64, 3), generator=gen)
    targets = torch.tensor([1, 2, 3])
    fn = getattr(tvit, path)
    mods = (tab, tfa)
    for mod in mods:
        mod.reset_launch_counts()
    got = fn(model, images.to(cuda), targets.to(cuda), fast_dots=True)
    torch.cuda.synchronize()
    launched = {k: v for m in mods for k, v in {**m.launch_counts(),
                                                **m.bf16_launch_counts()}
                .items()}
    fast = {f"{k}_bf16" for k in kernels}
    assert launched == {k: cfg.depth if k in fast else 0 for k in launched}
    for ref in (fn(model, images.to(cuda), targets.to(cuda)).cpu(),
                fn(cpu, images, targets, fast_dots=True)):
        err = float((got.cpu() - ref).abs().max())
        assert err <= 1e-4 or err <= 5e-3 * float(ref.abs().max()), err
    m16 = tvit.init_params(0, cfg, cuda).to(torch.bfloat16)
    maps = fn(m16, images.to(cuda, torch.bfloat16), targets.to(cuda),
              fast_dots=True)
    assert maps.dtype == torch.float32 and torch.isfinite(maps).all()


@pytest.mark.cuda
def test_bench_bf16_maps_per_sec_on_cuda(cuda, monkeypatch):
    """``cli bench``'s record on the card: bf16_maps_per_sec and its
    spread, positive (fewer timed calls than the bench's own)."""
    from transformer_mm_explainability_tpu_torch import bench

    monkeypatch.setattr(bench, "TRIALS", 2)
    monkeypatch.setattr(bench, "ITERS", 2)
    rec = bench.measure("cuda")
    lo, hi = rec["spread"]["bf16"]
    assert rec["value"] > 0 and 0 < lo <= rec["bf16_maps_per_sec"] <= hi


# ---------------------------------------------------------------------------
# bf16 storage with fp32 products (fast_dots off on bf16 tensors): the fp32
# kernels read and write bf16 themselves, so each call equals, to the bit,
# the fp32 kernels on the widened tensors with its bf16 outputs rounded once
# (e_row float32, equal).
# ---------------------------------------------------------------------------

def _equal_rounded(got, want):
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype in (torch.bfloat16, torch.float32)
        assert torch.equal(g, w.to(g.dtype)), float(
            (g.float() - w.to(g.dtype).float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,D", CUDA_ATTN)
def test_attn_block_kernels_on_bf16_storage_equal_fp32_kernels(cuda, B, H, S,
                                                               D):
    a = _stored(to_torch(attn_inputs(B, S, D), cuda), torch.bfloat16)
    for call in (attn_fwd, attn_bwd):
        before = tab.attn_block_fwd.launches_bf16 + \
            tab.attn_block_bwd.launches_bf16
        got = call(tab, a, H)
        assert (got[0] if isinstance(got, tuple) else got).dtype \
            == torch.bfloat16
        _equal_rounded(got, call(tab, _f32(a), H))
        assert tab.attn_block_fwd.launches_bf16 + \
            tab.attn_block_bwd.launches_bf16 == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,I,chunks", CUDA_MLP)
def test_mlp_block_kernels_on_bf16_storage_equal_fp32_kernels(cuda, B, S, D,
                                                              I, chunks):
    m = _stored(to_torch(mlp_inputs(B, S, D, I), cuda), torch.bfloat16)
    for call in (mlp_fwd, mlp_bwd):
        got = call(tab, m, chunks)
        assert got.dtype == torch.bfloat16
        _equal_rounded(got, call(tab, _f32(m), chunks))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,Dh", FLASH_SHAPES + [(8, 12, 197, 64)])
def test_flash_kernels_on_bf16_storage_equal_fp32_kernels(cuda, B, H, S, Dh):
    """The four flash wrappers on bf16 tensors, the per-head ones on
    contiguous tensors and on split-head views of the merged qkv (16-byte
    copies where dh is a multiple of 8, else copies of one element)."""
    f = _stored(to_torch(flash_inputs(B, H, S, Dh), cuda), torch.bfloat16)
    w = _f32(f)
    views = lambda t: (*tfa.qkv_heads(t["qkv"], H),
                       tfa.heads(t["dmerged"], H))
    for t, per_head in ((f, (f["q"], f["k"], f["v"], f["dout"])),
                        (f, views(f))):
        ref = (w["q"], w["k"], w["v"], w["dout"])
        _equal_rounded(tfa.flash_fwd(*per_head[:3]), tfa.flash_fwd(*ref[:3]))
        _equal_rounded(tfa.flash_bwd_ehat(*per_head, f["r"]),
                       tfa.flash_bwd_ehat(*ref, w["r"]))
    _equal_rounded(tfa.flash_fwd_qkv(f["qkv"], H),
                   tfa.flash_fwd_qkv(w["qkv"], H))
    _equal_rounded(tfa.flash_bwd_ehat_qkv(f["qkv"], f["dmerged"], f["r"], H),
                   tfa.flash_bwd_ehat_qkv(w["qkv"], w["dmerged"], w["r"], H))


@pytest.mark.cuda
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("M,N,K,batch", [(1, 1, 1, 1), (33, 7, 5, 1),
                                         (130, 70, 33, 1), (197, 768, 768, 1),
                                         (1576, 768, 3072, 1),
                                         (130, 72, 96, 3)])
@pytest.mark.parametrize("dtypes", ["bf16 f32", "f32 bf16", "bf16 bf16"])
@pytest.mark.parametrize("epilogue", ["none", "bias+res bf16", "gelu bf16 out",
                                      "gelu'(aux)"])
def test_gemm_on_bf16_storage_equals_fp32_gemm(cuda, M, N, K, batch, trans_b,
                                               dtypes, epilogue):
    """``_gemm`` with bf16 a and / or b (and a bf16 bias, residual or
    output) against the fp32 GEMM on the widened tensors, its output
    rounded once: equal to the bit, whatever copy width the rows allow."""
    gen = torch.Generator().manual_seed(M + N + K)
    lead = (batch,) if batch > 1 else ()
    rnd = lambda *s: torch.randn(s, generator=gen).to(cuda)
    da, db = (torch.bfloat16 if d == "bf16" else torch.float32
              for d in dtypes.split())
    a = rnd(*lead, M, K).to(da)
    b = (rnd(*lead, N, K) if trans_b else rnd(*lead, K, N)).to(db)
    kw, kw32, out_dtype = {}, {}, torch.float32
    if epilogue == "bias+res bf16":
        kw = dict(bias=rnd(N).bfloat16(), res=rnd(*lead, M, N).bfloat16())
    elif epilogue == "gelu bf16 out":
        kw, out_dtype = dict(bias=rnd(N), act=tab._ACT_GELU), torch.bfloat16
    elif epilogue == "gelu'(aux)":
        kw = dict(aux=rnd(*lead, M, N), act=tab._ACT_MUL_GELU_GRAD)
    kw32 = {k: v.float() if torch.is_tensor(v) else v for k, v in kw.items()}
    lib, st = tab.library(), _build.stream(cuda)
    got = tab._gemm(lib, a, b, st, trans_b=trans_b, out_dtype=out_dtype, **kw)
    want = tab._gemm(lib, a.float(), b.float(), st, trans_b=trans_b, **kw32)
    assert got.dtype == out_dtype
    assert torch.equal(got, want.to(out_dtype))
    # one bf16 element off the 16-byte grid: copies of one element, the
    # same bits
    if K > 1 and da == torch.bfloat16 and batch == 1:
        a_off = torch.empty(M * K + 1, device=cuda,
                            dtype=torch.bfloat16)[1:].view(M, K)
        a_off.copy_(a)
        assert tab.gemm_copy_width(a_off, b) == 4
        assert torch.equal(tab._gemm(lib, a_off, b, st, trans_b=trans_b,
                                     out_dtype=out_dtype, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,C,K,P", [(5, 6, 4, 3, 7), (9, 13, 8, 40, 7),
                                       (50, 76, 1024, 100, 14),
                                       (7, 9, 6, 11, 4)])
def test_roi_pool_kernel_on_bf16_features_equals_plain(cuda, H, W, C, K, P):
    feats, boxes = roi_inputs(H, W, C, K)
    f = torch.from_numpy(feats).to(cuda, torch.bfloat16)
    b = torch.from_numpy(boxes).to(cuda)
    before = trpool.roi_pool_pallas.launches
    got = trpool.roi_pool_pallas(f, b, P, 1 / 16)
    assert trpool.roi_pool_pallas.launches == before + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, trpool.roi_pool_plain(f, b, P, 1 / 16))
    # a map off the 8-byte grid: one channel a load, the same bits
    off = torch.empty(H * W * C + 1, device=cuda,
                      dtype=torch.bfloat16)[1:].view(H, W, C)
    off.copy_(f)
    assert torch.equal(trpool.roi_pool_pallas(off, b, P, 1 / 16), got)
    # non-finite maxima become 0 in bf16 too
    f[0, 0, 0], f[-1, -1, -1] = float("nan"), float("inf")
    assert torch.equal(trpool.roi_pool_pallas(f, b, P, 1 / 16),
                       trpool.roi_pool_plain(f, b, P, 1 / 16))
