"""The port's Faster R-CNN slice against the JAX package: RoIPool (the plain
version behind the CUDA kernel's wrapper), the ResNet pieces, anchors, NMS,
the forward and the converters.

Inputs and weights are made with numpy from a seed, the weights in the
JAX package's tree (the structure of its ``init_params``, from
``jax.eval_shape``) and carried across with ``frcnn_from_jax_numpy``; the
JAX functions run under ``jax.jit``. Stated tolerances: exact (equal
arrays) for RoIPool, its bin bounds, anchors and NMS indices (a max and
integer arithmetic round nothing, and the NMS tests feed both packages the
same float32 boxes); rtol 1e-4 / atol 1e-5 for convolution outputs (fp32 on
both sides, in other summation orders; the atol scaled by the output's
largest magnitude where it exceeds 1); index outputs of the forward equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.models import frcnn as jfrcnn
from transformer_mm_explainability_tpu.models import resnet as jresnet
from transformer_mm_explainability_tpu.ops import roi_pool_pallas as jrpool
from transformer_mm_explainability_tpu.utils import convert as jconvert
from transformer_mm_explainability_tpu_torch.models import frcnn as tfrcnn
from transformer_mm_explainability_tpu_torch.models import resnet as tresnet
from transformer_mm_explainability_tpu_torch.ops import roi_pool_pallas as trpool
from transformer_mm_explainability_tpu_torch.utils import convert as tconvert

from test_torch_kernels_cuda import FRCNN_TINY, roi_inputs

JTINY, TTINY = jfrcnn.FrcnnConfig(**FRCNN_TINY), tfrcnn.FrcnnConfig(**FRCNN_TINY)
# (H, W, C, K, P): the shape of tests/test_frcnn.py's pallas test, C not a
# multiple of 4, and K = 1
ROI_SHAPES = [(25, 38, 96, 11, 14), (13, 17, 30, 7, 4), (9, 9, 5, 1, 2)]


def assert_conv_close(got, want, err_msg=""):
    """rtol 1e-4, atol 1e-5 of the output's largest magnitude: relu(out +
    x) cancels to values far below the sums that form them."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=1e-4, atol=1e-5 * max(1.0, float(np.abs(want).max())),
        err_msg=err_msg)


def numpy_params(init, seed):
    """The tree ``init()`` would make, filled with numpy draws: He-scaled
    backbone convs, RPN convs and linear weights of std 0.01 (as the JAX
    init draws them), frozen BN near identity."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", None)
        if len(s.shape) == 4 and getattr(path[0], "key", None) != "rpn":
            scale = (2.0 / (s.shape[0] * s.shape[1] * s.shape[2])) ** 0.5
            return (rng.randn(*s.shape) * scale).astype(np.float32)
        if name in ("weight", "var"):
            return (1 + 0.1 * np.abs(rng.randn(*s.shape))).astype(np.float32)
        sd = 0.05 if len(s.shape) == 1 else 0.01
        return (rng.randn(*s.shape) * sd).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init))


@pytest.fixture(scope="module")
def jparams():
    return numpy_params(
        lambda: jfrcnn.init_params(jax.random.PRNGKey(0), JTINY), 0)


_jforward = jax.jit(jfrcnn.forward, static_argnums=2)


@pytest.fixture(scope="module")
def tparams(jparams):
    return tconvert.frcnn_from_jax_numpy(jax.tree.map(np.asarray, jparams),
                                         TTINY, device="cpu")


# ---------------------------------------------------------------------------
# RoIPool (kernel #10's plain version and the CPU wrapper)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,W,C,K,P", ROI_SHAPES)
def test_roi_bin_bounds_equal_jax(H, W, C, K, P):
    _, boxes = roi_inputs(H, W, C, K)
    want = jrpool.roi_bin_bounds(jnp.asarray(boxes), P, 1 / 16, H, W)
    got = trpool.roi_bin_bounds(torch.from_numpy(boxes), P, 1 / 16, H, W)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("H,W,C,K,P", ROI_SHAPES)
def test_roi_pool_equals_jax_pallas_and_xla(H, W, C, K, P):
    """The CPU wrapper (the plain version) == JAX's Pallas kernel in
    interpret mode == JAX's chunked-gather ``frcnn.roi_pool``, exactly."""
    feats, boxes = roi_inputs(H, W, C, K)
    want = np.asarray(jfrcnn.roi_pool(jnp.asarray(feats), jnp.asarray(boxes),
                                      P, 1 / 16))
    np.testing.assert_array_equal(want, np.asarray(jrpool.roi_pool_pallas(
        jnp.asarray(feats), jnp.asarray(boxes), P, 1 / 16, interpret=True)))
    tf, tb = torch.from_numpy(feats), torch.from_numpy(boxes)
    trpool.reset_launch_counts()
    got = trpool.roi_pool_pallas(tf, tb, P, 1 / 16)
    assert trpool.launch_counts() == {"roi_pool_pallas": 0}   # CPU: plain
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tfrcnn.roi_pool(tf, tb, P, 1 / 16).numpy(), want)


def _roi_pool_loops(feats, boxes, P, scale):
    """RoIPool bin by bin in numpy from the same bounds (independent of
    both packages' vectorised passes)."""
    H, W, C = feats.shape
    hs, he, ws, we = (t.numpy() for t in trpool.roi_bin_bounds(
        torch.from_numpy(boxes), P, scale, H, W))
    out = np.zeros((len(boxes), P, P, C), np.float32)
    for k in range(len(boxes)):
        for i in range(P):
            for j in range(P):
                win = feats[hs[k, i]:he[k, i], ws[k, j]:we[k, j]]
                if win.size:
                    m = win.reshape(-1, C).max(0)
                    out[k, i, j] = np.where(np.isfinite(m), m, 0)
    return out


@pytest.mark.parametrize("chunk", [1, 3, 16])
def test_roi_pool_plain_equals_bin_loops_with_wide_bins(monkeypatch, chunk):
    """Chunking changes nothing, and a box larger than the map (bins wider
    than the JAX xla path's fixed candidate window) pools its whole bins."""
    monkeypatch.setattr(trpool, "PLAIN_CHUNK", chunk)
    feats, boxes = roi_inputs(14, 18, 6, 9, seed=4)
    boxes[3] = [-400, -300, 900, 700]
    feats[2, 3, 1] = np.inf
    got = trpool.roi_pool_plain(torch.from_numpy(feats),
                                torch.from_numpy(boxes), 3, 1 / 16)
    np.testing.assert_array_equal(got.numpy(),
                                  _roi_pool_loops(feats, boxes, 3, 1 / 16))


@pytest.mark.parametrize("bad,match", [
    (lambda f, b: (f.double(), b), "float32"),
    (lambda f, b: (f, b.double()), "float32"),
    (lambda f, b: (f.transpose(0, 1), b), "contiguous"),
    (lambda f, b: (f[None], b), r"\[H, W, C\]"),
    (lambda f, b: (f, b[None]), r"\[K, 4\]")])
def test_roi_pool_wrapper_checks_inputs_on_cpu(bad, match):
    feats, boxes = (torch.from_numpy(t) for t in roi_inputs(10, 12, 8, 3))
    with pytest.raises(RuntimeError, match=match):
        trpool.roi_pool_pallas(*bad(feats, boxes), 4, 1 / 16)


def test_roi_pool_no_boxes():
    feats = torch.zeros((5, 6, 3))
    for fn in (trpool.roi_pool_pallas, trpool.roi_pool_plain):
        assert fn(feats, torch.zeros((0, 4)), 2, 1.0).shape == (0, 2, 2, 3)


# ---------------------------------------------------------------------------
# ResNet pieces
# ---------------------------------------------------------------------------

def _nchw(x):
    return tresnet.to_nchw(torch.from_numpy(np.asarray(x)))


def _oihw(w):
    return torch.from_numpy(np.asarray(w).transpose(3, 2, 0, 1).copy())


@pytest.mark.parametrize("H,W", [(7, 7), (8, 10), (9, 12), (15, 16)])
def test_caffe_pool_ceil_mode_equals_jax(H, W):
    """ceil_mode=True gives the JAX bottom/right −inf padding's size and
    values (exactly: a max)."""
    x = np.random.RandomState(H * W).randn(2, H, W, 5).astype(np.float32)
    want = np.asarray(jresnet.max_pool_3x3_s2_caffe(jnp.asarray(x)))
    got = tresnet.to_nhwc(tresnet.max_pool_3x3_s2_caffe(_nchw(x))).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tresnet.to_nhwc(tresnet.max_pool_3x3_s2(_nchw(x))).numpy(),
        np.asarray(jresnet.max_pool_3x3_s2(jnp.asarray(x))))


@pytest.mark.parametrize("k,stride,dilation", [(7, 2, 1), (1, 2, 1),
                                               (3, 1, 2), (3, 2, 1)])
def test_conv_and_frozen_bn_equal_jax(k, stride, dilation):
    rng = np.random.RandomState(k + stride)
    x = rng.randn(2, 17, 14, 8).astype(np.float32)
    w = (rng.randn(k, k, 8, 12) * 0.2).astype(np.float32)
    bn = {"weight": rng.rand(12).astype(np.float32) + 0.5,
          "bias": rng.randn(12).astype(np.float32),
          "mean": rng.randn(12).astype(np.float32),
          "var": rng.rand(12).astype(np.float32) + 0.1}
    want = np.asarray(jresnet.frozen_bn(jresnet.conv(
        jnp.asarray(x), jnp.asarray(w), stride, dilation),
        {n: jnp.asarray(v) for n, v in bn.items()}))
    got = tresnet.frozen_bn(tresnet.conv(_nchw(x), _oihw(w), stride,
                                         dilation),
                            {n: torch.from_numpy(v) for n, v in bn.items()})
    assert_conv_close(tresnet.to_nhwc(got).numpy(), want)


@pytest.mark.parametrize("dilation_last", [False, True])
def test_resnet_forward_equals_jax(dilation_last):
    jp = numpy_params(lambda: jresnet.init_params(
        jax.random.PRNGKey(1), (1, 1, 1, 1), width=8), 1)
    tp = tconvert._to_torch(jp, "cpu", hwio=True)
    x = np.random.RandomState(2).randn(1, 40, 32, 3).astype(np.float32)
    want = np.asarray(jax.jit(jresnet.forward, static_argnums=2)(
        jp, jnp.asarray(x), dilation_last))
    got = tresnet.forward(tp, torch.from_numpy(x), dilation_last)
    assert got.is_contiguous() and got.shape == want.shape
    assert_conv_close(got.numpy(), want)


def test_backbone_and_res5_head_equal_jax(jparams, tparams):
    img = np.random.RandomState(3).randn(1, 64, 80, 3).astype(np.float32)
    want = np.asarray(jax.jit(jfrcnn._res4_features, static_argnums=2)(
        jparams, jnp.asarray(img), JTINY))
    got = tfrcnn._res4_features(tparams, torch.from_numpy(img), TTINY)
    assert_conv_close(got.numpy(), want)
    # the [Hf, Wf, 1024] map RoIPool takes is a view, not a copy
    assert got[0].is_contiguous()
    rois = np.random.RandomState(4).randn(3, 4, 4, 1024).astype(np.float32)
    want = np.asarray(jax.jit(jfrcnn._res5_head, static_argnums=2)(
        jparams, jnp.asarray(rois), JTINY))
    got = tfrcnn._res5_head(tparams, torch.from_numpy(rois), TTINY)
    assert_conv_close(got.numpy(), want)


def test_channels_last_nhwc_view_is_free():
    x = torch.randn(1, 6, 5, 7).contiguous(memory_format=torch.channels_last)
    assert tresnet.to_nhwc(x).data_ptr() == x.data_ptr()
    assert tresnet.to_nchw(tresnet.to_nhwc(x)).data_ptr() == x.data_ptr()


# ---------------------------------------------------------------------------
# anchors, boxes, NMS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg_kw,hw", [(FRCNN_TINY, (2, 3)), ({}, (5, 7))])
def test_anchor_grid_equals_jax(cfg_kw, hw):
    want = np.asarray(jfrcnn.anchor_grid(*hw, jfrcnn.FrcnnConfig(**cfg_kw)))
    got = tfrcnn.anchor_grid(*hw, tfrcnn.FrcnnConfig(**cfg_kw))
    np.testing.assert_array_equal(got.numpy(), want)


def test_box_ops_equal_jax():
    rng = np.random.RandomState(5)
    # sorted along a row: x0 < y0 < x1 < y1, a valid xyxy box
    boxes = np.sort(rng.rand(20, 4).astype(np.float32) * 100, axis=1)
    deltas = (rng.randn(20, 4) * 2).astype(np.float32)
    jb, tb = jnp.asarray(boxes), torch.from_numpy(boxes)
    want = np.array(jfrcnn.apply_deltas(jb, jnp.asarray(deltas),
                                        (10, 10, 5, 5)))
    got = tfrcnn.apply_deltas(tb, torch.from_numpy(deltas), (10, 10, 5, 5))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(
        tfrcnn.clip_boxes(torch.from_numpy(want), 60, 70).numpy(),
        np.asarray(jfrcnn.clip_boxes(jnp.asarray(want), 60, 70)))
    np.testing.assert_array_equal(tfrcnn.nonempty(tb).numpy(),
                                  np.asarray(jfrcnn.nonempty(jb)))


def _random_boxes(rng, n, spread=60.0, size=40.0):
    ctr = rng.uniform(0, spread, (n, 2))
    wh = rng.uniform(4, size, (n, 2))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)


@pytest.mark.parametrize("seed,n,max_out", [(0, 300, 100), (1, 300, 100),
                                            (2, 40, 100), (3, 120, 50)])
def test_nms_indices_equal_jax(seed, n, max_out):
    """nms_fixed and nms_blocked (every block size) give JAX nms_fixed's
    indices, with score ties, identical and zero-area boxes and −inf-masked
    entries. With n < max_out the candidates run out: JAX's while_loop
    stops, the port's fixed loop runs on, and the outputs are the same."""
    rng = np.random.RandomState(seed)
    boxes = _random_boxes(rng, n)
    boxes[10:14] = boxes[5]                  # identical boxes
    boxes[20:22] = [3.0, 3.0, 3.0, 9.0]      # zero area
    scores = rng.rand(n).astype(np.float32)
    scores[10:18] = 0.5                      # ties: first index wins
    valid = rng.rand(n) > 0.3
    for thresh in (0.3, 0.7):
        j_idx, j_ok = (np.asarray(t) for t in jfrcnn.nms_fixed(
            jnp.asarray(boxes), jnp.asarray(scores), thresh, max_out,
            valid=jnp.asarray(valid)))
        args = (torch.from_numpy(boxes), torch.from_numpy(scores), thresh,
                max_out)
        outs = [tfrcnn.nms_fixed(*args, valid=torch.from_numpy(valid))]
        outs += [tfrcnn.nms_blocked(*args, valid=torch.from_numpy(valid),
                                    block=block) for block in (32, 512)]
        for idx, ok in outs:
            np.testing.assert_array_equal(ok.numpy(), j_ok)
            np.testing.assert_array_equal(idx.numpy(), j_idx)


def test_nms_fixed_loop_identity_when_candidates_run_out():
    """Every slot after the last pick holds index 0 and False."""
    boxes = torch.tensor([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]],
                         dtype=torch.float32)
    idx, ok = tfrcnn.nms_fixed(boxes, torch.tensor([0.9, 0.95, 0.5]), 0.5, 6)
    assert idx.tolist() == [1, 2, 0, 0, 0, 0]
    assert ok.tolist() == [True, True, False, False, False, False]


# ---------------------------------------------------------------------------
# forward, preprocess, converters
# ---------------------------------------------------------------------------

# seed 1: the kept RPN scores lie ≥ 5e-4 apart and the detection scores
# ≥ 3e-4 apart, far above the packages' 1e-5 rounding differences (seeds 0,
# 2, 3 and 4 have exactly tied scores, whose order a 1-ulp difference could
# flip), so no index output hangs on a rounding difference
FORWARD_SEED = 1


def test_forward_equals_jax(jparams, tparams):
    img = np.random.RandomState(FORWARD_SEED).randn(128, 160, 3).astype(
        np.float32)
    want = {k: np.asarray(v) for k, v in
            _jforward(jparams, jnp.asarray(img), JTINY).items()}
    for k in ("roi_scores", "det_scores"):
        assert np.diff(np.sort(want[k])).min() > 1e-4, k
    with torch.no_grad():
        got = {k: v.numpy() for k, v in
               tfrcnn.forward(tparams, torch.from_numpy(img), TTINY).items()}
    assert set(got) == set(want)
    for k, w in want.items():
        if w.dtype.kind in "biu":                  # ids and validity: equal
            np.testing.assert_array_equal(got[k], w.astype(got[k].dtype),
                                          err_msg=k)
        elif k in ("boxes", "rois"):
            # pixels; an edge near 0 comes from cancelling ~100-pixel terms:
            # atol 1e-3 px (the rois' values also fix the RPN picks)
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-3,
                                       err_msg=k)
        else:
            assert_conv_close(got[k], w, err_msg=k)


def test_forward_impls_agree_and_unknown_impls_raise(tparams):
    img = torch.from_numpy(np.random.RandomState(3).randn(64, 96, 3)
                           .astype(np.float32))
    assert TTINY.roi_pool_impl == "pallas"   # the port's default
    with torch.no_grad():
        base = tfrcnn.forward(tparams, img, TTINY)
        for kw in ({"roi_pool_impl": "xla"}, {"nms_impl": "blocked"}):
            other = tfrcnn.forward(tparams, img,
                                   dataclasses.replace(TTINY, **kw))
            for k in base:
                assert torch.equal(base[k], other[k]), (kw, k)
    for kw, match in (({"roi_pool_impl": "triton"}, "roi_pool_impl"),
                      ({"nms_impl": "greedy"}, "nms_impl")):
        with pytest.raises(ValueError, match=match):
            tfrcnn.forward(tparams, img, dataclasses.replace(TTINY, **kw))


def test_forward_on_stage_marks_each_stage(tparams):
    seen = []
    img = torch.zeros((64, 64, 3))
    with torch.no_grad():
        tfrcnn.forward(tparams, img, TTINY, on_stage=seen.append)
    assert seen == ["backbone", "rpn+nms", "roi_pool", "res5", "heads"]


def test_preprocess_equals_jax():
    """BGR, mean subtraction, shortest-edge bilinear resize. The resize
    filters' fp32 weights differ in the last bits: atol 1e-3 on pixel
    values up to 255 (about 4e-6 relative)."""
    img = np.random.RandomState(6).randint(0, 256, (60, 91, 3)).astype(
        np.uint8)
    for shortest, cap in ((80, 1333), (40, 50)):
        want = np.asarray(jfrcnn.preprocess(jnp.asarray(img), shortest, cap))
        got = tfrcnn.preprocess(img, shortest, cap)
        assert got.shape == want.shape and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def _frcnn_state_dict(seed=0):
    """A detectron2-layout state dict (the unc-nlp key schema) for the
    stage sizes (1, 1, 1, 1), 9 classes, 5 attributes, 1 anchor pair."""
    rng = np.random.RandomState(seed)
    t = lambda *s, sc=0.05: torch.from_numpy((rng.randn(*s) * sc)
                                             .astype(np.float32))
    sd = {}

    def conv(p, cout, cin, k, bias=False, norm=True):
        sd[f"{p}.weight"] = t(cout, cin, k, k)
        if bias:
            sd[f"{p}.bias"] = t(cout, sc=0.01)
        if norm:
            sd[f"{p}.norm.weight"] = 1 + t(cout)
            sd[f"{p}.norm.bias"] = t(cout)
            sd[f"{p}.norm.running_mean"] = t(cout)
            sd[f"{p}.norm.running_var"] = 1 + t(cout).abs()

    def lin(p, din, dout):
        sd[f"{p}.weight"] = t(dout, din, sc=0.02)
        sd[f"{p}.bias"] = t(dout, sc=0.01)

    conv("backbone.stem.conv1", 64, 3, 7)
    in_ch = 64
    for si in range(3):
        mid = 64 * 2 ** si
        p = f"backbone.res{si + 2}.0"
        conv(f"{p}.conv1", mid, in_ch, 1)
        conv(f"{p}.conv2", mid, mid, 3)
        conv(f"{p}.conv3", mid * 4, mid, 1)
        conv(f"{p}.shortcut", mid * 4, in_ch, 1)
        in_ch = mid * 4
    p = "roi_heads.res5.0"
    conv(f"{p}.conv1", 512, in_ch, 1)
    conv(f"{p}.conv2", 512, 512, 3)
    conv(f"{p}.conv3", 2048, 512, 1)
    conv(f"{p}.shortcut", 2048, in_ch, 1)
    rpn = "proposal_generator.rpn_head"
    conv(f"{rpn}.conv", 1024, 1024, 3, bias=True, norm=False)
    conv(f"{rpn}.objectness_logits", 2, 1024, 1, bias=True, norm=False)
    conv(f"{rpn}.anchor_deltas", 8, 1024, 1, bias=True, norm=False)
    lin("roi_heads.box_predictor.cls_score", 2048, 10)
    lin("roi_heads.box_predictor.bbox_pred", 2048, 4)
    sd["roi_heads.box_predictor.cls_embedding.weight"] = t(10, 256)
    lin("roi_heads.box_predictor.fc_attr", 2048 + 256, 512)
    lin("roi_heads.box_predictor.attr_score", 512, 6)
    return {f"model.{k}": v for k, v in sd.items()}


def test_frcnn_from_state_dict_equals_jax_converter():
    cfg_kw = dict(FRCNN_TINY, rpn_hidden_dim=1024, cls_agnostic_bbox_reg=True,
                  max_detections=4)
    jcfg, tcfg = jfrcnn.FrcnnConfig(**cfg_kw), tfrcnn.FrcnnConfig(**cfg_kw)
    sd = _frcnn_state_dict()
    jp = jconvert.frcnn_from_state_dict(sd, jcfg)
    tp = tconvert.frcnn_from_state_dict(sd, tcfg, device="cpu")
    rebuilt = tconvert.frcnn_from_jax_numpy(jax.tree.map(np.asarray, jp),
                                            tcfg, device="cpu")
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(rebuilt)):
        assert torch.equal(a, b)
    w = tp["backbone"]["layers"][0][0]["conv2"]["w"]
    assert w.shape == (64, 64, 3, 3)
    assert w.is_contiguous(memory_format=torch.channels_last)
    img = np.random.RandomState(1).randn(96, 128, 3).astype(np.float32)
    want = _jforward(jp, jnp.asarray(img), jcfg)["roi_features"]
    with torch.no_grad():
        got = tfrcnn.forward(tp, torch.from_numpy(img), tcfg)["roi_features"]
    assert_conv_close(got.numpy(), want)
    with pytest.raises(ValueError, match="stages"):
        tconvert.frcnn_from_jax_numpy(jax.tree.map(np.asarray, jp),
                                      dataclasses.replace(tcfg,
                                                          stages=(1, 1, 2, 1)),
                                      device="cpu")


def test_init_params_seeded_and_on_device():
    a = tfrcnn.init_params(3, TTINY, device="cpu")
    b = tfrcnn.init_params(torch.Generator().manual_seed(3), TTINY,
                           device="cpu")
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert torch.equal(x, y) and x.device.type == "cpu"
