"""The port's DETR harness pieces against the JAX package: box_ops, Otsu,
the mask pipeline (``masks_from_relevancy``, the bit packing),
``keep_detections``, ``explain_image`` (no bucket padding, chunked against
single pass, the ceil-division feature grid), the AP evaluator, the
Hungarian matcher and the losses, and the segmentation heads.

Stated tolerances: rtol 1e-4 / atol 1e-5 for costs, losses, attention maps
and head logits; exact for Otsu thresholds, masks (on the same rows),
packed bits, kept detections, assignments and AP. The JAX references run
jitted: op-by-op dispatch compiles every operation on its first use, which
would take most of this file's time.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.harness import detr_segm as jsegm
from transformer_mm_explainability_tpu.models import detr_segm_heads as jheads
from transformer_mm_explainability_tpu.models import matcher as jmatcher
from transformer_mm_explainability_tpu.models import resnet as jresnet
from transformer_mm_explainability_tpu.ops import otsu as jotsu
from transformer_mm_explainability_tpu.utils import box_ops as jbox
from transformer_mm_explainability_tpu_torch.harness import detr_segm as tsegm
from transformer_mm_explainability_tpu_torch.models import (
    detr_segm_heads as theads)
from transformer_mm_explainability_tpu_torch.models import matcher as tmatcher
from transformer_mm_explainability_tpu_torch.models import resnet as tresnet
from transformer_mm_explainability_tpu_torch.ops import otsu as totsu
from transformer_mm_explainability_tpu_torch.utils import box_ops as tbox
from transformer_mm_explainability_tpu_torch.utils import convert as tconvert

from test_torch_detr import TCFG, image_and_valid

TOL = dict(rtol=1e-4, atol=1e-5)


def rand_boxes(n, seed=0):
    rng = np.random.RandomState(seed)
    cxcy = rng.rand(n, 2) * 0.8 + 0.1
    wh = rng.rand(n, 2) * 0.2 + 0.05
    return np.concatenate([cxcy, wh], 1).astype(np.float32)


@pytest.mark.parametrize("fn", ["box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh",
                                "box_area", "box_iou", "generalized_box_iou",
                                "masks_to_boxes"])
def test_box_ops_equal_jax(fn):
    a = tbox.box_cxcywh_to_xyxy(torch.tensor(rand_boxes(5, 1))).numpy()
    b = tbox.box_cxcywh_to_xyxy(torch.tensor(rand_boxes(4, 2))).numpy()
    if fn == "masks_to_boxes":
        m = (np.random.RandomState(3).rand(4, 9, 11) > 0.8).astype(np.uint8)
        m[2] = 0                                         # an empty mask
        args = (m,)
    elif fn in ("box_iou", "generalized_box_iou"):
        args = (a, b)
    else:
        args = (a,)
    got = getattr(tbox, fn)(*map(torch.tensor, args))
    want = jax.jit(getattr(jbox, fn))(*map(jnp.asarray, args))
    got, want = (got, want) if fn != "box_iou" else (got[0], want[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def otsu_rows():
    """[K, 25, 34] rows (the protocol's feature grid): normal, bimodal,
    heavy-tailed, a constant row and a row with a single hot token."""
    rng = np.random.RandomState(9)
    rows = [rng.randn(25, 34), np.concatenate([rng.normal(50, 5, 425),
                                               rng.normal(200, 5, 425)])
            .reshape(25, 34), rng.standard_cauchy((25, 34)),
            np.full((25, 34), 0.3), np.zeros((25, 34))]
    rows[4][3, 7] = 1.0
    return np.stack(rows).astype(np.float32)


def test_otsu_equals_jax_exactly():
    rows = otsu_rows()
    u8 = (rows.reshape(5, -1) * 40 + 128).clip(0, 255).astype(np.uint8)
    t = totsu.otsu_threshold(torch.tensor(u8)).numpy()
    np.testing.assert_array_equal(
        t, np.asarray(jax.jit(jax.vmap(jotsu.otsu_threshold))(u8)))
    got = totsu.otsu_binarize(torch.tensor(rows)).numpy()
    want = np.asarray(jax.jit(jax.vmap(jotsu.otsu_binarize))(rows))
    np.testing.assert_array_equal(got, want)
    assert 0.4 < got[1].mean() < 0.6


@pytest.mark.parametrize("feat_hw,out_hw", [((2, 3), (64, 96)),
                                            ((25, 34), (800, 1088)),
                                            ((3, 4), (70, 100))])
def test_masks_from_relevancy_equal_jax_on_the_same_rows(feat_hw, out_hw):
    rows = np.random.RandomState(4).randn(5, feat_hw[0] * feat_hw[1])
    rows = rows.astype(np.float32)
    got = tsegm.masks_from_relevancy(torch.tensor(rows), feat_hw,
                                     out_hw).numpy()
    want = np.asarray(jsegm._masks_jit(jnp.asarray(rows), feat_hw, out_hw))
    assert got.shape == (5,) + out_hw
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("W", [96, 101, 1088])
def test_pack_mask_bits_round_trip_and_equal_jax(W):
    m = (np.random.RandomState(W).rand(5, 7, W) > 0.5).astype(np.float32)
    packed = tsegm.pack_mask_bits(torch.tensor(m)).numpy()
    np.testing.assert_array_equal(
        packed, np.asarray(jax.jit(jsegm.pack_mask_bits)(m)))
    np.testing.assert_array_equal(tsegm.unpack_mask_bits(packed, W), m)


def test_keep_detections_equal_jax():
    rng = np.random.RandomState(5)
    logits = rng.randn(12, 8).astype(np.float32)
    logits[3, 1] = logits[7, 1] = 6.0            # a tie above threshold
    logits[9, 2] = 5.0
    for thr, keep in ((0.5, 4), (0.0, 5), (0.0, 20), (0.99, 3)):
        got = tsegm.keep_detections(logits, thr, keep)
        want = jsegm.keep_detections(logits, thr, keep)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_feature_grid_is_ceil_division():
    """``explain_image``'s grid is ceil(side / 32), which is the grid the
    ResNet makes for a side that is no multiple of 32 (floor would give
    (2, 3) here), in the port and in the JAX package."""
    cfg = dataclasses.replace(TCFG, backbone_stages=(1, 1, 1, 1))
    assert tsegm.feature_hw((70, 100), cfg) == (3, 4)
    assert tsegm.feature_hw((64, 96), cfg) == (2, 3)
    params = tresnet.init_params(0, (1, 1, 1, 1), device="cpu")
    with torch.no_grad():
        feats = tresnet.forward(params, torch.zeros(1, 70, 100, 3))
    assert feats.shape[1:3] == (3, 4)
    jp = jax.eval_shape(lambda: jresnet.init_params(jax.random.PRNGKey(0),
                                                    stages=(1, 1, 1, 1)))
    jfeats = jax.eval_shape(lambda p: jresnet.forward(p, jnp.zeros(
        (1, 70, 100, 3))), jp)
    assert jfeats.shape[1:3] == (3, 4)


@pytest.fixture(scope="module")
def tparams():
    from test_torch_detr import detr_numpy_params, JCFG

    return tconvert.detr_from_jax_numpy(detr_numpy_params(JCFG), TCFG,
                                        device="cpu")


def test_explain_image_buckets_and_chunks(tparams):
    """Exactly the kept queries are explained, with no bucket padding (all
    6 kept of max_detections 8 → 6 masks; none kept → none); K = 5 in
    passes of 2 (the last one of 1 query) equals one pass of 5: every
    output, masks exactly."""
    img, valid = image_and_valid()
    img, valid = torch.tensor(img), torch.tensor(valid)
    base = tsegm.SegmConfig(confidence_threshold=0.0, max_detections=8)
    out = tsegm.explain_image(tparams, img, TCFG, base, pad_valid=valid)
    assert out["masks"].shape == (6, 64, 96) and len(out["query_idx"]) == 6
    none = tsegm.explain_image(
        tparams, img, TCFG, dataclasses.replace(base,
                                                confidence_threshold=1.0),
        pad_valid=valid, pack_masks=True)
    assert none["masks_packed"].shape == (0, 64, 12)
    assert none["query_idx"].shape == none["scores"].shape == (0,)
    one = tsegm.SegmConfig(confidence_threshold=0.0, max_detections=5,
                           max_queries_per_pass=32)
    chunked = dataclasses.replace(one, max_queries_per_pass=2)
    a = tsegm.explain_image(tparams, img, TCFG, one, pad_valid=valid)
    b = tsegm.explain_image(tparams, img, TCFG, chunked, pad_valid=valid)
    for k in ("query_idx", "classes", "scores", "boxes", "masks"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["masks"].shape == (5, 64, 96) and a["masks"].any()
    packed = tsegm.explain_image(tparams, img, TCFG, chunked,
                                 pad_valid=valid, pack_masks=True)
    assert packed["mask_hw"] == (64, 96)
    np.testing.assert_array_equal(
        tsegm.unpack_mask_bits(packed["masks_packed"], 96), a["masks"])


def test_mask_iou_and_segm_map_equal_jax():
    rng = np.random.RandomState(6)
    pred = (rng.rand(6, 12, 12) > 0.5).astype(np.float32)
    gt = (rng.rand(4, 12, 12) > 0.5).astype(np.float32)
    iou = tsegm.mask_iou(pred, gt)
    np.testing.assert_array_equal(iou, jsegm.mask_iou(pred, gt))
    dets = [{"scores": rng.rand(6), "classes": rng.randint(0, 3, 6),
             "iou": iou, "gt_classes": np.asarray([0, 1, 1, 2])},
            {"scores": rng.rand(6), "classes": rng.randint(0, 3, 6),
             "iou": iou[::-1], "gt_classes": np.asarray([2, 2, 0, 1])}]
    assert tsegm.segm_map(dets) == jsegm.segm_map(dets)
    thr = np.asarray([0.3, 0.5])
    assert tsegm.segm_map(dets, thr) == jsegm.segm_map(dets, thr)


def matcher_inputs(seed=6, B=2, Q=7, C=4, M=3):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, Q, C + 1).astype(np.float32)
    boxes = np.stack([rand_boxes(Q, seed + b) for b in range(B)])
    labels = rng.randint(0, C, (B, M))
    tgt = np.stack([rand_boxes(M, seed + 10 + b) for b in range(B)])
    return logits, boxes, labels, tgt


def test_matcher_costs_and_assignment_equal_jax():
    """Costs against the JAX ``cost_matrix`` (batched as its ``match``
    batches it), assignments against its ``hungarian`` on those costs
    (the body of its ``match``), identity predictions matched 1:1."""
    logits, boxes, labels, tgt = matcher_inputs()
    want = np.asarray(jax.jit(jax.vmap(jmatcher.cost_matrix))(
        logits, boxes, labels, tgt))
    for b in range(2):
        got = tmatcher.cost_matrix(*(torch.tensor(x[b]) for x in
                                     (logits, boxes, labels, tgt))).numpy()
        np.testing.assert_allclose(got, want[b], **TOL)
    for n_valid in ([3, 2], [0, 1]):
        a = tmatcher.match(*map(torch.tensor, (logits, boxes, labels, tgt)),
                           np.asarray(n_valid))
        b = np.stack([jmatcher.hungarian(want[i], n_valid[i])
                      for i in range(2)])
        np.testing.assert_array_equal(a, b)
        assert (a[0] == -1).sum() == 3 - n_valid[0]
    chosen = [5, 1, 3]
    perfect_logits = np.full((1, 7, 5), -5.0, np.float32)
    perfect_boxes = boxes[:1].copy()
    for t, q in enumerate(chosen):
        perfect_logits[0, q, labels[0, t]] = 5.0
        perfect_boxes[0, q] = tgt[0, t]
    a = tmatcher.match(torch.tensor(perfect_logits),
                       torch.tensor(perfect_boxes),
                       torch.tensor(labels[:1]), torch.tensor(tgt[:1]),
                       np.asarray([3]))
    np.testing.assert_array_equal(a[0], chosen)


def test_criterion_losses_and_post_process_equal_jax():
    logits, boxes, labels, tgt = matcher_inputs(seed=7)
    assignment = np.asarray([[4, 0, -1], [2, -1, 6]])
    got = tmatcher.set_criterion_losses(
        *map(torch.tensor, (logits, boxes, labels, tgt, assignment)))
    want = jax.jit(jmatcher.set_criterion_losses)(
        *map(jnp.asarray, (logits, boxes, labels, tgt, assignment)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **TOL,
                                   err_msg=k)
    sizes = np.asarray([[480, 640], [100, 200]])
    got = tmatcher.post_process(torch.tensor(logits), torch.tensor(boxes),
                                torch.tensor(sizes))
    want = jax.jit(jmatcher.post_process)(logits, boxes, sizes)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)


def test_segm_heads_equal_jax():
    """MHAttentionMap (with a pad mask), GroupNorm, the mask head with one
    FPN skip through an adapter and one without, PostProcessSegm."""
    rng = np.random.RandomState(2)
    f = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)
    B, Qn, D, H, W, heads = 2, 3, 32, 6, 8, 4
    q, feat = f(B, Qn, D), f(B, H, W, D)
    valid = np.ones((B, H, W), np.float32)
    valid[1, 4:] = 0
    p_attn = {"q_w": f(D, D, sc=0.1), "q_b": f(D, sc=0.1),
              "k_w": f(D, D, sc=0.1), "k_b": f(D, sc=0.1)}
    conv = lambda cin, cout: {"w": f(3, 3, cin, cout, sc=0.1),
                              "b": f(cout, sc=0.1),
                              "gn_scale": 1 + f(cout, sc=0.1),
                              "gn_bias": f(cout, sc=0.1)}
    p_head = {"convs": [conv(D + heads, 16), conv(16, 8), conv(8, 8)],
              "adapters": [{"w": f(1, 1, 12, 16, sc=0.1), "b": f(16)}, None],
              "out": {"w": f(3, 3, 8, 1, sc=0.1), "b": f(1)}}
    fpn = [f(B, 12, 16, 12), f(B, 24, 32, 8)]

    jmaps = jax.jit(jheads.mh_attention_map, static_argnums=3)(
        p_attn, q, feat, heads, valid)
    tp_attn = {k: torch.tensor(v) for k, v in p_attn.items()}
    tmaps = theads.mh_attention_map(tp_attn, torch.tensor(q),
                                    torch.tensor(feat), heads,
                                    torch.tensor(valid))
    np.testing.assert_allclose(tmaps.numpy(), np.asarray(jmaps), **TOL)
    np.testing.assert_allclose(
        theads._gn(torch.tensor(feat), 1.5, 0.2, groups=8).numpy(),
        np.asarray(jax.jit(jheads._gn)(feat, 1.5, 0.2)), **TOL)
    # the JAX head takes None adapters as static structure
    jlog = jax.jit(lambda f, m, s: jheads.mask_head(p_head, f, m, s))(
        feat, jmaps, fpn)
    tlog = theads.mask_head(tconvert._to_torch(p_head, "cpu", hwio=True),
                            torch.tensor(feat), tmaps,
                            [torch.tensor(x) for x in fpn])
    assert tlog.shape == (B * Qn, 24, 32, 1)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    # the masks of the same logits, exactly
    np.testing.assert_array_equal(
        theads.post_process_segm(torch.tensor(np.asarray(jlog)),
                                 (50, 70)).numpy(),
        np.asarray(jax.jit(jheads.post_process_segm, static_argnums=1)(
            jlog, (50, 70))))
