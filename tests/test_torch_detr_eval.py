"""The port's DETR evaluation path against the JAX package: the COCO data
layer (RLE and polygon decoders, ``CocoDetection``, ``eval_ground_truths``,
``rgb2id``, ``CocoPanoptic``), the COCOeval-faithful evaluator, the
panoptic post-processing and PQ, ``prepare_image``, the host nearest
resize, ``evaluate`` on the JAX test's mini-COCO
(tests/test_detr_eval.py:23-43) and ``cli detr-eval --device cpu``.

Stated tolerances: exact for the decoders, datasets, COCO stats, masks,
panoptic id maps and PQ; ``prepare_image`` within 1e-4 of JAX's and 1e-6
of a float64 resize (see its test).
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from transformer_mm_explainability_tpu.data import coco as jcoco
from transformer_mm_explainability_tpu.harness import coco_eval as jce
from transformer_mm_explainability_tpu.harness import detr_eval as jeval
from transformer_mm_explainability_tpu.harness import detr_segm as jsegm
from transformer_mm_explainability_tpu.harness import panoptic as jpano
from transformer_mm_explainability_tpu_torch import cli
from transformer_mm_explainability_tpu_torch.data import coco as tcoco
from transformer_mm_explainability_tpu_torch.harness import coco_eval as tce
from transformer_mm_explainability_tpu_torch.harness import detr_eval as teval
from transformer_mm_explainability_tpu_torch.harness import detr_segm as tsegm
from transformer_mm_explainability_tpu_torch.harness import panoptic as tpano
from transformer_mm_explainability_tpu_torch.ops import image as timage
from transformer_mm_explainability_tpu_torch.utils import convert as tconvert

# the tiny model of test_torch_detr (2 + 2 layers): with one decoder layer,
# as in the JAX eval test, every "ours" row is 0 (each non-target query's
# Ê row is 0, its eq. 8+9 division NaN, and the NaN guard wipes the whole
# rule-10 addition, tests/test_detr.py:338-348), and so is every mask
from test_torch_detr import JCFG, TCFG, detr_numpy_params


def encode_rle(counts):
    """COCO's rleToString: runs → the compressed counts string."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            out.append(chr((c | 0x20 if more else c) + 48))
    return "".join(out)


def runs_of(mask):
    """Column-major runs of a binary mask, starting with zeros."""
    flat = mask.T.reshape(-1)
    runs, val, n = [], 0, 0
    for v in flat:
        if v == val:
            n += 1
        else:
            runs.append(n)
            val, n = v, 1
    return runs + [n]


def write_mini_coco(d, extra=False):
    """The JAX eval test's mini-COCO (two 96×128 images, one polygon
    each); ``extra`` adds a compressed-RLE crowd and an uncompressed-RLE
    annotation."""
    rng = np.random.RandomState(0)
    images, annotations = [], []
    for i in range(2):
        h, w = 96, 128
        arr = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(d / f"img{i}.jpg")
        images.append({"id": i, "height": h, "width": w,
                       "file_name": f"img{i}.jpg"})
        annotations.append({
            "id": 100 + i, "image_id": i, "category_id": 1 + i % 2,
            "iscrowd": 0, "bbox": [10, 10, 40, 30],
            "segmentation": [[10, 10, 50, 10, 50, 40, 10, 40]],
        })
    if extra:
        blob = np.zeros((96, 128), np.uint8)
        blob[40:70, 60:110] = 1
        blob[50:55, 70:80] = 0
        annotations.append({
            "id": 200, "image_id": 0, "category_id": 2, "iscrowd": 1,
            "bbox": [60, 40, 50, 30], "area": 1450.0,
            "segmentation": {"size": [96, 128],
                             "counts": encode_rle(runs_of(blob))}})
        annotations.append({
            "id": 201, "image_id": 1, "category_id": 1, "iscrowd": 0,
            "bbox": [0, 0, 5, 5],
            "segmentation": {"size": [96, 128],
                             "counts": runs_of(blob[::-1].copy())}})
    data = {"images": images, "annotations": annotations,
            "categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]}
    path = d / "instances.json"
    path.write_text(json.dumps(data))
    return path


@pytest.fixture(scope="module")
def mini_coco(tmp_path_factory):
    d = tmp_path_factory.mktemp("coco")
    return d, write_mini_coco(d)


@pytest.mark.parametrize("kind", ["compressed", "uncompressed", "polygon"])
def test_mask_decoders_equal_jax(kind):
    rng = np.random.RandomState(3)
    mask = (rng.rand(23, 31) > 0.6).astype(np.uint8)
    mask[:, 0] = 1                                     # runs from 0
    if kind == "compressed":
        counts = encode_rle(runs_of(mask))
        got = tcoco.decode_compressed_rle(counts, 23, 31)
        want = jcoco.decode_compressed_rle(counts, 23, 31)
        np.testing.assert_array_equal(got, mask)
    elif kind == "uncompressed":
        got = tcoco.decode_uncompressed_rle(runs_of(mask), 23, 31)
        want = jcoco.decode_uncompressed_rle(runs_of(mask), 23, 31)
        np.testing.assert_array_equal(got, mask)
    else:
        polys = [[2.5, 3, 20, 4.5, 18, 19, 4, 15.5], [22, 2, 29, 2, 25, 9],
                 [1, 1, 2, 2]]                          # a degenerate one
        got = tcoco.polygons_to_mask(polys, 23, 31)
        want = jcoco.polygons_to_mask(polys, 23, 31)
        assert got.sum() > 100
    np.testing.assert_array_equal(got, want)


def test_coco_datasets_equal_jax(tmp_path):
    path = write_mini_coco(tmp_path, extra=True)
    t = tcoco.CocoDetection(str(path), image_root=str(tmp_path))
    j = jcoco.CocoDetection(str(path), image_root=str(tmp_path))
    assert t.image_ids == j.image_ids and len(t) == 2
    for i in t.image_ids:
        np.testing.assert_array_equal(t.load_image(i), j.load_image(i))
        a, b = t.target(i), j.target(i)
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        ga, gb = (tcoco.eval_ground_truths(t, i),
                  jcoco.eval_ground_truths(j, i))
        assert [x.keys() for x in ga] == [x.keys() for x in gb]
        for x, y in zip(ga, gb):
            for k in y:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    assert sum(g["iscrowd"] for g in tcoco.eval_ground_truths(t, 0)) == 1

    # panoptic: an id-map PNG of three segments
    ids = np.zeros((20, 30), np.int64)
    ids[2:9, 3:12], ids[10:18, 5:25], ids[0:4, 20:30] = 7, 300, 65536 + 2
    rgb = np.stack([ids % 256, ids // 256 % 256, ids // 65536],
                   -1).astype(np.uint8)
    np.testing.assert_array_equal(tcoco.rgb2id(rgb), ids)
    (tmp_path / "pano").mkdir()
    Image.fromarray(rgb).save(tmp_path / "pano" / "p0.png")
    Image.fromarray(rgb).save(tmp_path / "p0.jpg")
    segs = [{"id": 7, "category_id": 1, "iscrowd": 0, "area": 63},
            {"id": 300, "category_id": 3, "iscrowd": 1, "area": 160},
            {"id": 65538, "category_id": 2, "iscrowd": 0, "area": 40}]
    ann = {"images": [{"id": 5, "file_name": "p0.jpg", "height": 20,
                       "width": 30}],
           "annotations": [{"image_id": 5, "file_name": "p0.png",
                            "segments_info": segs}]}
    (tmp_path / "pano.json").write_text(json.dumps(ann))
    args = (str(tmp_path), str(tmp_path / "pano"), str(tmp_path / "pano.json"))
    a, b = tcoco.CocoPanoptic(*args).target(0), \
        jcoco.CocoPanoptic(*args).target(0)
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def coco_eval_inputs(iou_type, seed=0):
    """Three images of synthetic ground truth (a crowd, small, medium and
    large objects, two categories) and scored detections around them."""
    rng = np.random.RandomState(seed)
    images = []
    for _ in range(3):
        gts, dts = [], []
        for g in range(4):
            y0, x0 = rng.randint(0, 40, 2)
            h, w = rng.randint(4, 60, 2)
            gts.append({"category_id": 1 + g % 2, "iscrowd": int(g == 3),
                        "bbox": [float(x0), float(y0), float(w), float(h)]})
        for _ in range(6):
            src = gts[rng.randint(0, 4)]["bbox"]
            jit = rng.randint(-6, 7, 4)
            b = [max(0.0, src[0] + jit[0]), max(0.0, src[1] + jit[1]),
                 max(2.0, src[2] + jit[2]), max(2.0, src[3] + jit[3])]
            dts.append({"category_id": 1 + rng.randint(0, 2),
                        "score": float(rng.rand()), "bbox": b})
        if iou_type == "segm":
            for a in gts + dts:
                m = np.zeros((100, 100), np.uint8)
                x, y, w, h = (int(v) for v in a["bbox"])
                m[y:y + h, x:x + w] = 1
                a["mask"] = m
        images.append((gts, dts))
    return images


@pytest.mark.parametrize("iou_type", ["segm", "bbox"])
def test_coco_eval_stats_equal_jax(iou_type):
    stats = []
    for mod in (tce, jce):
        ev = mod.CocoEval(iou_type=iou_type)
        for i, (g, d) in enumerate(coco_eval_inputs(iou_type)):
            ev.add_image(g, d, image_id=i)
        ev.accumulate()
        stats.append(ev.summarize())
    assert len(stats[0]) == 12 and stats[0] == stats[1]
    assert 0.0 < stats[0]["AP50"] < 1.0


def panoptic_outputs(seed=0, Q=10, C=6, FH=24, FW=32):
    rng = np.random.RandomState(seed)
    logits = np.full((Q, C + 1), -3.0, np.float32)
    confident = [(0, 1), (2, 3), (4, 3), (6, 2), (8, 5)]
    for q, c in confident:
        logits[q, c] = 6.0
    logits[1, C] = 6.0
    logits[3, 4] = 0.5
    masks = rng.randn(Q, FH, FW).astype(np.float32) * 2.0
    for i, (q, c) in enumerate(confident):
        masks[q] = -4.0
        y = (i * FH) // len(confident)
        masks[q, y:y + FH // len(confident) + 1,
              (i * 3) % FW:(i * 3) % FW + 14] = 5.0
    return logits, masks


@pytest.mark.parametrize("target", [None, (31, 49)])
def test_panoptic_and_pq_equal_jax(target):
    is_thing = {c: c in (1, 2, 5) for c in range(7)}
    logits, masks = panoptic_outputs()
    results = [mod.post_process_panoptic(logits, masks, (48, 64), is_thing,
                                         target_size=target)
               for mod in (tpano, jpano)]
    np.testing.assert_array_equal(results[0]["id_map"], results[1]["id_map"])
    assert results[0]["segments_info"] == results[1]["segments_info"]
    np.testing.assert_array_equal(results[0]["scores"], results[1]["scores"])
    pred = tpano.to_pq_format(results[0])
    ids, segs = jpano.to_pq_format(results[1])
    np.testing.assert_array_equal(pred[0], ids)
    assert pred[1] == segs
    # ground truth: the prediction with one segment moved and one crowd
    gt_ids = pred[0].copy()
    gt_ids[:5] = 0
    gt_segs = [dict(s, iscrowd=int(i == 1)) for i, s in enumerate(pred[1])]
    cats = {c: {"isthing": is_thing[c]} for c in range(7)}
    got = tpano.pq_compute([(gt_ids, gt_segs)], [pred], cats)
    want = jpano.pq_compute([(gt_ids, gt_segs)], [pred], cats)
    assert got == want and got["All"]["n"] > 0


def f64_linear_resize(x, out_hw):
    """``jax.image.resize(x, out_hw + (C,), "linear")`` in float64: JAX's
    own weight matrices (``compute_weight_mat``), products in float64."""
    import jax._src.image.scale as jscale

    kernel = jscale._kernels[jscale.ResizeMethod.LINEAR]
    (h, w), (oh, ow) = x.shape[:2], out_hw
    wh = np.asarray(jscale.compute_weight_mat(h, oh, oh / h, 0.0, kernel,
                                              True), np.float64)
    ww = np.asarray(jscale.compute_weight_mat(w, ow, ow / w, 0.0, kernel,
                                              True), np.float64)
    y = np.tensordot(wh, x.astype(np.float64), axes=(0, 0))     # [oh, w, C]
    return np.tensordot(ww, y, axes=(0, 1)).transpose(1, 0, 2)  # [oh, ow, C]


@pytest.mark.parametrize("raw_hw,shortest,longest", [
    ((96, 128), 64, 1333), ((60, 200), 64, 128), ((480, 640), 800, 1333)])
def test_prepare_image_equals_jax(raw_hw, shortest, longest):
    """Down- and upscaling, the longest-side cap (60×200 → 38×128), the
    /32 padding. The
    resized pixels lie within 1e-6 of JAX's linear resize computed in
    float64 (pixel range 0-1); JAX's own float32 resize lies up to 4.3e-6
    from that (its einsum's rounding, measured at 100×140 → 64×90), so the
    normalised images (÷ 0.224) are held to each other within 1e-4."""
    raw = (np.random.RandomState(1).rand(*raw_hw, 3) * 255).astype(np.uint8)
    img, valid = teval.prepare_image(raw, shortest, longest, device="cpu")
    j_img, j_valid = jax.jit(jeval.prepare_image, static_argnums=(1, 2))(
        raw, shortest, longest)
    assert img.shape == j_img.shape and img.shape[0] % 32 == 0
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    np.testing.assert_allclose(img.numpy(), np.asarray(j_img), rtol=0,
                               atol=1e-4)
    h, w = (int(v.sum()) for v in (valid[:, 0], valid[0]))
    std = np.asarray(timage.IMAGENET_STD, np.float32)
    mean = np.asarray(timage.IMAGENET_MEAN, np.float32)
    resized = img[:h, :w].numpy() * std + mean
    want = f64_linear_resize(raw.astype(np.float32) / 255.0, (h, w))
    np.testing.assert_allclose(resized, want, rtol=0, atol=1e-6)


def test_nearest_index_is_floor_of_half_pixel_centres():
    """The host mask resize reads source floor((i + 0.5)·s), which is
    ``jax.image.resize``'s 'nearest'; np.round(x − 0.5) would take row 0
    for output row 1 here (an exact tie, 1.0, rounded to even)."""
    got = teval.nearest_index(6, 4)
    np.testing.assert_array_equal(got, [0, 1, 1, 2, 3, 3])
    ramp = jnp.arange(4.0)
    np.testing.assert_array_equal(
        got, np.asarray(jax.image.resize(ramp, (6,), "nearest")))
    assert np.round((1 + 0.5) * 4 / 6 - 0.5) == 0
    for n_out, n_in in ((96, 64), (800, 1333), (7, 3)):
        np.testing.assert_array_equal(
            teval.nearest_index(n_out, n_in),
            np.asarray(jax.image.resize(jnp.arange(float(n_in)), (n_out,),
                                        "nearest")).astype(np.int64))


def test_evaluate_equals_jax(mini_coco):
    """``evaluate`` on the mini-COCO: the same 12 stats, and the first
    image's explanation (detections, masks exactly) as the JAX package's."""
    d, path = mini_coco
    jp = detr_numpy_params(JCFG, seed=2)
    tp = tconvert.detr_from_jax_numpy(jp, TCFG, device="cpu")
    segm_cfg = dict(confidence_threshold=0.0, max_detections=4)
    quiet = lambda *a: None
    got = teval.evaluate(tp, tcoco.CocoDetection(str(path), str(d)), TCFG,
                         tsegm.SegmConfig(**segm_cfg), max_images=2,
                         shortest=64, printer=quiet)
    want = jeval.evaluate(jp, jcoco.CocoDetection(str(path), str(d)), JCFG,
                          jsegm.SegmConfig(**segm_cfg), max_images=2,
                          shortest=64, printer=quiet)
    assert len(got) == 12 and got == want

    raw = tcoco.CocoDetection(str(path), str(d)).load_image(0)
    img, valid = teval.prepare_image(raw, 64, device="cpu")
    a = tsegm.explain_image(tp, img, TCFG, tsegm.SegmConfig(**segm_cfg),
                            pad_valid=valid)
    b = jsegm.explain_image(jp, jnp.asarray(img.numpy()), JCFG,
                            jsegm.SegmConfig(**segm_cfg),
                            pad_valid=jnp.asarray(valid.numpy()),
                            pack_masks=True)
    b["masks"] = jsegm.unpack_mask_bits(b["masks_packed"], 96)
    kept = b["valid"]                # the JAX package pads to a K bucket
    assert len(a["query_idx"]) == kept.sum() == 4
    for k in ("query_idx", "classes", "masks"):
        np.testing.assert_array_equal(a[k], b[k][kept], err_msg=k)
    np.testing.assert_allclose(a["scores"], b["scores"][kept], rtol=1e-4)
    assert a["masks"].any()


def run_cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().strip().splitlines()


def test_cli_detr_eval_cpu(mini_coco, tmp_path):
    """Without --coco-path: the hint, rc 0. With it: DETR-R50 (random
    weights) on the mini-COCO, the 12 stats as the last line. An LRP
    method (which exited 2 before the LRP engine was ported) explains
    queries: a release checkpoint of random weights whose class-1 bias is
    raised keeps all 100 queries of an image, explained in passes of 32."""
    d, path = mini_coco
    rc, lines = run_cli(["detr-eval", "--device", "cpu"])
    assert rc == 0 and "--coco-path" in lines[-1]
    rc, lines = run_cli(["detr-eval", "--device", "cpu", "--coco-path",
                         str(d), "--annotations", str(path), "--shortest",
                         "64", "--max-images", "1"])
    assert rc == 0
    stats = json.loads(lines[-1])
    assert len(stats) == 12 and all(-1.0 <= v <= 1.0 for v in stats.values())
    from transformer_mm_explainability_tpu_torch.models import detr

    params = detr.init_params(0, detr.DETR_R50, "cpu")
    sd = tconvert.detr_to_state_dict(params)
    sd["class_embed.bias"][1] += 20.0
    torch.save({"model": sd}, tmp_path / "detr.pth")
    calls = []
    generate = teval.detr_segm.expl_detr.generate

    def counted(method, *args, **kw):
        rows = generate(method, *args, **kw)
        calls.append((method, rows.shape))
        return rows

    import unittest.mock
    with unittest.mock.patch.object(teval.detr_segm.expl_detr, "generate",
                                    counted):
        rc, lines = run_cli(["detr-eval", "--device", "cpu", "--coco-path",
                             str(d), "--annotations", str(path),
                             "--shortest", "64", "--max-images", "1",
                             "--method", "partial_lrp", "--checkpoint",
                             str(tmp_path / "detr.pth")])
    assert rc == 0
    stats = json.loads(lines[-1])
    assert len(stats) == 12 and all(-1.0 <= v <= 1.0 for v in stats.values())
    assert [m for m, _ in calls] == ["partial_lrp"] * 4
    assert sum(shape[0] for _, shape in calls) == 100


def test_cli_detr_eval_turns_tf32_off(mini_coco):
    """The port computes in fp32: ``cli detr-eval`` (through
    ``resolve_device``) turns TF32 off in cuDNN and cuBLAS, whose
    PyTorch defaults would let the backbone's convolutions on a card run
    in TF32."""
    d, path = mini_coco
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        rc, _ = run_cli(["detr-eval", "--device", "cpu", "--coco-path",
                         str(d), "--annotations", str(path), "--shortest",
                         "64", "--max-images", "1"])
        assert rc == 0
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
