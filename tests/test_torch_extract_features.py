"""The port's FRCNN feature extraction (``tools/extract_features``) against
the JAX package's: the same TSV rows for the same detections, the invalid
detections left out, and an extraction whose file both packages' readers
read back."""

import base64

import jax
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.data import vqa as jvqa
from transformer_mm_explainability_tpu.models import frcnn as jfrcnn
from transformer_mm_explainability_tpu.tools import extract_features as JX
from transformer_mm_explainability_tpu_torch.data import vqa as tvqa
from transformer_mm_explainability_tpu_torch.models import frcnn as tfrcnn
from transformer_mm_explainability_tpu_torch.tools import extract_features as X
from transformer_mm_explainability_tpu_torch.utils import convert

TINY = dict(stages=(1, 1, 1, 1), anchor_sizes=(32, 64), aspect_ratios=(1.0,),
            pre_nms_topk=50, post_nms_topk=12, pooler_resolution=4,
            num_classes=9, num_attrs=5, max_detections=6)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs files in
    several worker processes at once, and torch's default of one thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _detections(as_tensor: bool):
    out = {
        "valid": np.array([1, 1, 0], bool),
        "obj_ids": np.array([3, 4, 9]),
        "obj_probs": np.array([0.5, 0.25, 0.1], np.float32),
        "attr_ids": np.array([1, 2, 7]),
        "attr_probs": np.array([0.5, 0.25, 0.1], np.float32),
        "boxes": np.arange(12, dtype=np.float32).reshape(3, 4),
        "roi_features": np.ones((3, 8), np.float32),
    }
    return {k: torch.as_tensor(v) for k, v in out.items()} if as_tensor \
        else out


@pytest.mark.parametrize("as_tensor", [False, True])
def test_encode_row_equals_jax_and_masks_invalid(as_tensor):
    row = X.encode_row("x", 10, 20, _detections(as_tensor))
    assert row == JX.encode_row("x", 10, 20, _detections(False))
    assert row["num_boxes"] == 2
    ids = np.frombuffer(base64.b64decode(row["objects_id"]), np.int64)
    assert ids.tolist() == [3, 4]
    assert X.FIELDNAMES == JX.FIELDNAMES


def test_extract_roundtrip_equals_jax(tmp_path):
    """The JAX weights carried across (``frcnn_from_jax_numpy``): the port's
    TSV equals the JAX tool's row for row, and both readers read it."""
    jcfg = jfrcnn.FrcnnConfig(**TINY)
    tcfg = tfrcnn.FrcnnConfig(**TINY)
    jparams = jfrcnn.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.frcnn_from_jax_numpy(jax.tree.map(np.asarray, jparams),
                                           tcfg, device="cpu")
    rs = np.random.RandomState(0)
    imgs = [(f"img{i}", (rs.rand(48, 64, 3) * 255).astype(np.uint8))
            for i in range(2)]
    ours, theirs = tmp_path / "port.tsv", tmp_path / "jax.tsv"
    assert X.extract_to_tsv(imgs, str(ours), params=tparams, cfg=tcfg,
                            target_shortest=32, device="cpu") == 2
    assert JX.extract_to_tsv(imgs, str(theirs), params=jparams, cfg=jcfg,
                             target_shortest=32) == 2
    rows = tvqa.load_obj_tsv(str(ours))
    jrows = jvqa.load_obj_tsv(str(theirs), use_native=False)
    assert rows and len(rows) == len(jrows) == 2
    for (img_id, rgb), row, jrow in zip(imgs, rows, jrows):
        assert row["img_id"] == img_id == jrow["img_id"]
        assert (row["img_h"], row["img_w"]) == rgb.shape[:2]
        nb = row["num_boxes"]
        assert 0 < nb <= TINY["max_detections"] and nb == jrow["num_boxes"]
        assert row["features"].shape == (nb, 2048)
        assert row["boxes"].shape == (nb, 4)
        # boxes rescaled to the original pixels
        assert float(row["boxes"][:, 2].max()) <= rgb.shape[1] + 1
        assert row["objects_id"].dtype == np.int64
        np.testing.assert_array_equal(row["objects_id"], jrow["objects_id"])
        np.testing.assert_array_equal(row["attrs_id"], jrow["attrs_id"])
        for k in ("boxes", "features", "objects_conf", "attrs_conf"):
            top = max(float(np.abs(jrow[k]).max()), 1.0)
            assert float(np.abs(row[k] - jrow[k]).max()) <= 1e-4 * top, k
    # the JAX reader reads the port's file to the same arrays
    for row, jrow in zip(rows, jvqa.load_obj_tsv(str(ours),
                                                 use_native=False)):
        for k, v in row.items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(jrow[k]))


def test_extract_needs_a_card_when_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        X.extract_to_tsv([], str(tmp_path / "x.tsv"),
                         cfg=tfrcnn.FrcnnConfig(**TINY))
