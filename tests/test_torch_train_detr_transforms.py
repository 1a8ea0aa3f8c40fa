"""The port's DETR augmentation (``data/detr_transforms``) against the
JAX package's: every function and ``Random*`` transform on the same image,
target and RandomState, and ``make_coco_transforms`` for several seeds:
the same decisions (sizes, kept boxes, labels, masks), boxes and areas
within 1e-5, images within 1e-5 of max(1, max|image|) (the resize is
``ops/image.resize`` on the port's side, ``jax.image.resize`` on JAX's).
"""

import numpy as np
import pytest

from transformer_mm_explainability_tpu.data import detr_transforms as JT
from transformer_mm_explainability_tpu_torch.data import detr_transforms as TT


def _target(h=60, w=100):
    t = {"boxes": np.array([[10.0, 10.0, 30.0, 40.0],
                            [50.0, 5.0, 90.0, 25.0],
                            [2.0, 44.0, 97.0, 58.0]], np.float32),
         "labels": np.array([1, 2, 3]),
         "area": np.array([600.0, 800.0, 1330.0], np.float32),
         "iscrowd": np.array([0, 0, 1]),
         "masks": np.zeros((3, h, w), bool)}
    t["masks"][0, 10:40, 10:30] = True
    t["masks"][1, 5:25, 50:90] = True
    t["masks"][2, 44:58, 2:97] = True
    return t


def _image(h=60, w=100, seed=0):
    return np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)


def _assert_same(got, want):
    """Images within 1e-5 of max(1, max|image|) (an 8-bit image resized
    before ``ToTensor`` stays on the 0-255 scale, in both packages)."""
    (gi, gt), (wi, wt) = got, want
    assert gi.shape == wi.shape
    np.testing.assert_allclose(gi, wi, rtol=0, atol=1e-5 * max(
        1.0, float(np.abs(wi).max())))
    if wt is None:
        assert gt is None
        return
    assert set(gt) == set(wt)
    for k in wt:
        g, w = np.asarray(gt[k]), np.asarray(wt[k])
        assert g.shape == w.shape, k
        if k in ("boxes", "area"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("region", [(0, 0, 45, 45), (5, 20, 50, 70),
                                    (30, 0, 30, 100)])
def test_crop_equals_jax(region):
    _assert_same(TT.crop(_image(), _target(), region),
                 JT.crop(_image(), _target(), region))
    _assert_same(TT.crop(_image(), None, region),
                 JT.crop(_image(), None, region))


def test_hflip_and_pad_equal_jax():
    _assert_same(TT.hflip(_image(), _target()), JT.hflip(_image(), _target()))
    _assert_same(TT.pad(_image(), _target(), (7, 3)),
                 JT.pad(_image(), _target(), (7, 3)))


@pytest.mark.parametrize("size,max_size", [(40, None), (90, None),
                                           (80, 120), ((50, 30), None)])
def test_resize_equals_jax(size, max_size):
    """Down and up, by the shortest edge, capped, and to an exact (w, h)."""
    _assert_same(TT.resize(_image(), _target(), size, max_size),
                 JT.resize(_image(), _target(), size, max_size))
    assert TT.get_size_with_aspect_ratio((60, 100), 800, 1333) == \
        JT.get_size_with_aspect_ratio((60, 100), 800, 1333)


def test_normalize_totensor_and_centercrop_equal_jax():
    img = (np.random.RandomState(2).rand(60, 100, 3) * 255).astype(np.uint8)
    _assert_same(TT.ToTensor()(img, _target()), JT.ToTensor()(img, _target()))
    _assert_same(TT.Normalize()(_image(), _target()),
                 JT.Normalize()(_image(), _target()))
    _assert_same(TT.CenterCrop((40, 50))(_image(), _target()),
                 JT.CenterCrop((40, 50))(_image(), _target()))


def _random_pairs(seed):
    """(port, JAX) instances of each Random* transform on RandomStates of
    one seed."""
    a, b = np.random.RandomState(seed), np.random.RandomState(seed)
    return [
        (TT.RandomCrop((40, 70), rng=a), JT.RandomCrop((40, 70), rng=b)),
        (TT.RandomSizeCrop(20, 50, rng=a), JT.RandomSizeCrop(20, 50, rng=b)),
        (TT.RandomHorizontalFlip(rng=a), JT.RandomHorizontalFlip(rng=b)),
        (TT.RandomResize([30, 50, 70], max_size=150, rng=a),
         JT.RandomResize([30, 50, 70], max_size=150, rng=b)),
        (TT.RandomPad(9, rng=a), JT.RandomPad(9, rng=b)),
        (TT.RandomSelect(TT.RandomHorizontalFlip(1.0, rng=a),
                         TT.RandomPad(5, rng=a), rng=a),
         JT.RandomSelect(JT.RandomHorizontalFlip(1.0, rng=b),
                         JT.RandomPad(5, rng=b), rng=b)),
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_transforms_draw_as_jax(seed):
    for t, j in _random_pairs(seed):
        for _ in range(3):
            _assert_same(t(_image(), _target()), j(_image(), _target()))


@pytest.mark.parametrize("seed,uint8", [(0, False), (3, False), (1, True)])
def test_make_coco_transforms_equals_jax(seed, uint8):
    img = np.random.RandomState(seed).rand(48, 64, 3).astype(np.float32)
    if uint8:
        img = (img * 255).astype(np.uint8)
    t, j = TT.make_coco_transforms("train", seed), \
        JT.make_coco_transforms("train", seed)
    for _ in range(2):
        _assert_same(t(img, _target(48, 64)), j(img, _target(48, 64)))
    _assert_same(TT.make_coco_transforms("val")(img, _target(48, 64)),
                 JT.make_coco_transforms("val")(img, _target(48, 64)))
    with pytest.raises(ValueError):
        TT.make_coco_transforms("test")
